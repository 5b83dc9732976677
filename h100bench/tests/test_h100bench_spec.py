"""BENCHMARK.json keeps to the benchmark's contract, every piece it names
resolves to its file by name, and a piece added as files and entries alone
is picked up."""

import json
import re
import shutil
import subprocess
import sys

import pytest
from conftest import ROOT

from h100bench import harness

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["h100bench"] and SPEC["command"][1] == "h100bench/run.py"
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_keep_to_the_contract(section):
    names = [e["name"] for e in SPEC[section]]
    assert len(names) == len(set(names))
    for e in SPEC[section]:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e["name"]
        assert NAME.match(e["name"]), e["name"]
        for k in ("why", "layer") + (("source",) if section == "configs" else ()):
            if k in e:
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] and "\t" not in e[k]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        if section in ("end_to_end", "per_layer"):
            allowed = (("host_clock", "device_trace") if section == "end_to_end" else
                       ("device_trace", "program_span", "program_counter", "host_clock"))
            assert e["source"] in allowed
        if section == "end_to_end":
            assert 0 < e["bound"] <= 0.25
        if section == "workloads":
            assert e["chips"] in (1, 4) and NAME.match(e["traffic"])


def test_every_cell_reports_what_it_must():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    used = set()
    for w in SPEC["workloads"]:
        cell = harness.resolve(ROOT, w["name"], SPEC)
        names = [m["name"] for m in cell.end_to_end]
        assert "setup_s" in names and len(names) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in names, (w["name"], m["name"])
        used.add(w["config"])
    assert used == {c["name"] for c in SPEC["configs"]}


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_every_piece_resolves_by_name(workload):
    cell = harness.resolve(ROOT, workload, SPEC)
    for m in cell.end_to_end:
        assert callable(harness.load_module(harness.metric_path("end_to_end", m["name"])).read)
    for m in cell.per_layer:
        assert callable(harness.load_module(harness.metric_path("layer_metrics",
                                                                m["name"])).read)
    assert (harness.HERE / "generators" / f"{cell.mix['generator']}.py").is_file()
    assert (harness.HERE / "systems" / f"{cell.config['system']}.py").is_file()
    assert (harness.HERE / "reference" / f"{cell.config['reference']}.py").is_file()
    assert cell.config["limits"] and cell.config["controls"]
    entry = {c["name"]: c for c in SPEC["configs"]}[cell.config["name"]]
    assert entry["file"].startswith("h100bench/configs/")


#: a generator of another load shape (three dofs a node of a 1-D chain of
#: ``problem.nodes`` nodes), a system that solves 2 x = b, and its reference
GENERATOR_3 = """
import numpy as np
from h100bench.harness import rng_for


def steps(mix, config, seed):
    return [int(i) for i in rng_for(seed, 7).permutation(mix["pool"])]


def warmup(mix, config):
    return -1


def load(mix, config, step):
    n = 3 * config["problem"]["nodes"]
    return rng_for(mix["pool_seed"], step % (1 << 32)).uniform(1.0, 2.0, n)
"""
SYSTEM_HALF = """
from dataclasses import dataclass, field
import numpy as np


@dataclass
class Answer:
    x: np.ndarray
    ok: bool
    counts: dict = field(default_factory=dict)


class System:
    def __init__(self, config, device, overrides=None):
        self.spans, self.timings, self.shapes = {}, {}, set()

    def to_input(self, f):
        self.shapes.add(f.shape)
        return f

    def solve(self, b):
        return Answer(x=b / 2.0, ok=True, counts={"its": 1})

    def sync(self):
        pass

    def build_seconds(self):
        return 0.0

    def close(self):
        assert self.shapes == {(15,)}, self.shapes
"""
REFERENCE_HALF = """
import numpy as np


class Reference:
    def __init__(self, config):
        pass

    def check(self, f, x):
        return {"residual": float(np.linalg.norm(2.0 * x - f) / np.linalg.norm(f))}
"""
DRIVER = r"""
import json, sys, time
root = sys.argv[1]
sys.path.insert(0, root)
import torch
from h100bench import harness
cell = harness.resolve(root, "vec3.steps")
assert [m["name"] for m in cell.per_layer] == ["steps_in_window"], cell.per_layer
r = harness.run_cell(cell, 2**40 + 3, 0.05, False, torch.device("cpu"), time.perf_counter())
print(json.dumps(r))
"""


def test_a_generator_of_another_load_shape_needs_no_edit(tmp_path):
    """A generator whose loads are not one a node of a box, with its mix,
    configuration, system, reference, cell and two metrics, added as new
    files and entries alone, runs through the harness; no file that was
    there changes."""
    shutil.copytree(ROOT / "h100bench", tmp_path / "h100bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = tmp_path / "h100bench"
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    (bench / "generators" / "three_per_node.py").write_text(GENERATOR_3)
    (bench / "systems" / "half.py").write_text(SYSTEM_HALF)
    (bench / "reference" / "half.py").write_text(REFERENCE_HALF)
    (bench / "traffic" / "vec3.json").write_text(json.dumps(
        {"generator": "three_per_node", "pool": 5, "pool_seed": 11, "check_sample": 2,
         "trace_steps": 1}))
    (bench / "configs" / "vec3.json").write_text(json.dumps(
        {"name": "vec3", "system": "half", "reference": "half", "problem": {"nodes": 5},
         "limits": {"residual": 1e-12}, "controls": {}}))
    (bench / "end_to_end" / "steps_per_s.py").write_text(
        "def read(ctx):\n    return len(ctx.steps) / ctx.window_s\n")
    (bench / "layer_metrics" / "steps_in_window.py").write_text(
        "def read(ctx):\n    return len(ctx.steps)\n")
    spec = json.loads(json.dumps(SPEC))
    spec["configs"].append({"name": "vec3", "source": "x", "reduced": [],
                            "file": "h100bench/configs/vec3.json", "why": "x"})
    spec["workloads"].append({"name": "vec3.steps", "config": "vec3", "traffic": "vec3",
                              "chips": 1, "why": "x"})
    spec["end_to_end"].append({"name": "steps_per_s", "unit": "1/s", "better": "higher",
                               "bound": 0.05, "source": "host_clock",
                               "workloads": ["vec3.steps"]})
    spec["per_layer"].append({"name": "steps_in_window", "unit": "steps", "better": "higher",
                              "source": "program_counter", "layer": "x", "moves": "steps_per_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    out = subprocess.run([sys.executable, "-c", DRIVER, str(tmp_path)], capture_output=True,
                         text=True, cwd=tmp_path, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.splitlines()[-1])
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1, r
    assert set(r["metrics"]) == {"setup_s", "steps_per_s"}
    assert r["checks"]["residual"]["value"] < 1e-12
    assert all(p.read_bytes() == b for p, b in before.items())
