"""The benchmark refuses to run without a card, without the program, or
with JAX or the JAX package loaded (top-level names compared whole)."""

import shutil
import subprocess
import sys

from conftest import ROOT

from h100bench import harness


def test_top_level_names_are_compared_whole():
    names = ["permon_tpu_torch", "permon_tpu_torch.core.band", "numpy", "jaxtyping"]
    assert harness.banned_modules(names) == []
    assert harness.banned_modules(names + ["jax.numpy", "permon_tpu.core", "flax"]) == [
        "flax", "jax", "permon_tpu"]


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import h100bench.harness, h100bench.run, h100bench.control; "
            "import h100bench.systems.feti_large as s; import permon_tpu_torch.feti.large; "
            "from h100bench.harness import banned_modules; print(banned_modules())")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_a_loaded_jax_stops_the_run(monkeypatch):
    import types

    from h100bench import run

    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert run.main(["--workload", "poisson3d-1m.loadsteps", "--seed", "1"]) == 3


def _run(cwd):
    return subprocess.run([sys.executable, "h100bench/run.py", "--workload",
                           "poisson3d-1m.loadsteps", "--seed", "3", "--seconds", "1",
                           "--trace", "0"], capture_output=True, text=True, cwd=cwd,
                          timeout=300)


def test_no_card_no_result():
    import torch

    out = _run(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    if not torch.cuda.is_available():
        assert "CUDA card" in out.stderr


def test_without_the_program_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "h100bench", tmp_path / "h100bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
