"""The benchmark's general part: it finds a cell's pieces by name, builds the
system, warms it up, drives the closed loop of load steps for the window,
traces a few more steps when asked, reads the metrics and checks the
answers against the plain reference.

Every piece is found by its name in ``BENCHMARK.json``:

- a configuration: the JSON ``file`` of its entry; it names its
  ``system`` (``systems/<system>.py``), its ``reference``
  (``reference/<reference>.py``) and the ``limits`` of the numbers compared;
- a traffic mix: ``traffic/<traffic>.json``, parameters only; it names its
  ``generator`` (``generators/<generator>.py``: ``steps(mix, config, seed)``,
  ``warmup(mix, config)``, ``load(mix, config, step)``), which alone knows
  the load's shape, and holds the harness's ``check_sample`` and
  ``trace_steps``;
- an end-to-end metric: ``end_to_end/<name>.py``; a per-layer metric:
  ``layer_metrics/<name>.py``.  Each holds ``read(ctx) -> float | None``;
  None leaves the metric out of the line.

So a later cell, mix, configuration or metric is new files and new entries.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

from .tracing import profiled

HERE = Path(__file__).resolve().parent
#: top-level module names that no process of the benchmark may hold: the
#: JAX package the port was made from, and JAX itself (compared whole, as
#: the port's name begins with the JAX package's)
BANNED = ("jax", "jaxlib", "flax", "permon_tpu")
#: keys of a traffic mix that the harness reads; the rest are its generator's
MIX_KEYS = ("generator", "check_sample", "trace_steps")


def banned_modules(names=None) -> List[str]:
    names = sys.modules if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(BANNED))


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """A generator for one stream of one seed; any whole number is a seed."""
    return np.random.default_rng(np.random.SeedSequence([seed % (1 << 64), *stream]))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_module(path: Path):
    """Import the file at ``path`` under a name of its own (metric files
    carry dots in their names)."""
    name = "h100bench_piece_" + "".join(c if c.isalnum() else "_" for c in
                                        str(path.relative_to(HERE)))
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def read_mix(path: Path) -> dict:
    mix = json.loads(Path(path).read_text())
    missing = [k for k in MIX_KEYS if k not in mix]
    if missing:
        raise ValueError(f"traffic mix {path}: missing {missing}")
    return mix


def read_spec(root: Path) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def reported(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def resolve(root: Path, workload: str, spec: Optional[dict] = None) -> Cell:
    """The cell ``workload`` of ``root``'s BENCHMARK.json with its pieces."""
    root = Path(root)
    spec = read_spec(root) if spec is None else spec
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json ({sorted(cells)})")
    w = cells[workload]
    cfg = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = json.loads((root / cfg["file"]).read_text())
    mix = read_mix(HERE / "traffic" / f"{w['traffic']}.json")
    e2e = [m for m in spec["end_to_end"] if reported(m, workload)]
    names = {m["name"] for m in e2e}
    # a per-layer metric without a list goes wherever its end-to-end metric goes
    per_layer = [m for m in spec["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return Cell(name=workload, chips=int(w["chips"]), config=config, mix=mix,
                end_to_end=e2e, per_layer=per_layer)


def metric_path(kind: str, name: str) -> Path:
    return HERE / kind / f"{name}.py"


@dataclass
class Step:
    index: int  # the load's place in the seed's sequence
    wall_s: float
    ok: bool
    counts: dict


class Reservoir:
    """A uniform sample of ``k`` items of a stream of unknown length, drawn
    from ``rng`` (Vitter's algorithm R)."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.seen, self.items = k, rng, 0, []

    def offer(self, item) -> None:
        if self.seen < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.items[j] = item
        self.seen += 1


@dataclass
class Context:
    """What a metric reader may read."""
    cell: Cell
    setup_s: float
    window_s: float
    steps: List[Step]
    spans: dict
    timings: dict
    system: object = None
    trace: object = None
    cuda: bool = False
    _probes: Dict[str, Optional[float]] = field(default_factory=dict)

    def total(self, key: str) -> int:
        return sum(s.counts.get(key, 0) for s in self.steps)

    def device_seconds_per_call(self, key: str, make: Callable[[], Callable[[], object]],
                                reps: int = 20, pattern: str = "") -> Optional[float]:
        """Device seconds per call of the callable ``make()`` returns, by the
        profiler's records (those whose name holds ``pattern``; all of them,
        overlaps once, with none); None without a device or a record."""
        if key not in self._probes:
            self._probes[key] = None
            if self.cuda and self.system is not None:
                fn = make()
                fn()
                fn()
                _, tr = profiled(lambda: [fn() for _ in range(reps)], self.system.sync)
                sec = tr.device_seconds(pattern) if pattern else tr.busy_s
                self._probes[key] = sec / reps if sec > 0 else None
        return self._probes[key]


def generator(cell: Cell):
    """The module that makes the loads of ``cell``'s traffic mix."""
    return load_module(HERE / "generators" / f"{cell.mix['generator']}.py")


def make_system(cell: Cell, device, overrides=None):
    mod = load_module(HERE / "systems" / f"{cell.config['system']}.py")
    return mod.System(cell.config, device, overrides)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
             system_factory: Optional[Callable] = None) -> dict:
    """One run of ``cell``; returns the result's line as a dict, its
    ``checks`` last."""
    import torch

    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)  # the peak statistics need the device's context
        torch.cuda.reset_peak_memory_stats(device)
    mix, config, gen = cell.mix, cell.config, generator(cell)
    system = (system_factory or make_system)(cell, device)
    loads = gen.steps(mix, config, seed)
    inputs = [system.to_input(gen.load(mix, config, s)) for s in loads]
    warm = system.to_input(gen.load(mix, config, gen.warmup(mix, config)))
    system.solve(warm)  # one solve of the cell's shapes builds and warms every kernel
    system.sync()
    setup_s = time.perf_counter() - t_start
    log(f"[h100bench] {cell.name} seed {seed}: set-up {setup_s:.3f} s ({system.spans}, "
        f"{system.timings}; the kernels' build in this run {system.build_seconds():.3f} s)")

    sample = Reservoir(int(mix["check_sample"]), rng_for(seed, 1))
    steps: List[Step] = []
    t_w0 = t1 = time.perf_counter()
    i = 0
    while True:
        t0 = time.perf_counter()
        ans = system.solve(inputs[i % len(inputs)])
        system.sync()
        t1 = time.perf_counter()
        steps.append(Step(i % len(inputs), t1 - t0, ans.ok, ans.counts))
        sample.offer((i % len(inputs), ans.x))
        i += 1
        if t1 - t_w0 >= seconds:
            break
    window_s = t1 - t_w0
    walls = [s.wall_s for s in steps]
    totals = {k: sum(s.counts.get(k, 0) for s in steps) for k in steps[0].counts}
    log(f"[h100bench] window {window_s:.3f} s: {len(steps)} steps, wall per step min "
        f"{min(walls):.4f} median {float(np.median(walls)):.4f} max {max(walls):.4f} s; "
        f"counts {totals}; "
        f"{sum(1 for w in walls if w > np.percentile(walls, 90))} steps beyond the p90")

    for s in steps:
        log(f"[h100bench] step {s.index}: {s.wall_s:.4f} s {s.counts}")
    ctx = Context(cell=cell, setup_s=setup_s, window_s=window_s, steps=steps,
                  spans=dict(system.spans), timings=dict(system.timings), system=system,
                  cuda=cuda)
    checked = list(sample.items)
    traced: List[Step] = []
    host_trace = None
    if trace:
        def traced_steps(first):
            from torch.profiler import record_function

            out = []
            for j in range(int(mix["trace_steps"])):
                k = (first + j) % len(inputs)
                with record_function("h100bench.solve"):
                    t0 = time.perf_counter()
                    a = system.solve(inputs[k])
                    system.sync()
                out.append((k, Step(k, time.perf_counter() - t0, a.ok, a.counts), a.x))
            return out

        # the device alone, for the busy time and the idle share; then the same
        # number of steps with the host's operations, for what the gaps wait on
        got, ctx.trace = profiled(lambda: traced_steps(i), system.sync, cuda=cuda, host=False)
        got2, host_trace = profiled(lambda: traced_steps(i + int(mix["trace_steps"])),
                                    system.sync, cuda=cuda, host=True)
        traced = [s for _, s, _ in got + got2]
        checked += [(k, x) for k, _, x in got + got2]
        for name, tr in (("device", ctx.trace), ("host and device", host_trace)):
            log(f"[h100bench] traced window ({name}) {tr.window_s:.3f} s over "
                f"{int(mix['trace_steps'])} steps: device busy {tr.busy_s:.4f} s, "
                f"{len(tr.dev_name)} device records")

    kinds = ("layer_metrics", cell.per_layer) if trace else ("end_to_end", cell.end_to_end)
    metrics = {}
    for m in kinds[1]:
        value = load_module(metric_path(kinds[0], m["name"])).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result = {"correct": False, "attempted": len(steps) + len(traced),
              "failed": sum(1 for s in steps + traced if not s.ok), "metrics": metrics}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips,
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device)) if cuda else 0}
    if trace and ctx.trace is not None:
        dev.update(busy_s=ctx.trace.busy_s, window_s=ctx.trace.window_s)
        result["breakdown"] = {"device_ops": ctx.trace.device_ops(),
                               "idle_gaps": host_trace.idle_gaps()}
    result["device"] = dev
    for name, m in metrics.items():
        log(f"[h100bench] {name} = {m['value']!r} {m['unit']}")

    # free the program's state before the reference runs
    ctx.system = ctx.trace = host_trace = None
    system.close()
    del system, inputs, ctx
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    found = banned_modules()
    if found:
        raise ImportError(f"the run loaded {found}: the benchmark runs without JAX and "
                          "without the JAX package")
    result["checks"] = check_answers(cell, gen, loads, checked, result["failed"])
    result["correct"] = all(c["value"] <= c["limit"] for c in result["checks"].values())
    return result


def check_answers(cell: Cell, gen, loads, checked, failed: int) -> dict:
    """The worst of each number over the checked answers ((place in
    ``loads``, answer) pairs), beside its limit
    (the configuration's; with no answer the number is infinite); ``failed``
    solves, those that did not end converged, count against a limit of 0."""
    ref = load_module(HERE / "reference" / f"{cell.config['reference']}.py").Reference(cell.config)
    worst: Dict[str, float] = {}
    for k, x in checked:
        f = gen.load(cell.mix, cell.config, loads[k])
        for name, v in ref.check(f, x).items():
            worst[name] = max(worst.get(name, 0.0), v)
    limits = cell.config["limits"]
    checks = {k: {"value": worst.get(k, float("inf")), "limit": float(limits[k])}
              for k in limits}
    checks["failed_solves"] = {"value": float(failed), "limit": 0.0}
    log(f"[h100bench] {len(checked)} answers checked against the reference")
    return checks
