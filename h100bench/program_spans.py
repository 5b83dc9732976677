"""The program's own spans (``permon_tpu_torch.sys.tracing``) over a few
load steps after the window, for the per-layer metrics that read them.

``read(ctx)`` starts, once a run, a process of its own (this file as a
script) that builds the cell's system, warms it up and runs the first
``trace_steps`` loads of ``steps(mix, config, 0)``: a fixed order, the same
on every checkout. It synchronises at each step, resets the program's span
aggregates before the first and copies them after the last. A process in
which a profiler has run launches slower for the rest of its life (10-20%
a step on an H100's host), and the run's own process has traced its
windows by then; no profiler has run in this one, so its spans time the
program as the timed window runs it. On a card, the first of these steps
runs again under ``torch.profiler`` (CPU and CUDA activity: ~130 K+
passes, and a third of the cost of profiling all of them), and the device
time of the kernels launched under each ``kplus.solve`` range is read by
the profiler's own link of a kernel to the operation that launched it.

Every number is logged to standard error with the spans' counts by parent.
A program without the spans gives the metrics nothing to read: they are
then left out of the line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Optional, Tuple

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from h100bench.harness import Cell, generator, log, make_system  # noqa: E402


@dataclass
class Spans:
    steps: int
    #: wall seconds of the steps, each synchronised at its end
    wall_s: float
    #: span name -> (count, total seconds, self seconds)
    events: Dict[str, Tuple[int, float, float]]
    #: (parent span or None, span) -> count
    parents: Dict[tuple, int] = field(default_factory=dict)
    #: the first step's wall under the profiler (on a card)
    profiled_wall_s: Optional[float] = None
    #: device seconds per kplus.solve range, by the profiler (on a card)
    kplus_device_s: Optional[float] = None

    def count(self, name: str) -> int:
        return int(self.events.get(name, (0, 0.0, 0.0))[0])

    def seconds(self, name: str) -> float:
        return float(self.events.get(name, (0, 0.0, 0.0))[1])


def _run_steps(system, inputs) -> float:
    wall = 0.0
    for b in inputs:
        system.sync()
        t0 = time.perf_counter()
        system.solve(b)
        system.sync()
        wall += time.perf_counter() - t0
    return wall


def range_device_seconds(prof, name: str) -> Tuple[int, float]:
    """(ranges, device seconds) of the ranges called ``name`` in a profile
    with CPU and CUDA activity, by the profiler's own link of a device
    record to the host operation that launched it (its linked correlation
    id), an operation belonging to the range open on the host when it
    started. It reads the records as they are: a pass over them, no
    event tree."""
    import numpy as np
    from torch.autograd import DeviceType

    starts, ends, op_start, links, durs = [], [], {}, [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation() and e.duration_ns() > 0:
                links.append(e.linked_correlation_id())
                durs.append(e.duration_ns())
        elif e.linked_correlation_id() == 0 and not e.is_async():
            if e.name() == name:
                starts.append(e.start_ns())
                ends.append(e.end_ns())
            else:
                op_start[e.correlation_id()] = e.start_ns()
    if not starts or not links:
        return len(starts), 0.0
    order = np.argsort(starts)
    s, en = np.asarray(starts)[order], np.asarray(ends)[order]
    t = np.array([op_start.get(k, -1) for k in links], dtype=np.int64)
    i = np.searchsorted(s, t, side="right") - 1
    inside = (t >= 0) & (i >= 0) & (t < en[np.maximum(i, 0)])
    return len(starts), float(np.asarray(durs, dtype=np.int64)[inside].sum()) / 1e9


def _kplus_device_seconds(system, inputs) -> Tuple[float, Optional[float]]:
    """(wall, device seconds per kplus.solve range) of the steps under the
    profiler; None where no range holds a device record."""
    from torch.profiler import ProfilerActivity, profile

    system.sync()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = _run_steps(system, inputs)
    t1 = time.perf_counter()
    n, sec = range_device_seconds(prof, "kplus.solve")
    log(f"[h100bench] spans: profiled pass {wall:.4f} s ({t1 - t0:.1f} s with the profiler's "
        f"start and stop), {n} kplus.solve ranges with {sec:.6f} device s; read in "
        f"{time.perf_counter() - t1:.1f} s")
    return wall, (sec / n if n and sec > 0 else None)


def probe(cell, device) -> dict:
    """The spans of the probe's steps in this process, as JSON-ready data."""
    import torch

    from permon_tpu_torch.sys import tracing

    system = make_system(cell, device)
    gen = generator(cell)
    system.solve(system.to_input(gen.load(cell.mix, cell.config, gen.warmup(cell.mix,
                                                                             cell.config))))
    loads = gen.steps(cell.mix, cell.config, 0)[: int(cell.mix["trace_steps"])]
    inputs = [system.to_input(gen.load(cell.mix, cell.config, s)) for s in loads]
    tracing.reset()
    wall = _run_steps(system, inputs)
    out = {"steps": len(inputs), "wall_s": wall,
           "events": {k: [int(v[0]), float(v[1]), float(v[2]) if len(v) > 2 else None]
                      for k, v in tracing.events.items()},
           "parents": [[p, n, c] for (p, n), c in getattr(tracing, "parents", {}).items()]}
    if torch.device(device).type == "cuda" and "kplus.solve" in tracing.events:
        out["profiled_wall_s"], out["kplus_device_s"] = _kplus_device_seconds(system,
                                                                               inputs[:1])
    system.close()
    return out


def read(ctx) -> Optional[Spans]:
    """The spans of the probe's steps, from a process of their own, cached
    on ``ctx``; None where that process fails."""
    if hasattr(ctx, "program_spans"):
        return ctx.program_spans
    ctx.program_spans = None
    import torch

    req = {"config": ctx.cell.config, "mix": ctx.cell.mix,
           "device": "cuda" if ctx.cuda else "cpu", "threads": torch.get_num_threads()}
    t0 = time.perf_counter()
    try:
        got = subprocess.run([sys.executable, str(Path(__file__).resolve()), json.dumps(req)],
                             stdout=subprocess.PIPE, stderr=None, text=True, timeout=300)
        r = json.loads(got.stdout.strip().splitlines()[-1]) if got.returncode == 0 else None
    except (subprocess.TimeoutExpired, IndexError, ValueError) as e:
        got, r = e, None
    if r is None:
        log(f"[h100bench] spans: the probe's process gave no spans "
            f"({getattr(got, 'returncode', got)!r})")
        return None
    spans = Spans(steps=r["steps"], wall_s=r["wall_s"],
                  events={k: tuple(v) for k, v in r["events"].items()},
                  parents={(p, n): c for p, n, c in r["parents"]},
                  profiled_wall_s=r.get("profiled_wall_s"), kplus_device_s=r.get("kplus_device_s"))
    log(f"[h100bench] spans over {spans.steps} steps of seed 0's order, in a process of their "
        f"own ({time.perf_counter() - t0:.1f} s with its set-up): wall {spans.wall_s:.4f} s")
    for name, (cnt, tot, own) in sorted(spans.events.items(), key=lambda kv: -kv[1][1]):
        log(f"[h100bench] span {name}: {cnt} x, total {tot:.6f} s, self {own} s")
    for (par, name), cnt in sorted(spans.parents.items(),
                                   key=lambda kv: (str(kv[0][0]), kv[0][1])):
        log(f"[h100bench] span {par} -> {name}: {cnt}")
    if spans.profiled_wall_s is not None:
        log(f"[h100bench] spans: wall per step {spans.wall_s / spans.steps:.4f} s, the first "
            f"under the profiler {spans.profiled_wall_s:.4f} s")
    ctx.program_spans = spans
    return spans


if __name__ == "__main__":
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    request = json.loads(sys.argv[1])
    torch.set_num_threads(int(request["threads"]))
    probe_cell = Cell(name="probe", chips=1, config=request["config"], mix=request["mix"],
                      end_to_end=[], per_layer=[])
    print(json.dumps(probe(probe_cell, request["device"])), flush=True)
