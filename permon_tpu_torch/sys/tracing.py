"""Tracing, debug output, and per-operator event counters — the port of
:mod:`permon_tpu.sys.tracing` (the sys layer).

Reference mechanisms mirrored (src/sys, include/permonsys.h):
- global flags PermonDebugEnabled / PermonTraceEnabled / PermonInfoEnabled
  (permonsys.h:23, src/sys/utils.c:106-133), settable from the environment
  (PERMON_TPU_DEBUG/TRACE/INFO) or :func:`set_from_options`;
- function-level call tracing with wall timers: `-permon_trace` prints
  indented BEGIN/END FUNCTION lines (PetscFunctionBeginI/ReturnI macros,
  permonsys.h:102-134) — here the :func:`traced` decorator / :class:`trace`
  context manager;
- PetscLogEvent-style named event timers (:func:`log_event`, report via
  :func:`event_report`) for host code, and per-operator op counters fed by
  the Timer wrapper (core.linop.Timer, the MATTIMER analog);
- PermonDebug1..6-style leveled debug printf (:func:`debug`).

One span, two sinks.  Every :class:`trace` span is always kept in memory
and written nowhere: ``events[name]`` holds its count, total seconds and
self seconds (the total less what its child spans cover), and
``parents[(parent, name)]`` how often it opened directly under ``parent``
(None at the top).  While a ``torch.profiler`` records, the span also opens
a ``record_function`` range of its name, so it lands on the profiler's
timeline beside the device's records; otherwise no range is opened, and a
span costs two clock reads and a few dict updates.  There is no switch:
the spans of the large path are always on.

The large linear path opens these spans (names are read by the benchmark):
``feti.host_setup`` and ``feti.factor`` (set-up, synchronised: they fill
``FetiSolverSparse.timings``), ``feti.solve``, ``feti.rhs``,
``feti.dual_solve``, ``feti.dualize``, ``feti.post``, ``feti.reassembly``,
``feti.defect``, ``feti.to_host`` (feti/large.py), ``cg.solve``,
``cg.iteration`` and ``cg.read`` (solvers/cg.py; a read is a
device-to-host copy), ``kplus.solve`` (one forward and backward pass of
core/band.py's factors) and ``kplus.replay`` inside it (the replay of the
pass's CUDA graph, on a card), ``gather.apply`` (one per core/sell.py
gather_apply call), ``projector.apply_p`` and ``projector.apply_cp`` (the
coarse-problem solve inside it; qp/projector.py), ``coarse.g_mv`` /
``coarse.g_rmv`` (one G or G' apply of feti/large.py's BlockCoarse, the
coarse operator of the rigid-body nullspace), and ``detred.sum`` (one
fixed-tree reduction of core/detred.py: ``det_sum``, ``det_dot``,
``det_dots``) with ``detred.kernel`` inside it (the launches of its tree,
on a card).  The counts by parent give
the F applies by purpose: ``kplus.solve`` under ``cg.iteration``,
``feti.dualize`` or ``feti.post``; and the G applies by purpose:
``coarse.g_mv`` / ``coarse.g_rmv`` under ``projector.apply_p``,
``feti.dualize`` or ``feti.post``.  Timer's applies
(``<name>.mv`` / ``<name>.rmv``) are spans too.  Spans are kept for one
thread: the stack of open spans is the process's.

One difference to the JAX package: there an operator is traced once per
compilation, so its counters count traces; the port runs eagerly, so they
count applications.
"""

from __future__ import annotations

import functools
import os
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

debug_enabled = os.environ.get("PERMON_TPU_DEBUG", "0") not in ("0", "")
trace_enabled = os.environ.get("PERMON_TPU_TRACE", "0") not in ("0", "")
info_enabled = os.environ.get("PERMON_TPU_INFO", "0") not in ("0", "")

#: (operator name, op) -> number of applications (Timer wrapper)
op_counts: Dict[tuple, int] = defaultdict(int)
#: span name -> [count, total seconds, self seconds]
events: Dict[str, list] = defaultdict(lambda: [0, 0.0, 0.0])
#: (parent span name or None, span name) -> count
parents: Dict[Tuple[Optional[str], str], int] = defaultdict(int)
#: the open spans, innermost last
_stack: List["trace"] = []
_profiling = torch.autograd._profiler_enabled
_clock = time.perf_counter


def set_from_options(debug: Optional[bool] = None, trace: Optional[bool] = None,
                     info: Optional[bool] = None) -> None:
    """The PermonSetFromOptions analog (-permon_debug/-permon_trace/
    -permon_info, src/sys/utils.c:159-220)."""
    global debug_enabled, trace_enabled, info_enabled
    if debug is not None:
        debug_enabled = debug
    if trace is not None:
        trace_enabled = trace
    if info is not None:
        info_enabled = info


def debug(msg: str, *args) -> None:
    """PermonDebug1..6-style leveled printf (permonsys.h:36-73)."""
    if debug_enabled:
        print("DEBUG: " + (msg % args if args else msg))


def info(msg: str, *args) -> None:
    if info_enabled:
        print("INFO: " + (msg % args if args else msg))


def count_op(name: str, op: str) -> None:
    op_counts[(name, op)] += 1


class trace:
    """A named span of host wall time (PetscFunctionBeginI / PetscLogEvent):
    ``with trace(name):``.  On exit it adds to ``events`` and ``parents``;
    ``seconds`` then holds its duration.  BEGIN/END FUNCTION lines are
    printed when ``trace_enabled``; a ``record_function`` range is opened
    while a profiler records."""

    __slots__ = ("name", "seconds", "_child", "_t0", "_range")

    def __init__(self, name: str):
        self.name = name
        self.seconds = 0.0

    def __enter__(self) -> "trace":
        if trace_enabled:
            print("  " * len(_stack) + f"BEGIN FUNCTION {self.name}")
        _stack.append(self)
        self._child = 0.0
        self._range = None
        if _profiling():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self._t0 = _clock()
        return self

    def __exit__(self, *exc) -> None:
        dt = self.seconds = _clock() - self._t0
        if self._range is not None:
            self._range.__exit__(*exc)
        _stack.pop()
        parent = _stack[-1] if _stack else None
        if parent is not None:
            parent._child += dt
        ev = events[self.name]
        ev[0] += 1
        ev[1] += dt
        ev[2] += dt - self._child
        parents[(parent.name if parent is not None else None, self.name)] += 1
        if trace_enabled:
            print("  " * len(_stack) + f"END FUNCTION {self.name} ({dt * 1e3:.3f} ms)")


def traced(fn):
    """Decorator form of :class:`trace` (the PetscFunctionBeginI/ReturnI pair)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with trace(fn.__qualname__):
            return fn(*args, **kwargs)

    return wrapper


log_event = trace  # PetscLogEventBegin/End around a with-block


def event_report() -> str:
    """-log_view-style summary: each span's count, total and self seconds,
    the counts by parent, and the operator op counts."""
    lines = ["Event                                Count     Total (s)      Self (s)"]
    for name, (cnt, tot, own) in sorted(events.items(), key=lambda kv: -kv[1][1]):
        lines.append(f"{name:<36} {cnt:>6} {tot:>12.6f} {own:>13.6f}")
    if parents:
        lines.append("Parent -> event                                        Count")
        for (par, name), cnt in sorted(parents.items(), key=lambda kv: (str(kv[0][0]), kv[0][1])):
            lines.append(f"{str(par) + ' -> ' + name:<54} {cnt:>6}")
    if op_counts:
        lines.append("Operator op                          Applies")
        for (name, op), cnt in sorted(op_counts.items()):
            lines.append(f"{name + '.' + op:<36} {cnt:>6}")
    return "\n".join(lines)


def reset() -> None:
    """Clear the counters and the span aggregates (the open spans stay
    open and are counted when they close)."""
    op_counts.clear()
    events.clear()
    parents.clear()
