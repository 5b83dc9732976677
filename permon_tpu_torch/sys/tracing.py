"""Tracing, debug output, and per-operator event counters — the port of
:mod:`permon_tpu.sys.tracing` (the sys layer).

Reference mechanisms mirrored (src/sys, include/permonsys.h):
- global flags PermonDebugEnabled / PermonTraceEnabled / PermonInfoEnabled
  (permonsys.h:23, src/sys/utils.c:106-133), settable from the environment
  (PERMON_TPU_DEBUG/TRACE/INFO) or :func:`set_from_options`;
- function-level call tracing with wall timers: `-permon_trace` prints
  indented BEGIN/END FUNCTION lines (PetscFunctionBeginI/ReturnI macros,
  permonsys.h:102-134) — here the :func:`traced` decorator / :func:`trace`
  context manager;
- PetscLogEvent-style named event timers (:func:`log_event`, report via
  :func:`event_report`) for host code, and per-operator op counters fed by
  the Timer wrapper (core.linop.Timer, the MATTIMER analog);
- PermonDebug1..6-style leveled debug printf (:func:`debug`).

Device time is the job of ``torch.profiler``: Timer opens a
``record_function`` range per apply.  One difference to the JAX package:
there an operator is traced once per compilation, so its counters count
traces; the port runs eagerly, so they count applications.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from collections import defaultdict
from typing import Dict, Optional

debug_enabled = os.environ.get("PERMON_TPU_DEBUG", "0") not in ("0", "")
trace_enabled = os.environ.get("PERMON_TPU_TRACE", "0") not in ("0", "")
info_enabled = os.environ.get("PERMON_TPU_INFO", "0") not in ("0", "")

_depth = 0
#: (operator name, op) -> number of applications (Timer wrapper)
op_counts: Dict[tuple, int] = defaultdict(int)
#: event name -> [count, total seconds]
events: Dict[str, list] = defaultdict(lambda: [0, 0.0])


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


@contextlib.contextmanager
def trace(name: str):
    """BEGIN/END FUNCTION tracing with wall time (PetscFunctionBeginI)."""
    global _depth
    t0 = time.perf_counter()
    if trace_enabled:
        print("  " * _depth + f"BEGIN FUNCTION {name}")
    _depth += 1
    try:
        yield
    finally:
        _depth -= 1
        dt = time.perf_counter() - t0
        events[name][0] += 1
        events[name][1] += dt
        if trace_enabled:
            print("  " * _depth + f"END FUNCTION {name} ({dt * 1e3:.3f} ms)")


def traced(fn):
    """Decorator form of :func:`trace` (the PetscFunctionBeginI/ReturnI pair)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with trace(fn.__qualname__):
            return fn(*args, **kwargs)

    return wrapper


log_event = trace  # PetscLogEventBegin/End around a with-block


def event_report() -> str:
    """-log_view-style summary of host-side events and operator op counts."""
    lines = ["Event                                Count     Total (s)"]
    for name, (cnt, tot) in sorted(events.items(), key=lambda kv: -kv[1][1]):
        lines.append(f"{name:<36} {cnt:>6} {tot:>12.6f}")
    if op_counts:
        lines.append("Operator op                          Applies")
        for (name, op), cnt in sorted(op_counts.items()):
            lines.append(f"{name + '.' + op:<36} {cnt:>6}")
    return "\n".join(lines)


def reset() -> None:
    op_counts.clear()
    events.clear()
