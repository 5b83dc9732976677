"""What the benchmark reads from a ``torch.profiler`` trace: the device's
activity intervals (kernels, copies, sets) and the host's operations, on
the profiler's one clock.

- ``busy_s``: the union of the device intervals, so overlapping work counts
  once;
- ``device_ops``: device seconds by name, largest first;
- ``idle_gaps``: the gaps between device intervals, each named by the
  innermost host operation open at its middle (the benchmark's own spans
  included), summed by name, largest first.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, List, Tuple

import numpy as np


@dataclass
class Trace:
    window_s: float
    dev_start: np.ndarray  # ns, sorted
    dev_end: np.ndarray
    dev_name: List[str]
    host_start: np.ndarray  # ns, sorted
    host_end: np.ndarray
    host_name: List[str]

    @classmethod
    def from_profiler(cls, prof, window_s: float) -> "Trace":
        # a record (PyTorch 2.11 gives no activity type) says its device and
        # whether it is a user annotation: on the device, a kernel, copy or
        # set is work, and an annotation, which spans the gaps between its
        # kernels, is not; on the host, every record is an operation
        dev, host = [], []
        for e in prof.profiler.kineto_results.events():
            rec = (e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
            if str(e.device_type()).endswith("CUDA"):
                if not e.is_user_annotation() and e.duration_ns() > 0:
                    dev.append(rec)
            else:
                host.append(rec)
        dev.sort()
        host.sort()
        col = lambda recs, i: np.array([r[i] for r in recs], dtype=np.int64)  # noqa: E731
        return cls(window_s=window_s, dev_start=col(dev, 0), dev_end=col(dev, 1),
                   dev_name=[r[2] for r in dev], host_start=col(host, 0),
                   host_end=col(host, 1), host_name=[r[2] for r in host])

    def merged(self) -> Tuple[np.ndarray, np.ndarray]:
        """The device intervals merged into disjoint ones (start, end)."""
        if len(self.dev_start) == 0:
            return self.dev_start, self.dev_end
        end_max = np.maximum.accumulate(self.dev_end)
        new = np.ones(len(self.dev_start), dtype=bool)
        new[1:] = self.dev_start[1:] > end_max[:-1]
        starts = self.dev_start[new]
        ends = end_max[np.r_[np.flatnonzero(new)[1:] - 1, len(self.dev_start) - 1]]
        return starts, ends

    @property
    def busy_s(self) -> float:
        s, e = self.merged()
        return float((e - s).sum()) / 1e9

    def device_seconds(self, pattern: str = "") -> float:
        """Device seconds of the activities whose name holds ``pattern``
        (each counted whole, overlaps included)."""
        d = self.dev_end - self.dev_start
        return float(sum(t for t, n in zip(d, self.dev_name) if pattern in n)) / 1e9

    def device_ops(self, top: int = 10) -> List[list]:
        by = {}
        for t, n in zip(self.dev_end - self.dev_start, self.dev_name):
            by[n] = by.get(n, 0) + int(t)
        return [[n[:160], t / 1e9] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[list]:
        s, e = self.merged()
        if len(s) < 2:
            return []
        gs, ge = e[:-1], s[1:]
        mids = (gs + ge) // 2
        by = {}
        pos = np.searchsorted(self.host_start, mids, side="right") - 1
        # long operations (spans around a whole step) that a short look back
        # from the gap would not reach, longest last
        long_ops = np.argsort(self.host_end - self.host_start)[::-1][:256][::-1]
        for g, m, p in zip(ge - gs, mids, pos):
            name = "no host operation"
            # the innermost open operation: the latest started that is still open
            for q in range(p, max(p - 64, -1), -1):
                if self.host_end[q] > m:
                    name = self.host_name[q]
                    break
            else:
                for q in long_ops:
                    if self.host_start[q] <= m < self.host_end[q]:
                        name = self.host_name[q]
                        break
            by[name] = by.get(name, 0) + int(g)
        return [[n[:160], t / 1e9] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def profiled(fn: Callable[[], object], sync: Callable[[], None], cuda: bool = True,
             host: bool = True):
    """Run ``fn`` under the profiler, synchronised at both ends; returns
    (fn's result, Trace).  It records the device's work with ``cuda`` and
    the host's operations with ``host`` (or without a device); recording
    the host's operations slows the host's side of a launch several times
    over, so a window whose idle share is read records the device alone."""
    from torch.profiler import ProfilerActivity, profile

    sync()
    acts = (([ProfilerActivity.CPU] if host or not cuda else [])
            + ([ProfilerActivity.CUDA] if cuda else []))
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        sync()
        window = time.perf_counter() - t0
    return out, Trace.from_profiler(prof, window)
