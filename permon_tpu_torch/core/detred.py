"""Deterministic reductions — the fixed binary tree of
:mod:`permon_tpu.core.detred`, in torch.

Every reduction the solvers own can run as a FIXED BINARY TREE of
elementwise adds: the summation order is pinned by construction, so the
result does not depend on thread counts or on the reduction kernels a
backend picks.  The tree is the same as the JAX package's, so on the CPU
an f64 result is bitwise equal to JAX's for equal inputs.

On the CPU the tree is the plain loop (:func:`det_sum_plain`): one add a
level, after the product.  On a CUDA tensor :func:`det_sum` launches the
hand-written kernel ``csrc/det_sum.cu`` instead (built with the other
kernels, ``core/sell.py``), which forms the product in registers and adds
in the same pairing, so it is bitwise the plain loop; one launch a tree,
two for long rows (:func:`tree_passes`).  It raises on what it does
not take: there is no fallback to the loop on the card.  Each call is the
span ``detred.sum``; its launches are the span ``detred.kernel`` inside it
and count in ``det_sum.launches``.

The mode is a flag read when a solver runs (:func:`deterministic_mode`
scopes it to one solve, as ``FetiOptions(deterministic=True)`` does).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import torch

from ..sys.tracing import trace

_DETERMINISTIC = False


def set_deterministic(on: bool = True) -> None:
    """Toggle deterministic reductions globally.  Prefer the per-solve
    switches (``FetiOptions(deterministic=True)``, ``make_solver(...,
    deterministic=True)``), which scope the flag to one solve through
    :func:`deterministic_mode`."""
    global _DETERMINISTIC
    _DETERMINISTIC = bool(on)


class deterministic_mode:
    """Context manager scoping the deterministic-reduction flag to a block;
    ``deterministic_mode(None)`` inherits the current mode."""

    def __init__(self, on):
        self.on = on

    def __enter__(self):
        global _DETERMINISTIC
        self._old = _DETERMINISTIC
        if self.on is not None:
            _DETERMINISTIC = bool(self.on)
        return self

    def __exit__(self, *exc):
        global _DETERMINISTIC
        _DETERMINISTIC = self._old
        return False


def enabled() -> bool:
    return _DETERMINISTIC


# ------------------------------------------------------- the kernel's plan

#: limits of csrc/det_sum.cu: base pointers (parts) and row dimensions of a
#: launch, levels a thread evaluates, threads a block
MAX_PARTS, ROW_DIMS, MAX_LEVELS, MAX_THREADS = 8, 4, 7, 1024
#: levels a thread evaluates in the pass that reads the inputs from device
#: memory (16 leaves): few, so that the SMs hold many threads, each with its
#: loads in flight together; passes over scratch (in L2) take up to MAX_LEVELS
FIRST_LEVELS = 4
#: threads a block of a partial pass
PARTIAL_THREADS = 128
#: a partial pass evaluates levels until a row has at most this many values,
#: so that the final pass's block reads at most 64 KB a row in f64
SCRATCH_ROW = 8192
_FLOAT_CODE = {torch.float32: 0, torch.float64: 1}
_SMS: dict = {}


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA ``device`` (read once a device)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    got = _SMS.get(index)
    if got is None:
        got = _SMS[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return got


def level_size(n: int, levels: int) -> int:
    """Values of a row of ``n`` after ``levels`` levels of the tree."""
    for _ in range(levels):
        n -= n // 2
    return n


@dataclasses.dataclass(frozen=True)
class TreePass:
    """One launch: each thread evaluates ``levels`` levels of a row in
    registers; ``span`` values of that level a block a row, ``group``
    neighbouring rows a block; ``partial`` writes that level to scratch,
    else the block finishes the tree in shared memory."""

    levels: int
    span: int
    group: int
    partial: bool


def tree_passes(rows: int, n: int, group: int, sms: int) -> Tuple[TreePass, ...]:
    """The kernel's launches for ``rows`` rows of ``n`` values, ``group``
    rows a block, on a card of ``sms`` SMs, chosen from the shape alone.  A
    final pass takes the fewest levels that leave a block's rows within its
    threads (up to 1,024 threads where the blocks do not fill the SMs, else
    256), at most ``FIRST_LEVELS`` over the inputs; where that cannot hold
    the rows (CG's dots, a 48-row G, BlockCoarse's 13,440 dofs), a partial
    pass evaluates ``FIRST_LEVELS`` levels into scratch first (later partial
    passes, over scratch, until a row fits ``SCRATCH_ROW``), and the passes
    after it take one row a block."""
    passes = []
    m, g = int(n), int(group)
    while True:
        groups = -(-rows // g)
        cap = MAX_THREADS // g
        top = MAX_LEVELS if passes else FIRST_LEVELS
        target = cap if groups < sms else max(256 // g, 1)
        fit = [lv for lv in range(top + 1) if level_size(m, lv) <= target]
        lv = fit[0] if fit else (top if level_size(m, top) <= cap else None)
        if lv is not None:
            passes.append(TreePass(lv, level_size(m, lv), g, False))
            return tuple(passes)
        lp = FIRST_LEVELS if not passes else next(
            (k for k in range(1, MAX_LEVELS + 1) if level_size(m, k) <= SCRATCH_ROW),
            MAX_LEVELS)
        span = max(PARTIAL_THREADS // g, 1)
        while -(-level_size(m, lp) // span) > 65535:  # blocks a row of a partial pass
            if lp == MAX_LEVELS:
                raise ValueError(f"det_sum: a row of {n} values is too long for the kernel")
            lp += 1
        passes.append(TreePass(lp, span, g, True))
        m, g = level_size(m, lp), 1


@dataclasses.dataclass(frozen=True)
class TreeLayout:
    """Where the kernel reads a reduction: ``rows`` rows of ``n`` values,
    value i of row r at ``offset_a(r) + i * sa`` of the first factor (and of
    the second at ``sb``), the rows in row-major order over ``size`` (row
    dimensions inside a part, outermost first, padded with 1) with strides
    ``sta`` / ``stb``, and ``parts`` base pointers of ``rows // parts`` rows
    each.  ``passes`` are its launches, ``out_shape`` the result's shape.
    Sizes and strides count elements."""

    n: int
    sa: int
    sb: int
    size: Tuple[int, ...]
    sta: Tuple[int, ...]
    stb: Tuple[int, ...]
    rows: int
    parts: int
    has_b: bool
    dtype: torch.dtype
    out_shape: Tuple[int, ...]
    passes: Tuple[TreePass, ...]


def _check_dtypes(*ts) -> torch.dtype:
    dt = ts[0].dtype
    if dt not in _FLOAT_CODE:
        raise TypeError(f"det_sum on the card takes float32 or float64, got {dt}")
    if any(t.dtype != dt for t in ts):
        raise TypeError("det_sum on the card takes both factors in one dtype, got "
                        + ", ".join(str(t.dtype) for t in ts))
    return dt


def tree_layout(x: torch.Tensor, axis: int = -1, y: Optional[torch.Tensor] = None,
                sms: Optional[int] = None) -> TreeLayout:
    """The kernel's layout of ``det_sum(x, axis, y)`` on a card of ``sms``
    SMs (by default ``x``'s card): ``x`` and ``y`` broadcast together (a
    broadcast dimension has stride 0), the summed axis moved last, row
    dimensions of size 1 dropped and neighbours merged where both factors'
    strides allow.  Raises TypeError for a dtype the kernel does not take,
    ValueError for more than ``ROW_DIMS`` row dimensions that do not merge,
    IndexError for an empty sum."""
    dt = _check_dtypes(x) if y is None else _check_dtypes(x, y)
    if y is not None:
        x, y = torch.broadcast_tensors(x, y)
    xm = torch.movedim(x, axis, -1)
    ym = xm if y is None else torch.movedim(y, axis, -1)
    n = xm.shape[-1]
    if n == 0:
        raise IndexError("det_sum of an empty axis")
    dims = []  # [size, stride in x, stride in y], outermost first
    for size, s_a, s_b in zip(xm.shape[:-1], xm.stride()[:-1], ym.stride()[:-1]):
        if size == 1:
            continue
        if dims and dims[-1][1] == s_a * size and dims[-1][2] == s_b * size:
            dims[-1] = [dims[-1][0] * size, s_a, s_b]
        else:
            dims.append([size, s_a, s_b])
    if len(dims) > ROW_DIMS:
        raise ValueError(f"det_sum on the card takes at most {ROW_DIMS} row dimensions "
                         f"that do not merge, got {len(dims)}")
    rows = 1
    for d in dims:
        rows *= d[0]
    if rows >= 2 ** 31:
        raise ValueError(f"det_sum on the card takes fewer than 2^31 rows, got {rows}")
    sa, sb = xm.stride(-1), ym.stride(-1)
    # a strided sum over rows that are neighbours in memory: G rows a block,
    # on neighbouring threads, so that a warp reads neighbouring addresses
    group = min(32, dims[-1][0]) if dims and abs(sa) != 1 and dims[-1][1] == 1 else 1
    dims = [[1, 0, 0]] * (ROW_DIMS - len(dims)) + dims
    return TreeLayout(n=n, sa=sa, sb=sb if y is not None else 0,
                      size=tuple(d[0] for d in dims), sta=tuple(d[1] for d in dims),
                      stb=tuple(d[2] if y is not None else 0 for d in dims), rows=rows,
                      parts=1, has_b=y is not None, dtype=dt, out_shape=tuple(xm.shape[:-1]),
                      passes=tree_passes(rows, n, group, sms or sm_count(x.device))
                      if rows else ())


def parts_layout(pairs, sms: Optional[int] = None) -> TreeLayout:
    """The kernel's layout of :func:`det_dots` over contiguous vector pairs
    of one length and dtype on a card of ``sms`` SMs (by default the
    pairs'): one row a pair, each pair a part."""
    x0 = pairs[0][0]
    return TreeLayout(n=x0.shape[0], sa=1, sb=1, size=(1,) * ROW_DIMS, sta=(0,) * ROW_DIMS,
                      stb=(0,) * ROW_DIMS, rows=len(pairs), parts=len(pairs), has_b=True,
                      dtype=x0.dtype, out_shape=(len(pairs),),
                      passes=tree_passes(len(pairs), x0.shape[0], 1,
                                         sms or sm_count(x0.device)))


class DetSumArgs(ctypes.Structure):
    """``struct DetSumArgs`` of csrc/det_sum.cu: one launch."""
    _fields_ = ([("a", ctypes.c_void_p * MAX_PARTS), ("b", ctypes.c_void_p * MAX_PARTS),
                 ("out", ctypes.c_void_p)]
                + [(f, ctypes.c_int64) for f in ("n", "sa", "sb")]
                + [(f, ctypes.c_int64 * ROW_DIMS) for f in ("size", "sta", "stb")]
                + [(f, ctypes.c_int64) for f in ("rows_per_part", "rows")]
                + [(f, ctypes.c_int32) for f in ("dtype", "has_b", "levels", "group", "span",
                                                 "partial")])


def pass_sources(lay: TreeLayout):
    """Per pass: (n, sa, sb, size, sta, stb, rows_per_part, has_b) of its
    source — the inputs for the first, the previous pass's scratch (rows of
    ``n_L`` values, contiguous) after a partial pass."""
    out, n = [], lay.n
    for k, p in enumerate(lay.passes):
        if k == 0:
            out.append((n, lay.sa, lay.sb, lay.size, lay.sta, lay.stb, lay.rows // lay.parts,
                        lay.has_b))
        else:
            out.append((n, 1, 0, (1,) * (ROW_DIMS - 1) + (lay.rows,),
                        (0,) * (ROW_DIMS - 1) + (n,), (0,) * ROW_DIMS, lay.rows, False))
        n = level_size(n, p.levels)
    return out


class _Launches:
    """The checked launches of one layout, kept by input shape, strides and
    dtype: the ctypes structs of its passes, filled but for the pointers,
    and the scratch of its partial passes, one set a stream (a stream runs
    its launches in order, so one call's scratch is free when the next
    call's first launch starts)."""

    def __init__(self, lay: TreeLayout):
        self.lay = lay
        self.args = []
        self.scratch = []  # elements of each partial pass's output
        for p, (n, sa, sb, size, sta, stb, rpp, has_b) in zip(lay.passes, pass_sources(lay)):
            a = DetSumArgs(n=n, sa=sa, sb=sb, rows_per_part=rpp, rows=lay.rows,
                           dtype=_FLOAT_CODE[lay.dtype], has_b=int(has_b), levels=p.levels,
                           group=p.group, span=p.span, partial=int(p.partial))
            a.size[:], a.sta[:], a.stb[:] = size, sta, stb
            self.args.append(a)
            if p.partial:
                self.scratch.append(lay.rows * level_size(n, p.levels))
        self.refs = [ctypes.byref(a) for a in self.args]
        self.bufs = {}  # (device index, stream) -> scratch tensors
        self.fn = self.stream_of = None

    def __call__(self, xs, ys) -> torch.Tensor:
        lay, dev = self.lay, xs[0].device
        out = torch.empty(lay.out_shape, dtype=lay.dtype, device=dev)
        if not lay.rows:
            return out
        if self.fn is None:
            from .sell import _load, current_raw_stream

            self.fn, self.stream_of = _load("det_sum").permon_det_sum, current_raw_stream
        index = dev.index
        if torch.cuda.current_device() != index:
            with torch.cuda.device(index):
                return self._run(xs, ys, out, index)
        return self._run(xs, ys, out, index)

    def _run(self, xs, ys, out, index):
        stream = self.stream_of(index)
        first = self.args[0]
        for k, t in enumerate(xs):
            first.a[k] = t.data_ptr()
        for k, t in enumerate(ys):
            first.b[k] = t.data_ptr()
        if self.scratch:
            bufs = self.bufs.get((index, stream))
            if bufs is None:
                bufs = self.bufs[(index, stream)] = [
                    torch.empty(s, dtype=self.lay.dtype, device=out.device) for s in self.scratch]
            if self.args[0].out != bufs[0].data_ptr():  # new, or the last call had another stream
                for k, t in enumerate(bufs):
                    self.args[k].out = self.args[k + 1].a[0] = t.data_ptr()
        self.args[-1].out = out.data_ptr()
        with trace("detred.kernel"):
            for ref in self.refs:
                err = self.fn(ref, stream)
                if err != 0:
                    raise RuntimeError(f"det_sum kernel launch failed: error {err}")
                det_sum.launches += 1
        return out


#: launches by input layout; a dict of a bounded size
_launch_cache: dict = {}


def _cached(key, make) -> _Launches:
    got = _launch_cache.get(key)
    if got is None:
        if len(_launch_cache) >= 512:
            _launch_cache.clear()
        got = _launch_cache[key] = _Launches(make())
    return got


# ------------------------------------------------------------- reductions


def det_sum_plain(x: torch.Tensor, axis: int = -1, y: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """The plain PyTorch tree, on any device: the product ``x * y`` first
    (when ``y`` is given), then one add a level: element i with element
    i + n//2, an odd tail element carried along."""
    if y is not None:
        x = x * y
    x = torch.movedim(x, axis, -1)
    n = x.shape[-1]
    while n > 1:
        half = n // 2
        lo = x[..., :half] + x[..., half: 2 * half]
        x = torch.cat([lo, x[..., 2 * half:]], dim=-1) if n % 2 else lo
        n = x.shape[-1]
    return x[..., 0]


def det_sum(x: torch.Tensor, axis: int = -1, y: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sum of ``x`` (times ``y``, broadcast against it) along ``axis`` as a
    fixed binary tree of elementwise adds: pair element i with element
    i + n//2, carry an odd tail element along.  A CPU tensor takes
    :func:`det_sum_plain`; a CUDA tensor the kernel (float32 or float64,
    ``x`` and ``y`` of one dtype), which never stores the product."""
    with trace("detred.sum"):
        if not x.is_cuda:
            return det_sum_plain(x, axis, y)
        if y is None:
            key = (axis, x.shape, x.stride(), x.dtype, x.device)
            return _cached(key, lambda: tree_layout(x, axis))((x,), ())
        if y.device != x.device:
            raise ValueError(f"det_sum: x on {x.device}, y on {y.device}: one device")
        key = (axis, x.shape, x.stride(), x.dtype, x.device, y.shape, y.stride(), y.dtype)
        return _cached(key, lambda: tree_layout(x, axis, y))((x,), (y,))


#: kernel launches since the last reset (set to 0 to reset)
det_sum.launches = 0


def det_dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """<x, y> with a pinned summation order."""
    if x.is_cuda:
        x, y = _flat_pair(x, y)
        return det_sum(x, -1, y)
    return det_sum((torch.conj(x) * y).reshape(-1))


def _flat_pair(x, y):
    """``x`` and ``y`` as vectors of the dtype their product has."""
    if x.dtype != y.dtype:
        dt = torch.promote_types(x.dtype, y.dtype)
        x, y = x.to(dt), y.to(dt)
    return x.reshape(-1), y.reshape(-1)


def det_dots(pairs):
    """Tuple of <x_i, y_i> as ONE batched fixed tree; each row's order is
    identical to :func:`det_dot` of that pair alone (bitwise equal).  On the
    card the pairs are the rows of one launch (up to ``MAX_PARTS`` a
    launch), each pair read where it lies; they have one length, dtype and
    device, else it raises."""
    if not pairs[0][0].is_cuda:
        prods = torch.stack([(torch.conj(x) * y).reshape(-1) for x, y in pairs])
        out = det_sum(prods, axis=-1)
        return tuple(out[i] for i in range(len(pairs)))
    flat = [tuple(v.contiguous() for v in _flat_pair(x, y)) for x, y in pairs]
    x0 = flat[0][0]
    sig = (x0.shape, x0.dtype, x0.device)
    if any((v.shape, v.dtype, v.device) != sig for pair in flat for v in pair):
        raise ValueError("det_dots on the card takes pairs of one length, dtype and device, "
                         "got " + ", ".join(f"({tuple(x.shape)}, {x.dtype}, {x.device}) x "
                                            f"({tuple(y.shape)}, {y.dtype}, {y.device})"
                                            for x, y in flat))
    out = []
    with trace("detred.sum"):
        _check_dtypes(x0)
        for k0 in range(0, len(flat), MAX_PARTS):
            chunk = flat[k0: k0 + MAX_PARTS]
            key = ("parts", len(chunk), x0.shape, x0.dtype, x0.device)
            run = _cached(key, lambda: parts_layout(chunk))
            out.extend(run([x for x, _ in chunk], [y for _, y in chunk]).unbind())
    return tuple(out)


def det_norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(det_dot(x, x).real)


def vdot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``torch.vdot`` normally; the fixed-tree dot in deterministic mode."""
    return det_dot(x, y) if _DETERMINISTIC else torch.vdot(x.reshape(-1), y.reshape(-1))


def norm(x: torch.Tensor) -> torch.Tensor:
    return det_norm(x) if _DETERMINISTIC else torch.linalg.vector_norm(x)


def det_gram(G: torch.Tensor) -> torch.Tensor:
    """G G' (k, n) -> (k, k) with a pinned reduction order over n: chunks
    are added left to right, each chunk's sum is the fixed tree."""
    k, n = G.shape
    chunk = max(min(n, (1 << 22) // max(k * k, 1)), 1)
    out = torch.zeros((k, k), dtype=G.dtype, device=G.device)
    for c0 in range(0, n, chunk):
        Gc = G[:, c0: c0 + chunk]
        out = out + det_sum(Gc[:, None, :], -1, Gc[None, :, :])
    return out


def gram(G: torch.Tensor) -> torch.Tensor:
    return det_gram(G) if _DETERMINISTIC else G @ G.T
