"""The hand-written Hopper kernels of the port: the build of all three, and
the wrappers of two.  The third, ``csrc/det_sum.cu`` (the fixed-tree
reduction), is wrapped by :func:`permon_tpu_torch.core.detred.det_sum`.

``gather_apply`` — the port of the TPU gather kernel
``permon_tpu/core/sell.py::_sell_gather_pallas``.  The JAX package runs
every B u and B'lambda of the large path through the plane-major gather
tables of :class:`~permon_tpu.core.extension.SubdomainExtension`, and past
2^19 table slots through that Pallas kernel: a pure gather
y[t] = x[idx[t]] scheduled as SELL rounds of (8, 128) in-register gathers,
with the value multiply and the plane sum left outside the kernel.  The
CUDA kernel (``csrc/gather_apply.cu``) reads the plane-major tables of a
:class:`~permon_tpu_torch.core.extension.GatherTable` directly and fuses
what the call site needs, in ONE launch per table:

    out[r] = sum_{j=0}^{w-1} vals[j, r] * xhat[idx[j, r]],   xhat[n_src] = 0

with the planes added in order (plane 0, then plane 1, ...), and for the
few rows with more entries than the table is wide (the overflow of B')
their overflow planes after that, in entry order, by the thread that owns
the row (an ``ov_mark`` bitmask built on the host tells it so).  It is
bound by bytes; a thread owns 2 or 4 neighbouring rows (8- or 16-byte
loads of planes padded to an aligned stride) and starts all planes' index
and value loads before the first gather of x.

:class:`SEll` / ``sell_mv`` — the port of the TPU SpMV kernel
``permon_tpu/core/sell.py::_sell_mv_pallas``: y = A x for ANY sparsity
pattern, the Hessian product at the bottom of every MPRGP / CG / power
method iteration of the general QP path (``make_operator`` sends every
square matrix with too many diagonals here).  The CUDA kernel
(``csrc/sell_mv.cu``) runs one thread per row and one warp per slice over
a SELL-32 layout (slices of 32 rows, each padded to its own width,
column-major inside the slice) built on the host from scipy CSR.  Bound by
bytes, it walks a slice in chunks of 8 planes, so that a short row is not
a chain of dependent reads: all index and value loads of
the chunk first, then the gathers of x, then the rounded multiplies and
adds in column order, each add predicated on the row's own length.  Besides
the four f32 / f64 pairs of values and x it takes bf16 values (the
``'bf16_mixed'`` policy) with an f32, f64 or bf16 x: 6 bytes a slot.

The SELL round schedule of the TPU is gone in both, on purpose: it exists
only to feed the TPU's register gathers (``_schedule``, the (8, 128)
windows and ``win='auto'``, ``_predicted_rate``, the native
``sell_schedule`` / ``sell_compact``, the padded copy of x that ``_x2d``
makes on every call, the ``SELL_GATHER_MIN_SLOTS`` threshold, the
``enable_x64(False)`` wrapper and the f64 hi/lo float-float split of
``SEllGather.__call__`` for a chip without 64-bit storage).  An H100 has a
fast global gather and IEEE f64.

The module keeps the name ``sell`` so that the counterpart is easy to find.

Dispatch, the same for both: an operator on the CPU goes to the plain
PyTorch version (:func:`gather_apply_plain`, :func:`sell_mv_plain`); an
operator on a CUDA device launches the kernel, or raises.  ``kernel=False``
selects the plain version explicitly (``FetiOptions(gather_kernel=False)``,
``SEll(kernel=False)``).  ``gather_apply.launches`` and ``sell_mv.launches``
count kernel launches.

The launch plan: the first apply of an operator checks the operator's own
tensors (dtype, layout, device, shapes) once and keeps the ctypes function
and its fixed arguments (:class:`LaunchPlan`, cached on the operator
object; ``.replace`` builds a new object and so a new plan).  Every later
call checks only ``x`` (:func:`check_x`), allocates the output, reads the
current stream and launches.  All three sources are built together with
``nvcc`` at first use of any into ``build/permon_tpu_torch/`` and bound
with ctypes.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..sys.tracing import trace
from .linop import LinearOperator

_CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
#: the kernel sources under csrc/; each is one library with a plain C interface
SOURCES = ("gather_apply", "sell_mv", "det_sum")
#: build directory of the kernel libraries (listed in .gitignore)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "permon_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: dtype codes of the kernels' C interface (values and x)
_DTYPE_CODE = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}
#: what the gather kernel takes, values and x alike; and sell_mv's x
#: beside values of these types (bf16 values also take a bf16 x)
FLOAT_DTYPES = (torch.float32, torch.float64)
_libs: dict = {}
#: per source name: what the last build printed (ptxas register/spill
#: report, ``log``) and took (``seconds``)
BUILD_INFO: dict = {}


def _nvcc() -> str:
    exe = shutil.which("nvcc")
    if exe is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        exe = "/usr/local/cuda/bin/nvcc"
    if exe is None:
        raise RuntimeError("nvcc not found: the kernels are built from "
                           "permon_tpu_torch/csrc/*.cu at first use on a CUDA machine")
    return exe


def _lib_path(name: str) -> Path:
    src = (_CSRC_DIR / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libpermon_{name}_{key}.so"


def build_all(names=SOURCES, force: bool = False) -> dict:
    """Compile the named ``csrc/<name>.cu`` sources into the build directory
    (one library each, keyed by the source and flag hash), all ``nvcc``
    processes started together, and return {name: library path}."""
    paths = {name: _lib_path(name) for name in names}
    todo = [name for name in names if force or not paths[name].exists()]
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, t0, procs = _nvcc(), time.perf_counter(), {}
    for name in todo:
        tmp = paths[name].with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_CSRC_DIR / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {name}.cu ({proc.returncode}):\n{err}")
            continue
        os.replace(tmp, paths[name])
        BUILD_INFO[name] = dict(seconds=time.perf_counter() - t0, log=err)
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


class GatherArgs(ctypes.Structure):
    """``struct GatherArgs`` of csrc/gather_apply.cu: what an apply needs of
    the table."""
    _fields_ = ([(n, ctypes.c_void_p) for n in ("idx", "vals", "ov_mark", "ov_idx", "ov_vals")]
                + [(n, ctypes.c_int32) for n in ("vals_dtype", "w", "nrows", "stride", "n_src",
                                                 "wov", "nt")])


class SellArgs(ctypes.Structure):
    """``struct SellArgs`` of csrc/sell_mv.cu: what a product needs of the
    operator."""
    _fields_ = ([(n, ctypes.c_void_p) for n in ("slice_ptr", "row_len", "cols", "vals")]
                + [(n, ctypes.c_int32) for n in ("vals_dtype", "nrows")])


def _load(name: str):
    if name not in _libs:
        lib = ctypes.CDLL(str(build_all()[name]))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        if name == "det_sum":  # (the launch's struct, stream)
            lib.permon_det_sum.argtypes = [vp, vp]
            _libs[name] = lib
            return lib
        # (the operator's struct, x dtype code, x, out, stream)
        getattr(lib, f"permon_{name}").argtypes = [vp, ci, vp, vp, vp]
        if name == "gather_apply":
            lib.permon_gather_apply_v1.argtypes = [ci, ci] + [vp] * 5 + [ci] * 4 + [vp]
        else:
            lib.permon_sell_mv_v1.argtypes = [ci, ci] + [vp] * 6 + [ci, vp]
        _libs[name] = lib
    return _libs[name]


def current_raw_stream(index: int) -> int:
    """The current CUDA stream of device ``index`` as the integer that the
    kernels' C interface takes."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:  # skips the Stream object of the public call
        return raw(index)
    return torch.cuda.current_stream(index).cuda_stream


def check_x(x: torch.Tensor, n: int, device: torch.device, contiguous: bool = True,
            dtypes=FLOAT_DTYPES) -> None:
    """What every call checks of the vector: 1-D of length ``n``, of one of
    the operator's x ``dtypes``, on the operator's ``device``, and (for a
    kernel launch) contiguous."""
    if x.dim() != 1 or x.shape[0] != n:
        raise ValueError(f"x must be a 1-D vector of length {n}, got shape {tuple(x.shape)}")
    if x.dtype not in dtypes:
        raise TypeError(f"x {x.dtype}: this operator takes x in "
                        f"{', '.join(str(d)[6:] for d in dtypes)} only")
    if x.device != device:
        raise ValueError(f"all tensors must be on one device: the operator is on {device}, "
                         f"x on {x.device}")
    if contiguous and not x.is_contiguous():
        raise ValueError("x must be contiguous")


def _one_device(tensors) -> torch.device:
    devs = {name: str(t.device) for name, t in tensors}
    if len(set(devs.values())) != 1:
        raise ValueError(f"all tensors must be on one device, got {devs}")
    return tensors[0][1].device


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


class LaunchPlan:
    """The checked operator, ready to launch: built by the first apply of an
    operator (which runs the checks of the operator's own tensors) and kept
    on it.  ``args`` is the ctypes struct of the operator's pointers and
    sizes that the C entry point ``permon_<source>`` takes (None: nothing to
    launch, the result is 0); ``plain(op, x)`` is the version that an
    operator on the CPU or with ``kernel=False`` takes; ``x_dtypes`` are the
    dtypes of x the operator takes, on either.  The plan holds the
    operator's tensors, never the operator (which holds the plan)."""

    def __init__(self, count, source: str, device: torch.device, n: int, m: int,
                 vals_dtype: torch.dtype, promote: bool, launch: bool, args, plain: Callable,
                 keep: tuple, x_dtypes=FLOAT_DTYPES):
        self.count, self.source = count, source
        self.device, self.n, self.m = device, int(n), int(m)
        self.vals_dtype = vals_dtype
        self.x_dtypes = tuple(x_dtypes)
        #: output dtype by x dtype
        self.out_dtype = {xdt: torch.promote_types(vals_dtype, xdt) if promote else xdt
                          for xdt in self.x_dtypes}
        self.launch, self.plain = bool(launch), plain
        self.args = args
        self.ref = None if args is None else ctypes.byref(args)
        self.keep = keep  # the tensors whose pointers ``args`` holds
        self.fn = None

    def __call__(self, op, x: torch.Tensor) -> torch.Tensor:
        check_x(x, self.n, self.device, contiguous=self.launch, dtypes=self.x_dtypes)
        if not self.launch:
            return self.plain(op, x)
        odt = self.out_dtype[x.dtype]
        out = x.new_empty(self.m) if odt == x.dtype else x.new_empty(self.m, dtype=odt)
        if self.ref is None:
            return out.zero_()
        if self.fn is None:
            self.fn = getattr(_load(self.source), f"permon_{self.source}")
        index = self.device.index
        args = (self.ref, _DTYPE_CODE[x.dtype], x.data_ptr(), out.data_ptr())
        if torch.cuda.current_device() == index:
            err = self.fn(*args, current_raw_stream(index))
        else:
            with torch.cuda.device(index):
                err = self.fn(*args, current_raw_stream(index))
        if err != 0:
            raise RuntimeError(f"{self.source} kernel launch failed: CUDA error {err}")
        self.count.launches += 1
        return out


def _apply(op, make, x: torch.Tensor) -> torch.Tensor:
    """``op`` applied to ``x`` through its launch plan, built by ``make`` at
    the first apply."""
    plan = op.__dict__.get("_plan")
    if plan is None:
        plan = op.__dict__["_plan"] = make(op)
    return plan(op, x)


# ------------------------------------------------------------- gather table


def gather_apply_plain(idx, vals, x, out=None, tgt=None) -> torch.Tensor:
    """The plain PyTorch version: the same planes in the same order, one
    rounded multiply and one rounded add at a time.  With ``tgt`` (unique
    targets) row r adds its planes onto ``out[tgt[r]]`` in place: the
    overflow planes of a table."""
    odt = torch.promote_types(vals.dtype, x.dtype)
    xp = torch.cat([x, x.new_zeros(1)]).to(odt)
    ix = idx.long()
    w = idx.shape[0]
    if tgt is None:
        acc = vals[0].to(odt) * xp[ix[0]]
        j0 = 1
    else:
        acc = out[tgt.long()]
        j0 = 0
    for j in range(j0, w):
        acc = acc + vals[j].to(odt) * xp[ix[j]]
    if tgt is None:
        if out is None:
            return acc
        out.copy_(acc)
        return out
    out[tgt.long()] = acc  # targets are unique: one row per target
    return out


def _table_plain(tab, x: torch.Tensor) -> torch.Tensor:
    out = gather_apply_plain(tab.idx, tab.vals, x)
    if tab.ov_tgt is not None:
        gather_apply_plain(tab.ov_idx, tab.ov_vals, x, out=out, tgt=tab.ov_tgt)
    return out


#: rows per record of a table's overflow marker: one count and 8 masks of
#: 32 rows (csrc/gather_apply.cu; built by extension.overflow_marker)
MARK_GROUP = 256


def plane_stride(t: torch.Tensor) -> int:
    """Entries from one plane of a (w, nrows) table to the next."""
    return int(t.stride(0)) if t.shape[0] > 1 else max(int(t.shape[1]), 1)


def gather_plan(tab) -> LaunchPlan:
    """Check a gather table (``idx``, ``vals``, ``n_src``, ``ov_tgt``,
    ``ov_idx``, ``ov_vals``, ``ov_mark``, ``kernel``: a
    :class:`~permon_tpu_torch.core.extension.GatherTable`) and build its
    launch plan.  ``idx`` (w, nrows) int32 and ``vals`` (w, nrows)
    float32/float64 hold entries in [0, n_src]; their planes are contiguous
    and may be padded to a common stride."""
    idx, vals = tab.idx, tab.vals
    if idx.dim() != 2 or vals.shape != idx.shape:
        raise ValueError(f"idx {tuple(idx.shape)} and vals {tuple(vals.shape)} "
                         "must be equal (w, nrows) plane-major tables")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    if vals.dtype not in FLOAT_DTYPES:
        raise TypeError(f"vals {vals.dtype}: float32 or float64 only")
    w, nrows = idx.shape
    tensors = [("idx", idx), ("vals", vals)]
    stride, wov, nt = plane_stride(idx), 0, 0
    if w and nrows and (idx.stride(1) != 1 or vals.stride(1) != 1 or stride < nrows
                        or plane_stride(vals) != stride):
        raise ValueError("the planes of idx and vals must be contiguous, with one stride")
    if tab.ov_tgt is not None:
        wov, nt = tab.ov_idx.shape
        tensors += [("ov_tgt", tab.ov_tgt), ("ov_idx", tab.ov_idx), ("ov_vals", tab.ov_vals)]
        if (tab.ov_tgt.dtype != torch.int32 or tab.ov_idx.dtype != torch.int32
                or tab.ov_tgt.shape != (nt,) or tab.ov_vals.shape != (wov, nt)
                or tab.ov_vals.dtype != vals.dtype):
            raise ValueError("overflow: ov_tgt (nt,) int32, ov_idx (wov, nt) int32 and "
                             "ov_vals (wov, nt) of the dtype of vals")
    dev = _one_device(tensors)
    launch = dev.type != "cpu" and tab.kernel
    args = None
    if launch:
        if dev.type != "cuda":
            raise ValueError(f"gather_apply runs on cpu or cuda, got {dev}")
        mark = tab.ov_mark
        if tab.ov_tgt is not None:
            if mark is None or mark.dtype != torch.int32 or mark.shape != (
                    (nrows + MARK_GROUP - 1) // MARK_GROUP, 9):
                raise ValueError("overflow: the kernel needs the ov_mark table that "
                                 "GatherTable.from_host builds")
            tensors += [("ov_mark", mark)]
            _one_device(tensors)
            for name, t in tensors[2:]:
                if not t.is_contiguous():
                    raise ValueError(f"{name} must be contiguous")
        if w and nrows:
            args = GatherArgs(
                idx=_ptr(idx), vals=_ptr(vals), ov_mark=_ptr(mark if nt else None),
                ov_idx=_ptr(tab.ov_idx if nt else None),
                ov_vals=_ptr(tab.ov_vals if nt else None), vals_dtype=_DTYPE_CODE[vals.dtype],
                w=w, nrows=nrows, stride=stride, n_src=tab.n_src, wov=wov if nt else 0, nt=nt)
    return LaunchPlan(gather_apply, "gather_apply", dev, tab.n_src, nrows, vals.dtype, True,
                      launch, args, _table_plain, keep=tuple(t for _, t in tensors))


def gather_apply(tab, x: torch.Tensor) -> torch.Tensor:
    """out[r] = sum_j vals[j, r] * xhat[idx[j, r]] (xhat[n_src] = 0), then
    the overflow planes of the rows that have them, for a gather table
    ``tab`` (see :func:`gather_plan`) and a 1-D float32/float64 ``x`` of
    length ``tab.n_src`` on the table's device.  A table on the CPU (or
    ``tab.kernel=False``) uses :func:`gather_apply_plain`; a table on a CUDA
    device launches the kernel, once.  Each call is one span
    ``gather.apply``."""
    with trace("gather.apply"):
        return _apply(tab, gather_plan, x)


#: kernel launches since the last reset (set to 0 to reset)
gather_apply.launches = 0


# --------------------------------------------------------------------- SpMV

#: rows per slice of the SELL layout = lanes of a warp (csrc/sell_mv.cu)
SLICE = 32


@dataclasses.dataclass
class SEll(LinearOperator):
    """Sparse operator for ARBITRARY sparsity (see the module docstring):
    SELL-32 storage, ``mv`` on the CUDA kernel ``csrc/sell_mv.cu``.

    The j-th nonzero (ascending column) of row r sits at slot
    ``slice_ptr[r // 32] + 32 * j + r % 32``; pad slots hold column 0 and
    value 0 and are never added by ``mv`` (each row stops at ``row_len``).
    ``rmv`` needs ``symmetric=True`` (QP Hessians) or a transpose plan
    (``with_transpose=True``); ``kernel=False`` selects the plain PyTorch
    version on any device."""

    slice_ptr: torch.Tensor  # (nslices + 1,) int32 first slot of each slice
    row_len: torch.Tensor  # (m,) int32 nonzeros of each row
    cols: torch.Tensor  # (nslots,) int32
    vals: torch.Tensor  # (nslots,) float32 / float64 / bfloat16
    shape: Tuple[int, int]
    nnz: int = 0
    symmetric: bool = False
    t_plan: Optional["SEll"] = None  # plan of A' for rmv
    kernel: bool = True

    @classmethod
    def from_scipy(cls, a, with_transpose: bool = False, symmetric: bool = False,
                   kernel: bool = True, device=None) -> "SEll":
        """Host CSR -> SELL-32 (numpy calls only, no loop over rows)."""
        import scipy.sparse as sp

        dev = resolve_device(device)
        a = sp.csr_matrix(a, copy=True)
        a.sum_duplicates()
        a.sort_indices()
        if not np.issubdtype(a.dtype, np.floating) or a.dtype.itemsize < 4:
            a = a.astype(np.float64)
        m, n = a.shape
        indptr = a.indptr.astype(np.int64)
        row_len = np.diff(indptr)
        nsl = (m + SLICE - 1) // SLICE
        lens = np.zeros(nsl * SLICE, dtype=np.int64)
        lens[:m] = row_len
        width = lens.reshape(nsl, SLICE).max(axis=1) if nsl else lens[:0]
        slice_ptr = np.concatenate([[0], np.cumsum(width * SLICE)])
        nslots = int(slice_ptr[-1])
        if nslots >= 2**31 or max(m, n) >= 2**31:
            raise ValueError(f"SEll keeps int32 indices: {nslots} slots of a "
                             f"{m} x {n} matrix do not fit")
        rows = np.repeat(np.arange(m, dtype=np.int64), row_len)
        j = np.arange(a.nnz, dtype=np.int64) - indptr[rows]
        slot = slice_ptr[rows // SLICE] + j * SLICE + rows % SLICE
        cols = np.zeros(nslots, dtype=np.int32)
        vals = np.zeros(nslots, dtype=a.dtype)
        cols[slot] = a.indices
        vals[slot] = a.data
        t_plan = None
        if with_transpose and not symmetric:
            t_plan = cls.from_scipy(a.T, kernel=kernel, device=dev)
        return cls(
            slice_ptr=torch.as_tensor(slice_ptr.astype(np.int32), device=dev),
            row_len=torch.as_tensor(row_len.astype(np.int32), device=dev),
            cols=torch.as_tensor(cols, device=dev), vals=torch.as_tensor(vals, device=dev),
            shape=(int(m), int(n)), nnz=int(a.nnz), symmetric=bool(symmetric),
            t_plan=t_plan, kernel=bool(kernel),
        )

    @property
    def nslots(self) -> int:
        return int(self.cols.shape[0])

    def planes(self):
        """(slots, rows, plane_ptr) of the plain version, built once on the
        operator's device: the real slots sorted by their position j within
        the row, so that plane j = ``slots[plane_ptr[j]:plane_ptr[j + 1]]``
        touches each row at most once."""
        cached = getattr(self, "_planes", None)
        if cached is None:
            m = self.shape[0]
            lens = self.row_len.long()
            rows = torch.repeat_interleave(torch.arange(m, device=lens.device), lens)
            start = torch.cumsum(lens, 0) - lens
            j = torch.arange(rows.shape[0], device=lens.device) - start[rows]
            slot = self.slice_ptr.long()[rows // SLICE] + j * SLICE + rows % SLICE
            order = torch.argsort(j, stable=True)
            counts = torch.bincount(j) if j.numel() else j
            plane_ptr = [0] + torch.cumsum(counts, 0).tolist()
            cached = (slot[order], rows[order], plane_ptr)
            self._planes = cached
        return cached

    def mv(self, x):
        return sell_mv(self, x)

    def rmv(self, x):
        if self.symmetric:
            return self.mv(x)
        if self.t_plan is None:
            raise NotImplementedError("SEll.rmv needs with_transpose=True or symmetric=True")
        return self.t_plan.mv(x)

    def todense(self):
        slots, rows, _ = self.planes()
        out = torch.zeros(self.shape, dtype=self.vals.dtype, device=self.vals.device)
        out[rows, self.cols[slots].long()] = self.vals[slots]
        return out


def sell_mv_plain(op: SEll, x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the SpMV kernel: the same products in
    the same order.  Plane j holds the j-th nonzero of every row that has
    one, each row at most once, so a plane is one gather, one rounded
    multiply, one rounded add and a write with unique indices — no
    ``index_add_`` atomics, and bitwise equal to the kernel on the card.
    The values are widened to the dtype of x (exactly, for bf16 values);
    with a bf16 x each multiply and add is PyTorch's bf16 op: computed in
    f32 and rounded to bf16 at once."""
    slots, rows, plane_ptr = op.planes()
    y = torch.zeros(op.shape[0], dtype=x.dtype, device=x.device)
    for j in range(len(plane_ptr) - 1):
        s = slots[plane_ptr[j]: plane_ptr[j + 1]]
        r = rows[plane_ptr[j]: plane_ptr[j + 1]]
        prod = op.vals[s].to(x.dtype) * x[op.cols[s].long()]
        y[r] = prod if j == 0 else y[r] + prod
    return y


def sell_plan(op: SEll) -> LaunchPlan:
    """Check the operator's own tensors and build its launch plan."""
    m, n = op.shape
    if op.vals.dtype not in _DTYPE_CODE:
        raise TypeError(f"vals {op.vals.dtype}: float32, float64 or bfloat16 only")
    # bf16 x only beside bf16 values: the pairs the kernel has
    x_dtypes = FLOAT_DTYPES + ((torch.bfloat16,) if op.vals.dtype == torch.bfloat16 else ())
    tensors = [("slice_ptr", op.slice_ptr), ("row_len", op.row_len), ("cols", op.cols),
               ("vals", op.vals)]
    dev = _one_device(tensors)
    launch = dev.type != "cpu" and op.kernel
    args = None
    if launch:
        if dev.type != "cuda":
            raise ValueError(f"sell_mv runs on cpu or cuda, got {dev}")
        for name, t in tensors:
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
            if name != "vals" and t.dtype != torch.int32:
                raise TypeError(f"{name} must be int32, got {t.dtype}")
        nsl = (m + SLICE - 1) // SLICE
        if (op.row_len.shape != (m,) or op.slice_ptr.shape != (nsl + 1,)
                or op.cols.shape != op.vals.shape or op.cols.dim() != 1):
            raise ValueError("slice_ptr / row_len / cols / vals do not match the operator's "
                             "row count")
        if m:
            args = SellArgs(slice_ptr=_ptr(op.slice_ptr), row_len=_ptr(op.row_len),
                            cols=_ptr(op.cols), vals=_ptr(op.vals),
                            vals_dtype=_DTYPE_CODE[op.vals.dtype], nrows=m)
    return LaunchPlan(sell_mv, "sell_mv", dev, n, m, op.vals.dtype, False, launch, args,
                      sell_mv_plain, keep=tuple(t for _, t in tensors), x_dtypes=x_dtypes)


def sell_mv(op: SEll, x: torch.Tensor) -> torch.Tensor:
    """y = A x in the dtype of ``x`` (the stored values are converted to it)
    for a contiguous 1-D ``x`` on the operator's device: float32 or float64
    beside any values, bfloat16 beside bfloat16 values only (a
    ``TypeError`` otherwise, on every device).  An operator on the CPU (or
    ``op.kernel=False``) uses :func:`sell_mv_plain`; an operator on a CUDA
    device launches the kernel."""
    return _apply(op, sell_plan, x)


#: kernel launches since the last reset (set to 0 to reset)
sell_mv.launches = 0


# ------------------------------------------------------------ timing helper


def kernel_launchers(op, x: torch.Tensor,
                     version: str = "new") -> Tuple[List[Callable], torch.Tensor]:
    """For timing and for holding the replaced kernels against the new ones
    on a card: ``(launchers, out)`` for an :class:`SEll` or a gather table
    ``op`` and a CUDA vector ``x``.  Each launcher is a zero-argument
    callable that launches one kernel into the fixed ``out`` on the stream
    that was current here, with every argument marshalled beforehand, and
    counts no launch.  ``version="v1"`` gives the kernels of the first port
    (``permon_*_v1``; for a table with overflow two launchers, table then
    overflow), which nothing else reaches."""
    spmv = isinstance(op, SEll)
    plan = sell_plan(op) if spmv else gather_plan(op)
    if plan.ref is None:
        raise ValueError("kernel_launchers needs a non-empty operator on a CUDA device "
                         "with kernel=True")
    check_x(x, plan.n, plan.device, dtypes=plan.x_dtypes)
    out = torch.empty(plan.m, dtype=plan.out_dtype[x.dtype], device=plan.device)
    lib = _load(plan.source)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    stream = vp(current_raw_stream(plan.device.index))
    xcode = ci(_DTYPE_CODE[x.dtype])
    codes = (ci(_DTYPE_CODE[plan.vals_dtype]), xcode)
    if version == "new":
        calls = [(getattr(lib, f"permon_{plan.source}"),
                  (plan.ref, xcode, vp(_ptr(x)), vp(_ptr(out)), stream))]
    elif version != "v1":
        raise ValueError(f"version {version!r}: 'new' or 'v1'")
    elif spmv:
        calls = [(lib.permon_sell_mv_v1,
                  codes + tuple(vp(_ptr(t)) for t in (op.slice_ptr, op.row_len, op.cols, op.vals,
                                                      x, out)) + (ci(plan.m), stream))]
    else:
        def v1(idx, vals, tgt):
            return (lib.permon_gather_apply_v1,
                    codes + tuple(vp(_ptr(t)) for t in (idx, vals, x, out, tgt))
                    + (ci(idx.shape[0]), ci(idx.shape[1]), ci(plane_stride(idx)),
                       ci(op.n_src), stream))

        calls = [v1(op.idx, op.vals, None)]
        if op.ov_tgt is not None:
            calls.append(v1(op.ov_idx, op.ov_vals, op.ov_tgt))

    def launcher(fn, args):
        def run():
            err = fn(*args)
            if err != 0:
                raise RuntimeError(f"{version} kernel launch failed: CUDA error {err}")
        run.keep = (plan, x, out)
        return run

    return [launcher(fn, args) for fn, args in calls], out
