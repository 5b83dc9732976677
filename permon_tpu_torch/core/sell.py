"""``gather_apply`` — the Hopper port of the TPU gather kernel B1.

The JAX package runs every B u and B'lambda of the large path through the
plane-major gather tables of :class:`~permon_tpu.core.extension.
SubdomainExtension`, and past 2^19 table slots through the Pallas kernel
``permon_tpu/core/sell.py::_sell_gather_pallas``: a pure gather
y[t] = x[idx[t]] scheduled as SELL rounds of (8, 128) in-register gathers,
with the value multiply and the plane sum left outside the kernel.

The SELL schedule is gone here, on purpose: it exists only to feed the
TPU's register gathers (``_schedule``, the native ``sell_schedule`` /
``sell_compact``, the ``SELL_GATHER_MIN_SLOTS`` threshold that priced the
schedule, and the f64 hi/lo float-float split of ``SEllGather.__call__``
for a chip without 64-bit storage).  An H100 has a fast global gather and
IEEE f64, so the CUDA kernel (``csrc/gather_apply.cu``) reads the
plane-major tables directly and fuses what the call site needs:

    out[r] = sum_{j=0}^{w-1} vals[j, r] * xhat[idx[j, r]],   xhat[n_src] = 0

with the planes added in order (plane 0, then plane 1, ...).  With
``tgt`` given, row r instead adds its planes onto ``out[tgt[r]]`` (the
overflow COO of B', sorted by target on the host: each target owned by one
row, so no atomics).

The module keeps the name ``sell`` so that the counterpart is easy to find.

Dispatch: a CPU tensor goes to the plain PyTorch version
(:func:`gather_apply_plain`); a CUDA tensor launches the kernel, or raises.
``kernel=False`` selects the plain version explicitly (the
``FetiOptions(gather_kernel=False)`` path).  ``gather_apply.launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

import torch

_CSRC = Path(__file__).resolve().parent.parent / "csrc" / "gather_apply.cu"
#: build directory of the kernel library (listed in .gitignore)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "permon_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}
_lib = None
#: what the last build printed (ptxas register/spill report) and took
BUILD_INFO: dict = {}


def _nvcc() -> str:
    exe = shutil.which("nvcc")
    if exe is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        exe = "/usr/local/cuda/bin/nvcc"
    if exe is None:
        raise RuntimeError("nvcc not found: the gather_apply kernel is built "
                           "from csrc/gather_apply.cu at first use on a CUDA machine")
    return exe


def build(force: bool = False) -> Path:
    """Compile ``csrc/gather_apply.cu`` into the build directory (keyed by
    the source and flag hash) and return the library path."""
    src = _CSRC.read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libpermon_gather_{key}.so"
    if out.exists() and not force:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    BUILD_INFO.update(seconds=time.perf_counter() - t0, log=proc.stderr)
    return out


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.permon_gather_apply
        fn.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 5 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def out_dtype(vals: torch.Tensor, x: torch.Tensor) -> torch.dtype:
    """Output dtype: the promotion of the table values and the vector."""
    return torch.promote_types(vals.dtype, x.dtype)


def _check(idx, vals, x, out, tgt):
    if idx.dim() != 2 or vals.shape != idx.shape:
        raise ValueError(f"idx {tuple(idx.shape)} and vals {tuple(vals.shape)} "
                         "must be equal (w, nrows) plane-major tables")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    if tgt is not None and (tgt.dtype != torch.int32 or tgt.shape != idx.shape[1:]):
        raise ValueError("tgt must be an int32 (nrows,) tensor")
    if vals.dtype not in _DTYPE_CODE or x.dtype not in _DTYPE_CODE:
        raise TypeError(f"vals {vals.dtype} / x {x.dtype}: float32 or float64 only")
    if x.dim() != 1:
        raise ValueError(f"x must be 1-D, got shape {tuple(x.shape)}")
    if tgt is not None and out is None:
        raise ValueError("accumulate mode (tgt) needs out")
    if out is not None and (out.dim() != 1 or out.dtype != out_dtype(vals, x)):
        raise ValueError(f"out must be a 1-D {out_dtype(vals, x)} tensor")
    if out is not None and tgt is None and out.shape[0] != idx.shape[1]:
        raise ValueError("out length must equal the table's row count")
    devs = {t.device for t in (idx, vals, x, out, tgt) if t is not None}
    if len(devs) != 1:
        raise ValueError(f"all tensors must be on one device, got {devs}")


def gather_apply_plain(idx, vals, x, out=None, tgt=None) -> torch.Tensor:
    """The plain PyTorch version: the same planes in the same order, one
    rounded multiply and one rounded add at a time."""
    odt = out_dtype(vals, x)
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


def gather_apply(idx: torch.Tensor, vals: torch.Tensor, x: torch.Tensor,
                 out: Optional[torch.Tensor] = None,
                 tgt: Optional[torch.Tensor] = None,
                 kernel: bool = True) -> torch.Tensor:
    """out[r] = sum_j vals[j, r] * xhat[idx[j, r]] (xhat[len(x)] = 0).

    ``idx`` (w, nrows) int32 and ``vals`` (w, nrows) float32/float64 are
    contiguous plane-major tables with entries in [0, len(x)]; ``x`` is a
    contiguous 1-D float32/float64 vector.  With ``tgt`` (nrows,) int32 of
    UNIQUE targets, row r adds onto ``out[tgt[r]]`` in place.  CPU tensors
    (or ``kernel=False``) use :func:`gather_apply_plain`; CUDA tensors
    launch the kernel."""
    _check(idx, vals, x, out, tgt)
    dev = x.device
    if dev.type == "cpu" or not kernel:
        return gather_apply_plain(idx, vals, x, out=out, tgt=tgt)
    if dev.type != "cuda":
        raise ValueError(f"gather_apply runs on cpu or cuda, got {dev}")
    for name, t in (("idx", idx), ("vals", vals), ("x", x), ("out", out), ("tgt", tgt)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    w, nrows = idx.shape
    if out is None:
        out = torch.empty(nrows, dtype=out_dtype(vals, x), device=dev)
    if nrows == 0 or w == 0:
        if tgt is None:
            out.zero_()
        return out
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.permon_gather_apply(
            _DTYPE_CODE[vals.dtype], _DTYPE_CODE[x.dtype],
            idx.data_ptr(), vals.data_ptr(), x.data_ptr(), out.data_ptr(),
            None if tgt is None else tgt.data_ptr(),
            int(w), int(nrows), int(x.shape[0]), stream)
    if err != 0:
        raise RuntimeError(f"gather_apply kernel launch failed: CUDA error {err}")
    gather_apply.launches += 1
    return out


#: kernel launches since the last reset (set to 0 to reset)
gather_apply.launches = 0
