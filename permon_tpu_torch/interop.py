"""Parameter transfer from the JAX package's operators to the port's.

``from_arrays(obj, device)`` reads the fields of a ``permon_tpu`` operator
as numpy arrays (``np.asarray(obj.field)``) and builds the port's
counterpart, so tests can hand both sides identical factors and tables.
It dispatches on the class NAME and never imports jax or permon_tpu.

Covered: SubdomainExtension (with its gather tables and overflow COO),
BlockDia, RegularizedBlockDia, BandCholInv, Projector (dense factors),
Dense / DenseTree and Ell.
"""

from __future__ import annotations

import numpy as np
import torch

from . import not_ported, resolve_device
from .core.band import BandCholInv
from .core.dia import BlockDia, RegularizedBlockDia
from .core.extension import GatherTable, SubdomainExtension
from .core.linop import Dense, DenseTree, Ell
from .qp.projector import Projector


def _t(a, dev, dtype=None):
    return torch.tensor(np.asarray(a), device=dev, dtype=dtype)


def extension_from_arrays(obj, device=None) -> SubdomainExtension:
    """Port a JAX SubdomainExtension; its plane-major gather tables are
    taken as they are, the overflow COO sorted by target into planes."""
    dev = resolve_device(device)
    out = SubdomainExtension(
        rows=np.asarray(obj.rows), cols=np.asarray(obj.cols), vals=np.asarray(obj.vals),
        m_dual=int(obj.m_dual), ns=int(obj.ns), nl=int(obj.nl),
    )
    if obj.gB_cols is None:
        return out
    ov = None
    if obj.gBt_ov_cols is not None:
        ov = (np.asarray(obj.gBt_ov_cols), np.asarray(obj.gBt_ov_rows),
              np.asarray(obj.gBt_ov_vals))
    return out.replace(
        gB=GatherTable.from_host(np.asarray(obj.gB_cols), np.asarray(obj.gB_vals), dev,
                                 n_src=int(obj.ns) * int(obj.nl)),
        gBt=GatherTable.from_host(np.asarray(obj.gBt_rows), np.asarray(obj.gBt_vals), dev,
                                  n_src=int(obj.m_dual), overflow=ov),
    )


def blockdia_from_arrays(obj, device=None) -> BlockDia:
    dev = resolve_device(device)
    return BlockDia(data=_t(obj.data, dev), offsets=tuple(int(o) for o in obj.offsets),
                    shape=tuple(int(s) for s in obj.shape))


def regularized_from_arrays(obj, device=None) -> RegularizedBlockDia:
    dev = resolve_device(device)
    return RegularizedBlockDia(
        base=blockdia_from_arrays(obj.base, dev), idx=_t(obj.idx, dev, torch.int64),
        q=_t(obj.q, dev), bi=_t(obj.bi, dev, torch.int64), NB=int(obj.NB),
    )


def bandcholinv_from_arrays(obj, device=None) -> BandCholInv:
    dev = resolve_device(device)
    op = None if obj.op is None else from_arrays(obj.op, dev)
    return BandCholInv(Dinv=_t(obj.Dinv, dev), F=_t(obj.F, dev),
                       shape=tuple(int(s) for s in obj.shape), op=op,
                       refine=int(obj.refine))


def projector_from_arrays(obj, device=None) -> Projector:
    """Port a dense-factor JAX Projector (Cholesky and/or explicit inverse)."""
    dev = resolve_device(device)
    if getattr(obj, "ggt_band", None) is not None or getattr(obj, "cp_dist", None) is not None:
        raise not_ported("the band / distributed coarse factors of Projector")
    return Projector(
        G=from_arrays(obj.G, dev),
        ggt_chol=None if obj.ggt_chol is None else _t(obj.ggt_chol, dev),
        orthonormal_rows=bool(obj.orthonormal_rows),
        ggt_inv=None if obj.ggt_inv is None else _t(obj.ggt_inv, dev),
    )


def dense_from_arrays(obj, device=None) -> Dense:
    dev = resolve_device(device)
    cls = DenseTree if type(obj).__name__ == "DenseTree" else Dense
    return cls.create(_t(obj.a, dev))


def ell_from_arrays(obj, device=None) -> Ell:
    return Ell.from_arrays(np.asarray(obj.cols), np.asarray(obj.vals), obj.shape,
                           device=device)


_BY_NAME = {
    "SubdomainExtension": extension_from_arrays,
    "BlockDia": blockdia_from_arrays,
    "RegularizedBlockDia": regularized_from_arrays,
    "BandCholInv": bandcholinv_from_arrays,
    "Projector": projector_from_arrays,
    "Dense": dense_from_arrays,
    "DenseTree": dense_from_arrays,
    "Ell": ell_from_arrays,
}


def from_arrays(obj, device=None):
    """The port's counterpart of a JAX package operator, built from its
    fields read as numpy arrays."""
    fn = _BY_NAME.get(type(obj).__name__)
    if fn is None:
        raise not_ported(f"interop for {type(obj).__name__}")
    return fn(obj, device)
