"""Parameter transfer from the JAX package's operators to the port's.

``from_arrays(obj, device)`` reads the fields of a ``permon_tpu`` operator
as numpy arrays (``np.asarray(obj.field)``) and builds the port's
counterpart, so tests can hand both sides identical factors and tables.
It dispatches on the class NAME and never imports jax or permon_tpu.

Covered: SubdomainExtension (with its gather tables and overflow COO),
BlockDia, RegularizedBlockDia, BlockTridiag, BandCholInv (with any of
these as its refinement operator), BlockCoarse, Projector (dense factors,
or the band factor with its permutation), Dense / DenseTree, Ell, Dia,
SEll (decoded from its round plan), VStack,
Penalized, OneRow, PCDual, BoxConstraint, QP (with BI / cI) and the options
objects SMALXEOptions / MPRGPOptions (field by field).
"""

from __future__ import annotations

import numpy as np
import torch

from . import not_ported, resolve_device
from .core.band import BandCholInv, BlockTridiag
from .core.dia import BlockDia, Dia, RegularizedBlockDia
from .core.extension import GatherTable, SubdomainExtension
from .core.linop import Dense, DenseTree, Ell, OneRow, Penalized, VStack
from .core.sell import SEll
from .feti.large import BlockCoarse
from .pc.dual import PCDual
from .qp.projector import Projector
from .qp.qp import QP
from .qpc.box import BoxConstraint
from .solvers.mprgp import MPRGPOptions
from .solvers.smalxe import SMALXEOptions


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


def blocktridiag_from_arrays(obj, device=None) -> BlockTridiag:
    dev = resolve_device(device)
    return BlockTridiag(Ad=_t(obj.Ad, dev), Asub=_t(obj.Asub, dev),
                        shape=tuple(int(s) for s in obj.shape))


def blockcoarse_from_arrays(obj, device=None) -> BlockCoarse:
    dev = resolve_device(device)
    return BlockCoarse(Rb=_t(obj.Rb, dev), cols=_t(obj.cols, dev, torch.int64),
                       B=from_arrays(obj.B, dev), k=int(obj.k))


def bandcholinv_from_arrays(obj, device=None) -> BandCholInv:
    dev = resolve_device(device)
    op = None if obj.op is None else from_arrays(obj.op, dev)
    return BandCholInv(Dinv=_t(obj.Dinv, dev), F=_t(obj.F, dev),
                       shape=tuple(int(s) for s in obj.shape), op=op,
                       refine=int(obj.refine))


def projector_from_arrays(obj, device=None) -> Projector:
    """Port a JAX Projector: dense factors (Cholesky and/or explicit
    inverse) or the band factor of GG' with its RCM permutation."""
    dev = resolve_device(device)
    if getattr(obj, "cp_dist", None) is not None:
        raise not_ported("the distributed coarse factor (cp_dist) of Projector")
    return Projector(
        G=from_arrays(obj.G, dev),
        ggt_chol=None if obj.ggt_chol is None else _t(obj.ggt_chol, dev),
        orthonormal_rows=bool(obj.orthonormal_rows),
        ggt_inv=None if obj.ggt_inv is None else _t(obj.ggt_inv, dev),
        ggt_band=None if obj.ggt_band is None else from_arrays(obj.ggt_band, dev),
        cp_perm=None if obj.cp_perm is None else _t(obj.cp_perm, dev, torch.int64),
    )


def dense_from_arrays(obj, device=None) -> Dense:
    dev = resolve_device(device)
    cls = DenseTree if type(obj).__name__ == "DenseTree" else Dense
    return cls.create(_t(obj.a, dev))


def ell_from_arrays(obj, device=None) -> Ell:
    return Ell.from_arrays(np.asarray(obj.cols), np.asarray(obj.vals), obj.shape,
                           device=device)


def dia_from_arrays(obj, device=None) -> Dia:
    dev = resolve_device(device)
    return Dia(data=_t(obj.data, dev), offsets=tuple(int(o) for o in obj.offsets),
               shape=tuple(int(s) for s in obj.shape))


def sell_round_plan_to_csr(obj):
    """Decode the round plan of a JAX SEll back to scipy CSR.  A JAX SEll
    holds only its plan: for round k and slot (i, j) with V[k, i, j] != 0
    the row is tid[k]*1024 + i*128 + j, the lane code c = SC[k, i, j] & 127,
    the sublane code s = SC[k, i, c] >> 7 (it sits at the LANE position) and
    the column (wstart[k] + s)*128 + c."""
    import scipy.sparse as sp

    V = np.asarray(obj.V)
    nr = V.shape[0]
    SC = np.asarray(obj.SC).astype(np.int64).reshape(nr, 8, 128)
    k, i, j = np.nonzero(V)
    c = SC[k, i, j] & 127
    s = SC[k, i, c] >> 7
    rows = np.asarray(obj.tid).astype(np.int64)[k] * 1024 + i * 128 + j
    cols = (np.asarray(obj.wstart).astype(np.int64)[k] + s) * 128 + c
    a = sp.csr_matrix((V[k, i, j], (rows, cols)), shape=tuple(int(d) for d in obj.shape))
    a.sort_indices()
    return a


def sell_from_arrays(obj, device=None) -> SEll:
    """Port a JAX SEll: its matrix decoded from the round plan, stored anew
    in the port's SELL-32 layout (the round plan itself is not carried)."""
    symmetric = bool(obj.symmetric)
    return SEll.from_scipy(sell_round_plan_to_csr(obj), symmetric=symmetric,
                           with_transpose=obj.t_plan is not None, device=device)


def vstack_from_arrays(obj, device=None) -> VStack:
    return VStack(tuple(from_arrays(op, device) for op in obj.ops))


def penalized_from_arrays(obj, device=None) -> Penalized:
    dev = resolve_device(device)
    return Penalized(a=from_arrays(obj.a, dev), b=from_arrays(obj.b, dev), rho=_t(obj.rho, dev))


def onerow_from_arrays(obj, device=None) -> OneRow:
    return OneRow(v=_t(obj.v, resolve_device(device)))


def pcdual_from_arrays(obj, device=None) -> PCDual:
    return PCDual.create(from_arrays(obj.B, device),
                         None if obj.K is None else from_arrays(obj.K, device), obj.pc_type)


def _options_from_fields(cls, obj, **converted):
    """An options dataclass of the port from the JAX package's, field by
    field; a field the port does not have raises."""
    import dataclasses

    theirs = {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}
    ours = {f.name for f in dataclasses.fields(cls)}
    if set(theirs) - ours:
        raise not_ported(f"{cls.__name__} fields {sorted(set(theirs) - ours)}")
    theirs.update(converted)
    return cls(**theirs)


def mprgp_options_from_arrays(obj, device=None) -> MPRGPOptions:
    return _options_from_fields(MPRGPOptions, obj)


def smalxe_options_from_arrays(obj, device=None) -> SMALXEOptions:
    maxeig_inner = None if obj.maxeig_inner is None else float(np.asarray(obj.maxeig_inner))
    return _options_from_fields(SMALXEOptions, obj, inner=mprgp_options_from_arrays(obj.inner),
                                maxeig_inner=maxeig_inner)


def box_from_arrays(obj, device=None) -> BoxConstraint:
    dev = resolve_device(device)
    return BoxConstraint(lb=_t(obj.lb, dev), ub=_t(obj.ub, dev), astol=float(obj.astol),
                         has_lb=bool(obj.has_lb), has_ub=bool(obj.has_ub))


def qp_from_arrays(obj, device=None) -> QP:
    dev = resolve_device(device)

    def op(o):
        return None if o is None else from_arrays(o, dev)

    def vec(v):
        return None if v is None else _t(v, dev)

    return QP(A=op(obj.A), b=vec(obj.b), x0=vec(obj.x0), box=op(obj.box), BE=op(obj.BE),
              cE=vec(obj.cE), BI=op(obj.BI), cI=vec(obj.cI), R=op(obj.R), pf=op(obj.pf),
              dots_dtype=obj.dots_dtype)


_BY_NAME = {
    "SubdomainExtension": extension_from_arrays,
    "BlockDia": blockdia_from_arrays,
    "RegularizedBlockDia": regularized_from_arrays,
    "BlockTridiag": blocktridiag_from_arrays,
    "BandCholInv": bandcholinv_from_arrays,
    "BlockCoarse": blockcoarse_from_arrays,
    "Projector": projector_from_arrays,
    "Dense": dense_from_arrays,
    "DenseTree": dense_from_arrays,
    "Ell": ell_from_arrays,
    "Dia": dia_from_arrays,
    "SEll": sell_from_arrays,
    "BoxConstraint": box_from_arrays,
    "VStack": vstack_from_arrays,
    "Penalized": penalized_from_arrays,
    "OneRow": onerow_from_arrays,
    "PCDual": pcdual_from_arrays,
    "SMALXEOptions": smalxe_options_from_arrays,
    "MPRGPOptions": mprgp_options_from_arrays,
    "QP": qp_from_arrays,
}


def from_arrays(obj, device=None):
    """The port's counterpart of a JAX package operator, built from its
    fields read as numpy arrays."""
    fn = _BY_NAME.get(type(obj).__name__)
    if fn is None:
        raise not_ported(f"interop for {type(obj).__name__}")
    return fn(obj, device)
