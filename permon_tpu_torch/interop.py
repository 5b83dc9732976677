"""Parameter transfer from the JAX package's operators to the port's.

``from_arrays(obj, device)`` reads the fields of a ``permon_tpu`` operator
as numpy arrays (``np.asarray(obj.field)``) and builds the port's
counterpart, so tests can hand both sides identical factors and tables.
It dispatches on the class NAME and never imports jax or permon_tpu.

Covered: SubdomainExtension (with its gather tables and overflow COO),
BlockDia, RegularizedBlockDia, BlockTridiag, BandCholInv (with any of
these as its refinement operator), BlockCoarse, Projector (dense factors,
the band factor with its permutation, or the redundancy-group factor
``cp_dist`` onto a port mesh), Dense / DenseTree, Ell, Dia,
SEll (decoded from its round plan), VStack,
Penalized, OneRow, PCDual, BoxConstraint, QP (with BI / cI), the options
objects SMALXEOptions / MPRGPOptions (field by field), the factorized
inverses CholInv / BlockDiagCholInv / RaggedBlockDiagCholInv /
IterativeInv, the precision wrappers CastTo / MixedPrecision,
TAOResult, and the dense TFETI path's BlockDiagDense, BlockColumns,
Gluing, MatIS (with their gather tables built anew), BandOrthT, Solution
and FetiProblem (a host dataclass: its arrays as they are), and the leaf
path's LeafDualSpace (its partners and weights as they are, the combine /
restrict / lift tables built from them), LeafDualOperator, LeafProjector,
ScaledLeafSpace and LeafG.  bf16 arrays (numpy has no bf16: JAX hands out ml_dtypes
arrays) cross through float32, which holds every bf16 value exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from . import not_ported, resolve_device
from .core.band import BandCholInv, BlockTridiag
from .core.blockdiag import BlockColumns, BlockDiagDense
from .core.gluing import Gluing
from .core.dia import BlockDia, Dia, RegularizedBlockDia
from .core.factor import BlockDiagCholInv, CholInv, IterativeInv, RaggedBlockDiagCholInv
from .core.extension import GatherTable, SubdomainExtension
from .core.linop import Dense, DenseTree, Ell, OneRow, Penalized, VStack
from .core.precision import CastTo, MixedPrecision, cast_floats
from .core.sell import SEll
from .feti.assembly import FetiProblem
from .feti.large import BlockCoarse
from .feti.leaf import LeafDualOperator, LeafDualSpace, LeafProjector
from .feti.leafqp import LeafG, ScaledLeafSpace
from .feti.matis import MatIS
from .pc.dual import PCDual
from .qp.projector import Projector
from .qp.orth import BandOrthT
from .qp.qp import QP
from .qp.transforms import Solution
from .qpc.box import BoxConstraint
from .solvers.mprgp import MPRGPOptions
from .solvers.smalxe import SMALXEOptions
from .solvers.tao import TAOResult


def _is_bf16(a) -> bool:
    return getattr(getattr(a, "dtype", None), "name", None) == "bfloat16"


def _t(a, dev, dtype=None):
    if _is_bf16(a):  # through float32, exactly
        return torch.tensor(np.asarray(a).astype(np.float32), device=dev).to(
            dtype or torch.bfloat16)
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


def projector_from_arrays(obj, device=None, mesh=None) -> Projector:
    """Port a JAX Projector: dense factors (Cholesky and/or explicit
    inverse), the band factor of GG' with its RCM permutation, or a
    redundancy-group factor ``cp_dist``, which becomes a
    :class:`~permon_tpu_torch.parallel.coarse.RedundantCoarse` on ``mesh``
    (a port mesh: its group axis is the JAX factor's axis if it has one,
    else its last) from the whole factor L of the JAX mesh."""
    dev = resolve_device(device)
    cp = getattr(obj, "cp_dist", None)
    if cp is not None:
        if mesh is None:
            raise ValueError("a Projector with a redundancy-group factor (cp_dist) ports "
                             "onto a permon_tpu_torch.parallel mesh: pass mesh=")
        from .parallel.coarse import RedundantCoarse

        axis = cp.axis if cp.axis in mesh.axis_names else mesh.axis_names[-1]
        cp = RedundantCoarse.from_factor(np.asarray(cp.L), int(cp.kc), mesh, axis, device=dev)
    return Projector(
        G=from_arrays(obj.G, dev),
        ggt_chol=None if obj.ggt_chol is None else _t(obj.ggt_chol, dev),
        orthonormal_rows=bool(obj.orthonormal_rows),
        ggt_inv=None if obj.ggt_inv is None else _t(obj.ggt_inv, dev),
        ggt_band=None if obj.ggt_band is None else from_arrays(obj.ggt_band, dev),
        cp_perm=None if obj.cp_perm is None else _t(obj.cp_perm, dev, torch.int64),
        cp_dist=cp,
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
    in the port's SELL-32 layout (the round plan itself is not carried);
    bf16 values are decoded in float32 and stored back in bf16."""
    bf16 = _is_bf16(obj.V)
    if bf16:
        obj = obj.replace(V=np.asarray(obj.V).astype(np.float32))
    op = SEll.from_scipy(sell_round_plan_to_csr(obj), symmetric=bool(obj.symmetric),
                         with_transpose=obj.t_plan is not None, device=device)
    return cast_floats(op, torch.bfloat16) if bf16 else op


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


def cholinv_from_arrays(obj, device=None) -> CholInv:
    return CholInv(chol=_t(obj.chol, resolve_device(device)),
                   shape=tuple(int(s) for s in obj.shape))


def blockdiagcholinv_from_arrays(obj, device=None) -> BlockDiagCholInv:
    dev = resolve_device(device)
    return BlockDiagCholInv(chols=_t(obj.chols, dev), shape=tuple(int(s) for s in obj.shape),
                            invs=None if obj.invs is None else _t(obj.invs, dev))


def raggedcholinv_from_arrays(obj, device=None) -> RaggedBlockDiagCholInv:
    dev = resolve_device(device)
    return RaggedBlockDiagCholInv(
        buckets=tuple((_t(idx, dev, torch.int64), _t(ch, dev), None if iv is None else _t(iv, dev))
                      for idx, ch, iv in obj.buckets),
        ns=int(obj.ns), nl=int(obj.nl))


def iterativeinv_from_arrays(obj, device=None) -> IterativeInv:
    return IterativeInv(a=from_arrays(obj.a, device), rtol=float(obj.rtol),
                        max_it=int(obj.max_it))


def castto_from_arrays(obj, device=None) -> CastTo:
    return CastTo(inner=from_arrays(obj.inner, device), dtype=str(np.dtype(obj.dtype)))


def mixed_from_arrays(obj, device=None) -> MixedPrecision:
    return MixedPrecision(inner=from_arrays(obj.inner, device))


def taoresult_from_arrays(obj, device=None) -> TAOResult:
    return TAOResult(x=_t(obj.x, resolve_device(device)), reason=int(obj.reason),
                     iterations=int(obj.iterations), rnorm=float(obj.rnorm), nmv=int(obj.nmv),
                     ksp_its=int(obj.ksp_its), pg_its=int(obj.pg_its),
                     objective=float(obj.objective))


def qp_from_arrays(obj, device=None) -> QP:
    dev = resolve_device(device)

    def op(o):
        return None if o is None else from_arrays(o, dev)

    def vec(v):
        return None if v is None else _t(v, dev)

    return QP(A=op(obj.A), b=vec(obj.b), x0=vec(obj.x0), box=op(obj.box), BE=op(obj.BE),
              cE=vec(obj.cE), BI=op(obj.BI), cI=vec(obj.cI), R=op(obj.R), pf=op(obj.pf),
              dots_dtype=obj.dots_dtype)


def blockdiag_from_arrays(obj, device=None) -> BlockDiagDense:
    return BlockDiagDense(blocks=_t(obj.blocks, resolve_device(device)))


def blockcolumns_from_arrays(obj, device=None) -> BlockColumns:
    return BlockColumns(blocks=_t(obj.blocks, resolve_device(device)))


def gluing_from_arrays(obj, device=None) -> Gluing:
    return Gluing.from_coo(np.asarray(obj.lams), np.asarray(obj.dofs), np.asarray(obj.vals),
                           int(obj.m_dual), int(obj.n_primal), device=device)


def matis_from_arrays(obj, device=None) -> MatIS:
    return MatIS.create(np.asarray(obj.blocks), np.asarray(obj.l2g), int(obj.n_global),
                        device=device)


def bandortht_from_arrays(obj, device=None) -> BandOrthT:
    return BandOrthT(band=from_arrays(obj.band, device),
                     perm=_t(obj.perm, resolve_device(device), torch.int64),
                     m_rows=int(obj.m_rows))


def solution_from_arrays(obj, device=None) -> Solution:
    dev = resolve_device(device)
    return Solution(**{f: None if getattr(obj, f) is None else _t(getattr(obj, f), dev)
                       for f in ("x", "lambda_E", "lambda_I", "Bt_lambda", "g")})


def leafspace_from_arrays(obj, device=None) -> LeafDualSpace:
    """The partners and weights as they are; the combine / restrict / lift
    tables built from them."""
    return LeafDualSpace.from_partners(np.asarray(obj.rows), np.asarray(obj.partners),
                                       np.asarray(obj.weights), int(obj.m_dual), device)


def leafop_from_arrays(obj, device=None) -> LeafDualOperator:
    dev = resolve_device(device)
    return LeafDualOperator(blk=_t(obj.blk, dev), invs=_t(obj.invs, dev),
                            space=leafspace_from_arrays(obj.space, dev))


def leafprojector_from_arrays(obj, device=None) -> LeafProjector:
    dev = resolve_device(device)
    Gl, weights = _t(obj.Gl, dev), _t(obj.weights, dev)
    return LeafProjector(Gl=Gl, chol=_t(obj.chol, dev), weights=weights, Glw=Gl * weights)


def scaledleafspace_from_arrays(obj, device=None) -> ScaledLeafSpace:
    dev = resolve_device(device)
    return ScaledLeafSpace(space=leafspace_from_arrays(obj.space, dev), s=_t(obj.s, dev),
                           si=_t(obj.si, dev))


def leafg_from_arrays(obj, device=None) -> LeafG:
    dev = resolve_device(device)
    return LeafG(Gl=_t(obj.Gl, dev), sp=scaledleafspace_from_arrays(obj.sp, dev))


def feti_problem_from_arrays(obj, device=None) -> FetiProblem:
    """The JAX package's FetiProblem as the port's (host arrays both)."""
    import dataclasses

    return FetiProblem(**{f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)})


_BY_NAME = {
    "BlockDiagDense": blockdiag_from_arrays,
    "BlockColumns": blockcolumns_from_arrays,
    "Gluing": gluing_from_arrays,
    "MatIS": matis_from_arrays,
    "BandOrthT": bandortht_from_arrays,
    "Solution": solution_from_arrays,
    "FetiProblem": feti_problem_from_arrays,
    "LeafDualSpace": leafspace_from_arrays,
    "LeafDualOperator": leafop_from_arrays,
    "LeafProjector": leafprojector_from_arrays,
    "ScaledLeafSpace": scaledleafspace_from_arrays,
    "LeafG": leafg_from_arrays,
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
    "CholInv": cholinv_from_arrays,
    "BlockDiagCholInv": blockdiagcholinv_from_arrays,
    "RaggedBlockDiagCholInv": raggedcholinv_from_arrays,
    "IterativeInv": iterativeinv_from_arrays,
    "CastTo": castto_from_arrays,
    "MixedPrecision": mixed_from_arrays,
    "TAOResult": taoresult_from_arrays,
}


def from_arrays(obj, device=None, mesh=None):
    """The port's counterpart of a JAX package operator, built from its
    fields read as numpy arrays.  ``mesh`` (a port mesh) receives a
    Projector's redundancy-group coarse factor."""
    fn = _BY_NAME.get(type(obj).__name__)
    if fn is None:
        raise not_ported(f"interop for {type(obj).__name__}")
    if fn is projector_from_arrays:
        return fn(obj, device, mesh=mesh)
    return fn(obj, device)
