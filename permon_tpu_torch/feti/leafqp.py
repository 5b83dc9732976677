"""Scaled-leaf dual space — the port of :mod:`permon_tpu.feti.leafqp`: the
leaf-space dual iteration opened to every solver (contact SMALXE / MPRGP,
lumped-PC projected CG, plain projected CG).

A dual (row-space) vector x is represented by the flat leaf array

    xt[l] = sqrt(w_l) * x[row(l)],    w_l = 1/deg(row(l))  (0 at pads),

an isometry: the Euclidean dot of two scaled-leaf vectors equals the
row-space dot, componentwise operations act on deg identical copies of a
row (so box projections and gradient splits decide as in row space), and
every operator conjugated with S = diag(sqrt(w)), A_leaf = S (leaf apply)
S+, is symmetric.  So the standard solvers, Projector, BoxConstraint and
dual preconditioners run unchanged on scaled-leaf vectors, with the
recurrence coefficients of row space, while each F apply is the leaf apply
of :mod:`permon_tpu_torch.feti.leaf` (batched products and the partner
combine on the gather kernel).

``leaf_dual_qp(mesh=...)`` runs the F apply as the overlapped boundary
exchange of :mod:`permon_tpu_torch.parallel.overlap` over the mesh's ranks.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from .. import Struct
from ..core.linop import LinearOperator
from ..qp.projector import dense_rows
from ..qp.qp import QP
from ..qpc.box import BoxConstraint
from .leaf import LeafDualOperator, LeafDualSpace, check_full_precision


@dataclasses.dataclass
class ScaledLeafSpace(Struct):
    """The isometry between the m-dim dual row space and flat scaled-leaf
    vectors (leafqp.py:51-89)."""

    space: LeafDualSpace
    s: torch.Tensor  # (ns, k) sqrt(weights); 0 at pad slots
    si: torch.Tensor  # (ns, k) 1/s at real slots, 0 at pads

    @classmethod
    def create(cls, space: LeafDualSpace) -> "ScaledLeafSpace":
        w = space.weights
        s = torch.sqrt(w)
        si = torch.where(w > 0, 1.0 / torch.clamp(s, min=1e-300), torch.zeros_like(s))
        return cls(space=space, s=s, si=si)

    @property
    def nleaf(self) -> int:
        return int(self.s.numel())

    def lift(self, x: torch.Tensor) -> torch.Tensor:
        """Row-space (m,) -> flat scaled-leaf (nleaf,)."""
        return (self.space.lift(x) * self.s.to(x.dtype)).reshape(-1)

    def restrict(self, xt: torch.Tensor) -> torch.Tensor:
        """Flat scaled-leaf -> row-space (m,) (exact on consistent input)."""
        return self.space.restrict(xt.reshape(self.s.shape) * self.si.to(xt.dtype))

    def lift_bound(self, bound: torch.Tensor, fill: float) -> torch.Tensor:
        """Lift a bound vector: pad slots get ``fill`` (+-inf) so they stay
        inactive; +-inf entries stay +-inf (s > 0 at real slots)."""
        lifted = self.space.lift(bound) * self.s.to(bound.dtype)
        pad = self.space.weights <= 0
        return torch.where(pad, torch.full_like(lifted, fill), lifted).reshape(-1)


@dataclasses.dataclass
class ScaledLeafOperator(LinearOperator):
    """S (leaf apply) S+ on flat scaled-leaf vectors; ``op`` is anything with
    ``apply((ns, k)) -> (ns, k)`` that maps consistent arrays to consistent
    arrays (a LeafDualOperator, or the lumped preconditioner's)."""

    op: Any
    sp: ScaledLeafSpace

    @property
    def shape(self):
        n = self.sp.nleaf
        return (n, n)

    def mv(self, xt):
        Y = self.op.apply(xt.reshape(self.sp.s.shape) * self.sp.si.to(xt.dtype))
        return (Y * self.sp.s.to(xt.dtype)).reshape(-1)

    def rmv(self, xt):  # Euclidean-symmetric by the isometry
        return self.mv(xt)


@dataclasses.dataclass
class LeafG(LinearOperator):
    """The dual equality operator G on scaled-leaf vectors: ``mv`` gives the
    coarse (kc,) vector G x_row exactly, ``rmv`` lifts G'y back
    (leafqp.py:113-134).  The JAX package forms ``Gl * s.astype(x.dtype)``
    in every ``mv``, a temporary of the size of Gl; here that product is
    made once per dtype of x (at construction for Gl's own) and kept, with
    the same values."""

    Gl: torch.Tensor  # (kc, ns, k) rows of G lifted to consistent leaf arrays
    sp: ScaledLeafSpace

    def __post_init__(self):
        self.scaled_rows(self.Gl.dtype)

    def scaled_rows(self, dtype: torch.dtype) -> torch.Tensor:
        """(kc, nleaf) Gl * s with s in ``dtype``, kept on the object."""
        cache = self.__dict__.setdefault("_gls", {})
        if dtype not in cache:
            cache[dtype] = (self.Gl * self.sp.s.to(dtype)).reshape(self.Gl.shape[0], -1)
        return cache[dtype]

    @property
    def shape(self):
        return (int(self.Gl.shape[0]), self.sp.nleaf)

    def mv(self, xt):
        check_full_precision(xt.device)
        G = self.scaled_rows(xt.dtype)
        dt = torch.promote_types(G.dtype, xt.dtype)
        return G.to(dt) @ xt.to(dt)

    def rmv(self, y):
        check_full_precision(y.device)
        G = self.Gl.reshape(self.Gl.shape[0], -1)
        dt = torch.promote_types(G.dtype, y.dtype)
        Z = (G.to(dt).T @ y.to(dt)).reshape(self.sp.s.shape)
        return (Z * self.sp.s.to(dt)).reshape(-1)


def leaf_dual_qp(dual: QP, BE_primal, kplus, mesh=None, reuse: QP = None
                 ) -> Tuple[QP, ScaledLeafSpace]:
    """Translate a row-space dual QP (:func:`dualize` of a TFETI problem)
    into its scaled-leaf equivalent (leafqp.py:137-189); returns ``(qp_leaf,
    sls)``, solutions map back with ``sls.restrict``.  The coarse projector
    keeps the row-space factors of ``dual.pf`` (G_leaf G_leaf' = G G'
    exactly).  ``BE_primal`` is the stacked primal extension [BE; BI] with
    its gather tables on the device.  ``reuse``: an earlier ``qp_leaf`` of
    the same operators (a re-solve with a new rhs), whose A, BE and
    projector are taken as they are.  ``mesh``: the F apply runs as the
    overlapped boundary exchange over its ranks (leafqp.py:152-156; a
    ``TypeError`` for anything but a mesh)."""
    from ..parallel.dist import check_mesh

    check_mesh(mesh)
    if reuse is not None:
        A, BE, pf = reuse.A, reuse.BE, reuse.pf
        sls = A.sp
    else:
        op_leaf = LeafDualOperator.create(BE_primal, kplus)
        sls = ScaledLeafSpace.create(op_leaf.space)
        if mesh is not None:
            from ..parallel.overlap import LeafOverlapPlan, OverlappedLeafOperator

            plan = LeafOverlapPlan.build(op_leaf.space, mesh.size)
            op_leaf = OverlappedLeafOperator.create(op_leaf, plan, mesh)
        A = ScaledLeafOperator(op=op_leaf, sp=sls)
        BE = pf = None
        if dual.BE is not None:
            BE = LeafG(Gl=sls.space.lift_rows(dense_rows(dual.BE)), sp=sls)
            if dual.pf is not None:
                pf = dual.pf.replace(G=BE)
            else:
                from ..qp.projector import Projector

                pf = Projector.create(BE, orthonormal_rows=False)
    b = sls.lift(dual.b)
    x0 = sls.lift(dual.x0) if dual.x0 is not None else None

    box = None
    if dual.box is not None:
        box = BoxConstraint(lb=sls.lift_bound(dual.box.lb, -torch.inf),
                            ub=sls.lift_bound(dual.box.ub, torch.inf),
                            astol=dual.box.astol, has_lb=dual.box.has_lb,
                            has_ub=dual.box.has_ub)
    qp_leaf = QP(A=A, b=b, x0=x0, box=box, BE=BE, cE=dual.cE, BI=None, cI=None, R=None,
                 pf=pf, dots_dtype=dual.dots_dtype)
    return qp_leaf, sls


def lumped_pc_leaf(BE_primal, K_blocks: torch.Tensor, sls: ScaledLeafSpace
                   ) -> ScaledLeafOperator:
    """The lumped dual preconditioner B K B' on scaled-leaf vectors (PCDUAL
    lumped, src/pc/impls/dual/pcdual.c:63-78): the leaf apply with the
    stiffness blocks in place of the K+ inverses."""
    B = BE_primal.with_dense_blocks()
    return ScaledLeafOperator(op=LeafDualOperator(blk=B.blk, invs=K_blocks, space=sls.space),
                              sp=sls)
