"""QP transforms — the part of :mod:`permon_tpu.qp.transforms` the
large-path linear TFETI solve uses: ``dualize`` -> ``homogenize_eq`` ->
``enforce_eq_by_projector``, folded back by ``compose``.

Each transform maps a QP to ``(child_qp, post_solve)`` where
``post_solve`` takes the child's :class:`Solution` and returns the
parent's (reference: src/qp/interface/qpchain.c, qptransform.c).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import torch

from .. import Struct, not_ported
from ..core.linop import Dense, DenseTree, Product, Transpose
from .projector import ProjOp, Projector
from .qp import QP

#: k*(N+m) element count past which dualize(coarse='auto') builds the
#: coarse side sparse on the host (qp/transforms.py:87)
SPARSE_COARSE_THRESHOLD = 1 << 25
#: element count up to which the sparse coarse build ships G to the device
#: as an explicit dense (k, m) DenseTree (qp/transforms.py:100)
DENSE_G_ELEMENTS = 1 << 26


@dataclasses.dataclass
class Solution(Struct):
    x: torch.Tensor
    lambda_E: Optional[torch.Tensor] = None
    lambda_I: Optional[torch.Tensor] = None
    Bt_lambda: Optional[torch.Tensor] = None
    g: Optional[torch.Tensor] = None


PostSolve = Callable[[Solution], Solution]


def compose(steps: Sequence[Tuple[QP, PostSolve]]) -> PostSolve:
    """Fold child-to-parent post-solves in reverse chain order
    (QPChainPostSolve, qpchain.c:200-282)."""

    def post(sol: Solution) -> Solution:
        for _, ps in reversed(list(steps)):
            sol = ps(sol)
        return sol

    return post


def ensure_pf(qp: QP, orthonormal_rows: bool = False) -> QP:
    """Attach the projector over BE if absent."""
    if qp.BE is None or qp.pf is not None:
        return qp
    return qp.replace(pf=Projector.create(qp.BE, orthonormal_rows=orthonormal_rows))


def _sparse_coarse(R, B):
    """Host sparse coarse build: G = R'B' and the sparse Gram GG' (scipy),
    without a dense R or (N, k) products; G goes to the device as a dense
    (k, m) DenseTree.  None when either operator lacks sparse structure."""
    import numpy as np

    from .sparse_rows import to_scipy

    R_sp = to_scipy(R)
    B_sp = to_scipy(B)
    if R_sp is None or B_sp is None:
        return None
    G_sp = (R_sp.T @ B_sp.T).tocsr()
    ggt = (G_sp @ G_sp.T).tocsr()
    k, m = G_sp.shape
    if k * m > DENSE_G_ELEMENTS:
        raise not_ported("the block coarse operator BlockCoarse (k*m past 2^26)")
    dev = R.vals.device
    G_op = DenseTree.create(torch.as_tensor(np.asarray(G_sp.toarray()), device=dev))
    return G_op, ggt


def dualize(qp: QP, kplus=None, kplus_mode: str = "plain", pf=None,
            coarse: str = "auto") -> Tuple[QP, PostSolve]:
    """The dual QP  min 1/2 l'Fl - d'l  s.t. G l = e  with F = B K+ B',
    d = B K+ b - c, G = R'B', e = R'b  (QPTDualize, qptransform.c:909-1197).
    Only the equality-constrained case with a supplied ``kplus`` and
    ``kplus_mode='plain'`` is ported.  ``pf`` reuses a factorized coarse
    projector (the QPReusedCP path)."""
    if qp.BE is None:
        raise ValueError("dualize needs equality constraints BE")
    if kplus is None:
        raise not_ported("dualize without a supplied K+ (make_inv)")
    if kplus_mode != "plain":
        raise not_ported(f"kplus_mode={kplus_mode!r}")
    A, b = qp.A, qp.b
    B = qp.BE
    m = B.shape[0]
    c = qp.cE if qp.cE is not None else torch.zeros(m, dtype=b.dtype, device=b.device)
    Kplus = kplus
    F = Product((B, Kplus, Transpose(B)))
    d = B.mv(Kplus.mv(b)) - c

    G = e = gram = None
    if pf is not None and qp.R is not None and qp.R.shape[1] > 0:
        G = pf.G
        e = qp.R.rmv(b)
    elif qp.R is not None and qp.R.shape[1] > 0:
        k_null = qp.R.shape[1]
        want_sparse = coarse == "sparse" or (
            coarse == "auto" and k_null * (qp.R.shape[0] + m) > SPARSE_COARSE_THRESHOLD
        )
        sp_coarse = _sparse_coarse(qp.R, B) if want_sparse else None
        if sp_coarse is not None:
            G, gram = sp_coarse
        else:
            Rt = qp.R.todense().T.contiguous()  # (k, N): row i = column r_i
            # G row i = B r_i  (G = R'B', qptransform.c:1089-1100)
            G = Dense.create(torch.stack([B.mv(Rt[i]) for i in range(k_null)]))
        e = qp.R.rmv(b)

    child = QP(A=F, b=d, x0=torch.zeros(m, dtype=b.dtype, device=b.device),
               BE=G, cE=e, R=None)
    if pf is not None:
        child = child.replace(pf=pf)
    elif gram is not None:
        child = child.replace(pf=Projector.create(G, gram=gram))
    else:
        child = ensure_pf(child)

    def post(sol: Solution) -> Solution:
        lam = sol.x
        u = Kplus.mv(b - B.rmv(lam))
        if G is not None:
            # alpha = (GG')^{-1} G (G'mu), G'mu accumulated in Bt_lambda
            # (QPTDualizePostSolve_Private, qptransform.c:782-833)
            bt = sol.Bt_lambda
            if bt is None:
                bt = (G.rmv(sol.lambda_E) if sol.lambda_E is not None
                      else torch.zeros(m, dtype=b.dtype, device=b.device))
            alpha = child.pf.apply_half_q(bt)
            u = u - qp.R.mv(alpha)
        return Solution(x=u, lambda_E=lam, Bt_lambda=B.rmv(lam))

    return child, post


def homogenize_eq(qp: QP) -> Tuple[QP, PostSolve]:
    """Shift out a nonzero equality rhs: xt = BE'(BE BE')^{-1} cE; the
    child has cE = 0 and b = b - A xt (QPTHomogenizeEq)."""
    if qp.cE is None:
        return qp, lambda s: s
    qp = ensure_pf(qp)
    xt = qp.pf.apply_half_q_t(qp.cE)
    child = qp.replace(b=qp.b - qp.A.mv(xt), cE=None, x0=None)

    def post(sol: Solution) -> Solution:
        return sol.replace(x=sol.x + xt, g=None)

    return child, post


def enforce_eq_by_projector(qp: QP) -> Tuple[QP, PostSolve]:
    """Replace A by P A and b by P b with P the orthogonal projector onto
    ker BE (QPTEnforceEqByProjector, equality-only form).  Requires
    homogenized equality constraints."""
    if qp.BE is None:
        return qp.replace(cE=None), lambda s: s
    if qp.cE is not None:
        raise ValueError("apply homogenize_eq before enforce_eq_by_projector")
    qp = ensure_pf(qp)
    P = ProjOp(pf=qp.pf)
    child = qp.replace(A=Product((P, qp.A)), b=P.mv(qp.b), BE=None, cE=None, pf=None)

    def post(sol: Solution) -> Solution:
        # lambda_E fixup: Bt_lambda += Q (b - A x), lambda_E += halfQ(b - A x)
        # (QPTEnforceEqByProjectorPostSolve_Private, qptransform.c:57-95)
        r = qp.b - qp.A.mv(sol.x)
        lam_E = qp.pf.apply_half_q(r)
        bt = qp.pf.apply_q(r)
        if sol.lambda_E is not None:
            lam_E = lam_E + sol.lambda_E
        if sol.Bt_lambda is not None:
            bt = bt + sol.Bt_lambda
        return sol.replace(lambda_E=lam_E, Bt_lambda=bt)

    return child, post
