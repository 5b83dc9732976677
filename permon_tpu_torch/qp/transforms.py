"""QP transforms — the port of :mod:`permon_tpu.qp.transforms` (the QPT
chain of the reference, src/qp/interface/qptransform.c).

Each transform maps a QP to ``(child_qp, post_solve)`` where
``post_solve`` takes the child's :class:`Solution` and returns the
parent's (reference: src/qp/interface/qpchain.c); ``compose`` folds the
post-solves back in reverse order:

- :func:`dualize` (QPTDualize, qptransform.c:909-1197), with a supplied K+
  or the dense :func:`~permon_tpu_torch.core.factor.make_inv`;
- :func:`homogenize_eq` (qptransform.c:437-527),
  :func:`enforce_eq_by_projector` (:215-316),
  :func:`enforce_eq_by_penalty` (:329-410),
  :func:`orthonormalize_eq` (:566-660);
- :func:`scale_objective_by_scalar`, :func:`normalize_objective`,
  :func:`normalize_hessian` (:1574-1771), :func:`freeze_ineq` (:1810-1826),
  :func:`scale` (:1437-1553), :func:`split_be` (:1829-1902),
  :func:`remove_gluing_of_dirichlet_dofs` (:1327-1388);
- the pipelines :func:`all_in_one` (QPTAllInOne, :2151-2205),
  :func:`feti_prepare` and :func:`feti_prepare_reuse_cp` (:1200-1260).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import Struct
from ..core.factor import make_inv
from ..core.linop import Dense, DenseTree, Penalized, Product, Scaled, Transpose, VStack
from .projector import ProjOp, Projector, dense_rows
from ..qpc.box import BoxConstraint
from ..sys import tracing
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
    without a dense R or (N, k) products.  Up to DENSE_G_ELEMENTS G goes to
    the device as a dense (k, m) DenseTree; past it as a
    :class:`~permon_tpu_torch.feti.large.BlockCoarse` when R is
    block-diagonal (per-subdomain contractions, no (k, m) array), else as
    the lazy product R'(B' .).  None when either operator lacks sparse
    structure.  Under a mesh (R holds a rank's rows, B its columns) every
    rank gathers the whole R and B from the ranks' triplets in rank order
    (the one-device matrices, entry for entry) and builds the same G and
    GG'; a BlockCoarse G keeps the rank's blocks."""
    from ..parallel.dist import operator_mesh
    from .sparse_rows import to_scipy

    mesh = operator_mesh(B)
    if mesh is not None:
        R_sp, B_sp = _gathered_scipy(R, B, mesh)
    else:
        R_sp, B_sp = to_scipy(R), to_scipy(B)
    if R_sp is None or B_sp is None:
        return None
    G_sp = (R_sp.T @ B_sp.T).tocsr()
    ggt = (G_sp @ G_sp.T).tocsr()
    k, m = G_sp.shape
    if k * m <= DENSE_G_ELEMENTS:
        G_op = DenseTree.create(torch.as_tensor(np.asarray(G_sp.toarray()),
                                                device=R.vals.device))
    else:
        from ..feti.large import block_coarse_from_R

        G_op = block_coarse_from_R(R, B)
        if G_op is None:
            G_op = Product((Transpose(R), Transpose(B)))  # mv = R'(B' lam)
    return G_op, ggt


def _gathered_scipy(R, B, mesh):
    """The whole R (N, k) and B (m, N) as scipy CSR on every rank, from
    each rank's rows of R and columns of B concatenated in rank order (the
    subdomain order); (None, None) without sparse structure."""
    import scipy.sparse as sp

    from ..parallel.dist import all_gather_object
    from .sparse_rows import to_coo

    parts = all_gather_object((to_coo(R), to_coo(B)), mesh)
    if any(r is None or b is None for r, b in parts):
        return None, None
    Rr, Rc, Rv, Br, Bc, Bv, off = [], [], [], [], [], [], 0
    for (rr, rc, rv, (nloc, k)), (br, bc, bv, (m, _)) in parts:
        Rr.append(rr + off)
        Rc.append(rc)
        Rv.append(rv)
        Br.append(br)
        Bc.append(bc + off)
        Bv.append(bv)
        off += nloc
    R_sp = sp.csr_matrix(sp.coo_matrix((np.concatenate(Rv), (np.concatenate(Rr),
                                                             np.concatenate(Rc))), shape=(off, k)))
    B_sp = sp.csr_matrix(sp.coo_matrix((np.concatenate(Bv), (np.concatenate(Br),
                                                             np.concatenate(Bc))), shape=(m, off)))
    return R_sp, B_sp


def dualize(qp: QP, regularize: bool = True, kplus=None, kplus_mode: str = "plain",
            pf=None, coarse: str = "auto") -> Tuple[QP, PostSolve]:
    """The dual QP  min 1/2 l'Fl - d'l  s.t. G l = e, l_I >= 0  with
    F = B K+ B', d = B K+ b - c, G = R'B', e = R'b, B = [BE; BI] and
    c = [cE; cI]  (QPTDualize, qptransform.c:909-1197).

    ``kplus`` supplies a structured factorized inverse (the band K+ of the
    large path); by default K+ is the dense Cholesky of the Hessian,
    regularized over R when ``regularize`` (:func:`make_inv`, the
    MAT_INV_MONOLITHIC path).  ``kplus_mode`` mirrors
    -qpt_dualize_Kplus_left / _mp (qptransform.c:1019-1087): 'left' composes
    P_R K+ (the output projected onto im K = ker R'), 'mp' the symmetric
    P_R K+ P_R (Moore-Penrose); 'plain' keeps K+.  ``pf`` reuses a
    factorized coarse projector (the QPReusedCP path)."""
    if qp.BE is None and qp.BI is None:
        raise ValueError("dualize needs linear constraints (BE or BI)")
    if kplus_mode not in ("plain", "left", "mp"):
        raise ValueError(f"kplus_mode {kplus_mode!r}: 'plain', 'left' or 'mp'")
    A, b = qp.A, qp.b

    def rhs(c, rows):
        return c if c is not None else torch.zeros(rows, dtype=b.dtype, device=b.device)

    ops, cs, mE = [], [], 0
    if qp.BE is not None:
        mE = qp.BE.shape[0]
        ops.append(qp.BE)
        cs.append(rhs(qp.cE, mE))
    if qp.BI is not None:
        ops.append(qp.BI)
        cs.append(rhs(qp.cI, qp.BI.shape[0]))
    B = ops[0] if len(ops) == 1 else VStack(tuple(ops))
    c = torch.cat(cs)
    m = B.shape[0]
    Kplus = kplus if kplus is not None else make_inv(A, qp.R, regularize=regularize)
    if kplus_mode != "plain" and qp.R is not None and qp.R.shape[1] > 0:
        # P_R = I - R(R'R)^{-1}R' through a projector factory over R' (the
        # Kplus_ QPPF of qptransform.c:1035-1046)
        P_R = ProjOp(pf=Projector.create(Transpose(qp.R)))
        Kplus = Product((P_R, Kplus, P_R) if kplus_mode == "mp" else (P_R, Kplus))
        if tracing.debug_enabled:
            # the generalized-inverse self-checks of the reference's
            # PermonDebugEnabled block (qptransform.c:1060-1081): K K+ K == K
            # (left inverse); K+ K K+ == K+ as well for Moore-Penrose
            from ..core.matutils import mult_equal

            if not mult_equal(Product((A, Kplus, A)), A):
                raise AssertionError("Kplus is not a left generalized inverse (K Kplus K != K)")
            if kplus_mode == "mp" and not mult_equal(Product((Kplus, A, Kplus)), Kplus):
                raise AssertionError("Kplus is not Moore-Penrose (Kplus K Kplus != Kplus)")
    F = Product((B, Kplus, Transpose(B)))
    d = B.mv(Kplus.mv(b)) - c

    G = e = gram = None
    if pf is not None and qp.R is not None and qp.R.shape[1] > 0:
        G = pf.G
        e = qp.R.rmv(b)
    elif qp.R is not None and qp.R.shape[1] > 0:
        from ..parallel.dist import global_rows

        k_null = qp.R.shape[1]
        want_sparse = coarse == "sparse" or (
            coarse == "auto" and k_null * (global_rows(qp.R) + m) > SPARSE_COARSE_THRESHOLD
        )
        sp_coarse = _sparse_coarse(qp.R, B) if want_sparse else None
        if sp_coarse is not None:
            G, gram = sp_coarse
        else:
            Rt = qp.R.todense().T.contiguous()  # (k, N): row i = column r_i
            # G row i = B r_i  (G = R'B', qptransform.c:1089-1100)
            G = Dense.create(torch.stack([B.mv(Rt[i]) for i in range(k_null)]))
        e = qp.R.rmv(b)

    box = None
    if qp.BI is not None:
        # lb = -inf on the E block, 0 on the I block (qptransform.c:1136-1162)
        lb = torch.cat([torch.full((mE,), -torch.inf, dtype=b.dtype, device=b.device),
                        torch.zeros(m - mE, dtype=b.dtype, device=b.device)])
        box = BoxConstraint.create(m, lb=lb, device=b.device)

    child = QP(A=F, b=d, x0=torch.zeros(m, dtype=b.dtype, device=b.device), box=box,
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
        return Solution(x=u, lambda_E=lam[:mE] if qp.BE is not None else None,
                        lambda_I=lam[mE:] if qp.BI is not None else None,
                        Bt_lambda=B.rmv(lam))

    return child, post


def homogenize_eq(qp: QP) -> Tuple[QP, PostSolve]:
    """Shift out a nonzero equality rhs: xt = BE'(BE BE')^{-1} cE; the
    child has cE = 0, b = b - A xt, shifted cI and box (QPTHomogenizeEq)."""
    if qp.cE is None:
        return qp, lambda s: s
    qp = ensure_pf(qp)
    xt = qp.pf.apply_half_q_t(qp.cE)
    cI = qp.cI - qp.BI.mv(xt) if qp.cI is not None and qp.BI is not None else qp.cI
    box = qp.box
    if box is not None:
        box = box.replace(lb=box.lb - xt, ub=box.ub - xt)
    child = qp.replace(b=qp.b - qp.A.mv(xt), cE=None, cI=cI, box=box, x0=None)

    def post(sol: Solution) -> Solution:
        return sol.replace(x=sol.x + xt, g=None)

    return child, post


def enforce_eq_by_projector(qp: QP) -> Tuple[QP, PostSolve]:
    """Replace A by P A (equality-only) or P A P (a box or inequalities
    remain: BE and pf are kept for the solver) and b by P b, with P the
    orthogonal projector onto ker BE (QPTEnforceEqByProjector).  Requires
    homogenized equality constraints."""
    if qp.BE is None:
        return qp.replace(cE=None), lambda s: s
    if qp.cE is not None:
        raise ValueError("apply homogenize_eq before enforce_eq_by_projector")
    qp = ensure_pf(qp)
    P = ProjOp(pf=qp.pf)
    if tracing.debug_enabled:
        # projector self-checks in debug mode: P idempotent, BE P == 0
        from ..core.matutils import mult_equal

        if not mult_equal(Product((P, P)), P):
            raise AssertionError("P is not idempotent")
        if not mult_equal(Product((qp.BE, P)), Scaled(inner=qp.BE, scale=0.0)):
            raise AssertionError("BE P != 0 (P does not project onto ker BE)")
    if qp.BI is None and qp.box is None:
        child = qp.replace(A=Product((P, qp.A)), b=P.mv(qp.b), BE=None, cE=None, pf=None)
    else:
        child = qp.replace(A=Product((P, qp.A, P)), b=P.mv(qp.b))

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


# --------------------------------------------------------------------------
# enforce_eq_by_penalty, orthonormalize_eq
# --------------------------------------------------------------------------


def enforce_eq_by_penalty(qp: QP, rho) -> Tuple[QP, PostSolve]:
    """A_child = A + rho BE'BE (lazy), b_child = b + rho BE'cE
    (QPTEnforceEqByPenalty, qptransform.c:329-410)."""
    if qp.BE is None:
        raise ValueError("enforce_eq_by_penalty needs equality constraints")
    pen = Penalized(a=qp.A, b=qp.BE, rho=torch.as_tensor(rho, dtype=qp.b.dtype,
                                                         device=qp.b.device))
    b = qp.b
    if qp.cE is not None:
        b = b + rho * qp.BE.rmv(qp.cE)
    return qp.replace(A=pen, b=b, BE=None, cE=None), lambda s: s


def orthonormalize_eq(qp: QP, method: str = "gs") -> Tuple[QP, PostSolve]:
    """(T BE, T) = orth_rows(BE): the child has BE = T BE with orthonormal
    rows and cE = T cE; the post-solve maps lambda_E back by T'
    (QPTOrthonormalizeEq).  'inexact' keeps BE and only attaches its exact
    projector; 'implicit' / 'cholesky' on more than 2048 sparse rows take
    the band factorization of BB' (:func:`~permon_tpu_torch.qp.orth.
    orth_rows_implicit_band`), never a dense (m, n) array."""
    from .orth import orth_rows, orth_rows_implicit_band

    if qp.BE is None:
        return qp, lambda s: s
    if method == "inexact":
        return qp.replace(pf=Projector.create(qp.BE)), lambda s: s
    if method in ("implicit", "cholesky") and qp.BE.shape[0] > 2048:
        qt = orth_rows_implicit_band(qp.BE)
        if qt is not None:
            Qop, Top = qt
            cE = Top.mv(qp.cE) if qp.cE is not None else None
            child = qp.replace(BE=Qop, cE=cE, pf=Projector.create(Qop, orthonormal_rows=True))

            def post_band(sol: Solution) -> Solution:
                lam = sol.lambda_E
                return sol.replace(lambda_E=None if lam is None else Top.rmv(lam))

            return child, post_band
    Bd = dense_rows(qp.BE)
    # 'implicit' keeps Q = T BE unassembled in the reference; on the small
    # dense constraint dimension the Cholesky form is the same algebra
    Q, T = orth_rows(Bd, "cholesky" if method == "implicit" else method)
    cE = T @ qp.cE if qp.cE is not None else None
    BEn = Dense.create(Q)
    child = qp.replace(BE=BEn, cE=cE, pf=Projector.create(BEn, orthonormal_rows=True))

    def post(sol: Solution) -> Solution:
        lam = sol.lambda_E
        return sol.replace(lambda_E=None if lam is None else T.T @ lam)

    return child, post


# --------------------------------------------------------------------------
# objective scaling / normalization
# --------------------------------------------------------------------------


def scale_objective_by_scalar(qp: QP, scale_A, scale_b) -> Tuple[QP, PostSolve]:
    """A *= scale_A, b *= scale_b; the child's solution is scaled by
    scale_A / scale_b, box bounds by scale_b / scale_A with infinite entries
    kept (VecScaleSkipInf), every multiplier by 1 / scale_b
    (QPTScaleObjectiveByScalar, qptransform.c:1704-1771)."""
    sA = torch.as_tensor(scale_A, dtype=qp.b.dtype, device=qp.b.device)
    sb = torch.as_tensor(scale_b, dtype=qp.b.dtype, device=qp.b.device)
    box = qp.box
    if box is not None:
        s = sb / sA
        box = box.replace(lb=torch.where(torch.isinf(box.lb), box.lb, box.lb * s),
                          ub=torch.where(torch.isinf(box.ub), box.ub, box.ub * s))
    child = qp.replace(A=Scaled(inner=qp.A, scale=sA), b=qp.b * sb, box=box, x0=None)

    def post(sol: Solution) -> Solution:
        out = sol.replace(x=sol.x * (sA / sb))
        for name in ("lambda_E", "lambda_I", "Bt_lambda"):
            v = getattr(sol, name)
            if v is not None:
                out = out.replace(**{name: v / sb})
        return out

    return child, post


def normalize_objective(qp: QP) -> Tuple[QP, PostSolve]:
    """scale_A = 1/||A|| (power method), scale_b = 1/||b|| (1/||A|| when
    b = 0) (QPTNormalizeObjective, qptransform.c:1574-1592)."""
    from ..core.eig import max_eigenvalue

    norm_A = max_eigenvalue(qp.A, device=qp.b.device)
    norm_b = torch.linalg.vector_norm(qp.b)
    norm_b = torch.where(norm_b == 0, norm_A, norm_b)
    return scale_objective_by_scalar(qp, 1.0 / norm_A, 1.0 / norm_b)


def normalize_hessian(qp: QP) -> Tuple[QP, PostSolve]:
    """scale_A = scale_b = 1/||A|| (QPTNormalizeHessian, qptransform.c:1611)."""
    from ..core.eig import max_eigenvalue

    norm_A = max_eigenvalue(qp.A, device=qp.b.device)
    return scale_objective_by_scalar(qp, 1.0 / norm_A, 1.0 / norm_A)


# --------------------------------------------------------------------------
# freeze_ineq / scale
# --------------------------------------------------------------------------


def freeze_ineq(qp: QP) -> Tuple[QP, PostSolve]:
    """Move BI, cI into the equality block: child BE = [BE; BI], cE = [cE;
    cI] (QPTFreezeIneq, qptransform.c:1810-1826); the post-solve splits
    lambda_E back into lambda_E / lambda_I."""
    if qp.BI is None:
        raise ValueError("freeze_ineq needs inequality constraints")
    zeros = lambda m: torch.zeros(m, dtype=qp.b.dtype, device=qp.b.device)  # noqa: E731
    cI = qp.cI if qp.cI is not None else zeros(qp.BI.shape[0])
    if qp.BE is None:
        child = qp.replace(BE=qp.BI, cE=cI, BI=None, cI=None, pf=None)

        def post(sol: Solution) -> Solution:
            return sol.replace(lambda_I=sol.lambda_E, lambda_E=None)

        return child, post
    mE = qp.BE.shape[0]
    cE = qp.cE if qp.cE is not None else zeros(mE)
    child = qp.replace(BE=VStack((qp.BE, qp.BI)), cE=torch.cat([cE, cI]),
                       BI=None, cI=None, pf=None)

    def post_split(sol: Solution) -> Solution:
        lam = sol.lambda_E
        if lam is None:
            return sol
        return sol.replace(lambda_E=lam[:mE], lambda_I=lam[mE:])

    return child, post_split


def eq_multiplicity_scaling(qp: QP) -> torch.Tensor:
    """d_i = 1/sqrt(multiplicity) per BE row, the multiplicity being the
    row's nonzero count (QPGetEqMultiplicityScaling, qp.c:1632+); sparse
    operators are counted on the host, others densified."""
    from .sparse_rows import row_nnz

    nnz = row_nnz(qp.BE)
    if nnz is not None:
        return torch.as_tensor(1.0 / np.sqrt(np.maximum(nnz, 1)), dtype=torch.float64,
                               device=qp.b.device)
    Bd = dense_rows(qp.BE)
    cnt = torch.sum(torch.abs(Bd) > 0, dim=1)
    return 1.0 / torch.sqrt(torch.clamp(cnt, min=1).to(Bd.dtype))


def scale(qp: QP, scale_O: Optional[str] = None,
          scale_E: Optional[str] = None) -> Tuple[QP, PostSolve]:
    """Row scaling of the objective / equality constraints (QPTScale,
    qptransform.c:1437-1553).  scale_O: None | 'rows_norm_2'; scale_E:
    None | 'rows_norm_2' | 'ddm_multiplicity'.  A sparse BE keeps its type
    (its rows scaled on the host); only a matrix-free BE is densified."""
    child, dE = qp, None
    if scale_O == "rows_norm_2":
        Ad = qp.A.todense()
        d = 1.0 / torch.linalg.vector_norm(Ad, dim=1)
        child = child.replace(A=Dense.create(d[:, None] * Ad), b=d * qp.b)
    elif scale_O is not None:
        raise ValueError(f"unsupported scale_O {scale_O!r}")
    if scale_E is not None and qp.BE is not None:
        from .sparse_rows import row_sqnorm, scale_rows

        if scale_E == "rows_norm_2":
            sq = row_sqnorm(qp.BE)
            dE = (torch.as_tensor(1.0 / np.sqrt(sq), dtype=qp.b.dtype, device=qp.b.device)
                  if sq is not None
                  else 1.0 / torch.linalg.vector_norm(dense_rows(qp.BE), dim=1))
        elif scale_E == "ddm_multiplicity":
            dE = eq_multiplicity_scaling(qp)
        else:
            raise ValueError(f"unsupported scale_E {scale_E!r}")
        cE = dE * qp.cE if qp.cE is not None else None
        try:
            BEs = scale_rows(qp.BE, dE)
        except TypeError:
            BEs = Dense.create(dE[:, None] * dense_rows(qp.BE))
        child = child.replace(BE=BEs, cE=cE, pf=None)

    def post(sol: Solution) -> Solution:
        if dE is not None and sol.lambda_E is not None:
            return sol.replace(lambda_E=dE * sol.lambda_E)
        return sol

    return child, post


# --------------------------------------------------------------------------
# pipelines
# --------------------------------------------------------------------------


def all_in_one(qp: QP, dual: bool = True, project: bool = True, penalty: float = 0.0,
               regularize: bool = True, normalize: Optional[str] = None,
               freeze: bool = False, orth_eq: Optional[str] = None,
               kplus=None) -> Tuple[QP, PostSolve]:
    """The option-driven pipeline (QPTAllInOne, qptransform.c:2151-2205):
    [normalize] -> [OrthonormalizeEq] -> [FreezeIneq] -> [Dualize ->
    OrthonormalizeEq] -> [HomogenizeEq -> EnforceEqByProjector] ->
    [EnforceEqByPenalty].  Returns the last child and the composed
    post-solve; ``-feti`` is dual=True, project=True with a block-diagonal
    ``kplus``."""
    steps: List[Tuple[QP, PostSolve]] = []

    def apply(fn, *a, **k):
        nonlocal qp
        qp, ps = fn(qp, *a, **k)
        steps.append((qp, ps))

    if normalize == "objective":
        apply(normalize_objective)
    elif normalize == "hessian":
        apply(normalize_hessian)
    if orth_eq and qp.BE is not None:
        apply(orthonormalize_eq, orth_eq)
    if freeze and qp.BI is not None:
        apply(freeze_ineq)
    if dual:
        apply(dualize, regularize=regularize, kplus=kplus)
        if orth_eq and qp.BE is not None:
            apply(orthonormalize_eq, orth_eq)
    if project and qp.BE is not None:
        if qp.cE is not None:
            apply(homogenize_eq)
        apply(enforce_eq_by_projector)
    if penalty:
        if qp.BE is None:
            raise ValueError("penalty needs equality constraints left in the chain")
        apply(enforce_eq_by_penalty, penalty)
    return qp, compose(steps)


def feti_prepare(qp: QP, kplus=None, regularize: bool = True) -> Tuple[QP, PostSolve]:
    """Dualize -> HomogenizeEq -> EnforceEqByProjector, the TFETI pipeline
    (QPTFetiPrepare, qptransform.c:1200-1210)."""
    return all_in_one(qp, dual=True, project=True, regularize=regularize, kplus=kplus)


def _leaves(obj) -> list:
    """The tensors and host arrays an operator holds, nested operators,
    tuples and gather tables included, in field order."""
    out, todo = [], [obj]
    while todo:
        cur = todo.pop(0)
        if isinstance(cur, (torch.Tensor, np.ndarray)):
            out.append(cur)
        elif isinstance(cur, (tuple, list)):
            todo.extend(cur)
        elif dataclasses.is_dataclass(cur) and not isinstance(cur, type):
            todo.extend(getattr(cur, f.name) for f in dataclasses.fields(cur))
    return out


#: key -> (pf, keyed leaves).  The leaves are held STRONGLY in the entry so
#: their id()s cannot be recycled while it lives (an id()-only key could
#: match a different later operator); the size bound keeps a long session
#: from piling up stale factorizations.
_REUSE_CP_CACHE: dict = {}
_REUSE_CP_CACHE_MAX = 16


def feti_prepare_reuse_cp(qp: QP, kplus=None, regularize: bool = True,
                          _cache=_REUSE_CP_CACHE) -> Tuple[QP, PostSolve]:
    """QPTFetiPrepareReuseCP (qptransform.c:1213-1251): :func:`feti_prepare`
    with the coarse factorization (the dual QP's projector) cached under the
    identity of the tensors and host arrays of BE, BI and R (the objects
    that persist across ``qp.replace(b=...)``), and threaded into
    :func:`dualize` so that GG' is not factorized again."""
    leaves = _leaves((qp.BE, qp.BI, qp.R))
    key = tuple(id(leaf) for leaf in leaves)
    entry = _cache.get(key)
    pf = entry[0] if entry is not None else None
    dual, post_d = dualize(qp, regularize=regularize, kplus=kplus, pf=pf)
    if pf is None and dual.BE is not None:
        _cache[key] = (dual.pf, leaves)
        while len(_cache) > _REUSE_CP_CACHE_MAX:
            _cache.pop(next(iter(_cache)))
    steps = [(dual, post_d)]
    cur = dual
    if cur.cE is not None:
        cur, post_h = homogenize_eq(cur)
        steps.append((cur, post_h))
    if cur.BE is not None:
        pf_holder = cur
        cur, post_p = enforce_eq_by_projector(cur)
        # the child carries the (cached) coarse factorization, as the
        # reference's child QP keeps its QPPF
        cur = cur.replace(pf=pf_holder.pf)
        steps.append((cur, post_p))
    return cur, compose(steps)


def feti_prepare_reuse_cp_reset() -> None:
    """Drop every cached coarse factorization (QPTFetiPrepareReuseCPReset,
    qptransform.c:1254-1260)."""
    _REUSE_CP_CACHE.clear()


def split_be(qp: QP) -> Tuple[QP, PostSolve]:
    """BE rows reordered into gluing rows (>= 2 nonzeros) then Dirichlet
    rows (1 nonzero): child BE = [Bg; Bd] (QPTSplitBE, qptransform.c:
    1829-1902); the post-solve permutes lambda_E back."""
    from .sparse_rows import permute_rows, row_nnz

    if qp.BE is None:
        raise ValueError("split_be needs equality constraints")
    nnz = row_nnz(qp.BE)
    if nnz is None:
        nnz = (torch.sum(torch.abs(dense_rows(qp.BE)) > 0, dim=1)).cpu().numpy()
    perm = np.concatenate([np.flatnonzero(nnz >= 2), np.flatnonzero(nnz == 1)])
    try:
        Bnew = permute_rows(qp.BE, perm)
    except TypeError:
        Bnew = Dense.create(dense_rows(qp.BE)[torch.as_tensor(perm)])
    dev = qp.b.device
    cE = qp.cE[torch.as_tensor(perm, device=dev)] if qp.cE is not None else None
    inv_perm = torch.as_tensor(np.argsort(perm), device=dev)

    def post(sol: Solution) -> Solution:
        if sol.lambda_E is None:
            return sol
        return sol.replace(lambda_E=sol.lambda_E[inv_perm])

    return qp.replace(BE=Bnew, cE=cE, pf=None), post


def remove_gluing_of_dirichlet_dofs(qp: QP, dirichlet_dofs) -> Tuple[QP, PostSolve]:
    """Drop the BE rows that act on Dirichlet dofs (QPTRemoveGluingOf-
    DirichletDofs, qptransform.c:1327-1388, permonmatfetiutils.c:1-167); the
    post-solve pads lambda_E back to the parent's rows with zeros."""
    from .sparse_rows import restrict_rows, to_coo

    if qp.BE is None:
        raise ValueError("remove_gluing_of_dirichlet_dofs needs equality constraints")
    coo = to_coo(qp.BE)
    if coo is not None:
        rows, cols, vals, (m_parent, n) = coo
        mask = np.zeros(n, dtype=bool)
        mask[np.asarray(dirichlet_dofs, dtype=np.int64)] = True
        touched = np.zeros(m_parent, dtype=bool)
        touched[rows[mask[cols] & (vals != 0)]] = True
        keep = np.flatnonzero(~touched)
        Bnew = restrict_rows(qp.BE, keep)
    else:
        Bd = dense_rows(qp.BE)
        m_parent = Bd.shape[0]
        mask = torch.zeros(Bd.shape[1], dtype=torch.bool, device=Bd.device)
        mask[torch.as_tensor(np.asarray(dirichlet_dofs, dtype=np.int64), device=Bd.device)] = True
        keep = np.flatnonzero(~(torch.abs(Bd[:, mask]) > 0).any(dim=1).cpu().numpy())
        Bnew = Dense.create(Bd[torch.as_tensor(keep, device=Bd.device)])
    dev = qp.b.device
    keep_t = torch.as_tensor(keep, device=dev)
    cE = qp.cE[keep_t] if qp.cE is not None else None

    def post(sol: Solution) -> Solution:
        if sol.lambda_E is None:
            return sol
        lam = sol.lambda_E.new_zeros(m_parent)
        lam[keep_t] = sol.lambda_E  # keep is a set of distinct rows
        return sol.replace(lambda_E=lam)

    return qp.replace(BE=Bnew, cE=cE, pf=None), post
