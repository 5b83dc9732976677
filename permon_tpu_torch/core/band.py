"""Scale-capable K+ — batched blocked band Cholesky, the port of
:mod:`permon_tpu.core.band` (the large-subdomain MATINV path, reference:
src/mat/impls/inv/matinv.c:481-590).

A matrix of bandwidth bw < NB is block tridiagonal with (NB, NB) blocks;
its Cholesky factor follows the recurrence

    F_i = A_{i,i-1} D_{i-1}^{-T},   D_i = chol(A_ii - F_i F_i'),

run as a loop over the nb block rows with every step a batched (over
subdomains) dense op.  Applies are two loops (forward/backward
substitution) of batched GEMVs against the stored D^{-1} and F blocks.
Floating subdomains get FIXING-DOF regularization (reference:
src/mat/interface/permonmatregularize.c:117-287): Kreg = K + rho R_I
(R_I'R_I)^{-1} R_I', an exact generalized inverse of K.

Factors are stored SCAN-MAJOR, (nb, ns, NB, NB), block-row index leading,
so each step of the loops reads one contiguous (ns, NB, NB) slab.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

from .linop import LinearOperator


# ---------------------------------------------------------------------------
# host-side setup (numpy / scipy copies of the JAX package's helpers)
# ---------------------------------------------------------------------------


def bandwidth(a) -> int:
    coo = a.tocoo()
    if coo.nnz == 0:
        return 0
    return int(np.abs(coo.row.astype(np.int64) - coo.col).max())


def fixing_dofs(R_block: np.ndarray, lo: int = 0, hi: Optional[int] = None) -> np.ndarray:
    """k = R.shape[1] fixing dofs with a well-conditioned restriction R_I
    (column-pivoted QR on R'), restricted to rows [lo, hi)."""
    from scipy.linalg import qr

    k = R_block.shape[1]
    if k == 0:
        return np.zeros(0, dtype=np.int64)
    hi = R_block.shape[0] if hi is None else hi
    _, _, piv = qr(R_block[lo:hi].T, pivoting=True)
    return np.sort(piv[:k] + lo)


def _fixing_window(R_block: np.ndarray, NB: int, nl: int) -> Tuple[int, int]:
    """The [lo, hi) row window the fixing dofs are picked from: inside ONE
    diagonal band block near the end of the ordering, restricted to rows
    where R is supported (core/band.py:119-135)."""
    k = R_block.shape[1]
    rnz = np.flatnonzero(np.abs(R_block[:nl]).sum(axis=1) != 0.0)
    if len(rnz) == 0:
        raise ValueError("nullspace basis has no nonzero rows")
    n_real = int(rnz[-1]) + 1
    last = (n_real - 1) // NB
    in_last = int(np.count_nonzero(rnz >= last * NB))
    if in_last >= max(4 * k, 16) or last == 0:
        return last * NB, n_real
    return (last - 1) * NB, last * NB


def gershgorin_max_eig_csr(Ksp) -> float:
    """max_i sum_j |K_ij| from sparse storage."""
    import scipy.sparse as sp

    return float(np.abs(sp.csr_matrix(Ksp)).sum(axis=1).max())


# ---------------------------------------------------------------------------
# device-side factorization
# ---------------------------------------------------------------------------


def _expand_row(Dd: torch.Tensor, offsets, NB: int, Ad: torch.Tensor,
                Asub: torch.Tensor) -> None:
    """Write block row i of the block-tridiagonal factor input from its
    stencil diagonals ``Dd`` (ns, ndiag, NB) into the zeroed ``Ad`` /
    ``Asub`` (ns, NB, NB): diagonal ``off`` puts Dd[:, d, r] at
    Ad[:, r, r + off] and, for off < 0, the rows r < -off at
    Asub[:, r, r + off + NB].  The same values the JAX package's masked eye
    products produce (core/band.py:361-371), written as diagonal views."""
    for d, off in enumerate(offsets):
        if -NB < off < NB:
            lo, hi = max(0, -off), min(NB, NB - off)
            torch.diagonal(Ad, offset=off, dim1=1, dim2=2).copy_(Dd[:, d, lo:hi])
        if -NB < off < 0:
            torch.diagonal(Asub, offset=off + NB, dim1=1, dim2=2).copy_(Dd[:, d, : -off])


def _check_tf32(dev: torch.device) -> None:
    """The band factors and their applies need full-f32 products: under
    TF32 the f32 Schur recurrence loses positive definiteness (the JAX
    package forces "highest" precision for the same reason,
    core/band.py:302-305), and TF32 GEMVs cap the refinement."""
    if dev.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("torch.backends.cuda.matmul.allow_tf32 is True; the "
                           "band Cholesky K+ needs full-f32 products")


def factor_from_dia_sm(data: torch.Tensor, offsets, NB: int, dtype=None,
                       upd_bi=None, upd_idx=None, upd_q=None):
    """Fused expand-and-factor over SCAN-MAJOR blocks: block row i of the
    block-tridiagonal input is expanded from the (ns, ndiag, nlp) stencil
    diagonals inside the loop (the (nb, ns, NB, NB) inputs never exist),
    the rank-k fixing-dof correction ``upd_q`` is injected into each
    subdomain's diagonal block ``upd_bi[s]`` as the loop passes it, and the
    factors are written into preallocated (nb, ns, NB, NB) tensors of
    ``dtype`` (default: the stencil's dtype).

    The recurrence runs in the wider of the stencil's dtype and ``dtype``
    (f64 for the f64 stencil of the large path) and only the STORED factors
    are rounded to ``dtype``: f32 storage keeps half the memory, while an
    f32 recurrence measured on an H100 left the unrefined K+ 3x and the
    refined K+ four orders less accurate, and the 101^3 north-star residual
    after one primal defect pass at 1.7e-6 instead of 2.0e-8 (PERF.md).

    Returns (Dinv, F): Dinv_i = D_i^{-1} with D_i = chol(A_ii - F_i F_i'),
    F_i = A_{i,i-1} D_{i-1}^{-T}, F_0 = 0 (core/band.py:336-389).  Raises
    if any pivot block is not positive definite (checked once, after the
    loop, from ``cholesky_ex``'s info)."""
    ns, ndiag, nlp = data.shape
    nb = nlp // NB
    dt = dtype if dtype is not None else data.dtype
    cdt = torch.promote_types(data.dtype, dt)
    dev = data.device
    _check_tf32(dev)
    D = data.to(cdt).reshape(ns, ndiag, nb, NB)
    eye = torch.eye(NB, dtype=cdt, device=dev).expand(ns, NB, NB)
    # the factors are written IN PLACE into preallocated tensors, one block
    # row per step: deliberate — the functional scan of the JAX package
    # would hold a second copy of the multi-GB factor arrays at the end
    Dinv = torch.empty((nb, ns, NB, NB), dtype=dt, device=dev)
    F = torch.empty((nb, ns, NB, NB), dtype=dt, device=dev)
    info = torch.zeros((nb, ns), dtype=torch.int32, device=dev)
    Ad = torch.empty((ns, NB, NB), dtype=cdt, device=dev)
    Asub = torch.empty((ns, NB, NB), dtype=cdt, device=dev)
    if upd_q is not None:
        kf = upd_idx.shape[1]
        sidx = torch.arange(ns, device=dev)[:, None, None].expand(ns, kf, kf)
        ridx = upd_idx[:, :, None].expand(ns, kf, kf)
        cidx = upd_idx[:, None, :].expand(ns, kf, kf)
        q = upd_q.to(cdt)
    Dinv_prev = torch.zeros((ns, NB, NB), dtype=cdt, device=dev)
    for i in range(nb):
        Ad.zero_()
        Asub.zero_()
        _expand_row(D[:, :, i, :], offsets, NB, Ad, Asub)
        if upd_q is not None:
            mask = (upd_bi == i).to(cdt)  # the blocks whose window is this row
            Ad.index_put_((sidx, ridx, cidx), q * mask[:, None, None], accumulate=True)
        Fi = torch.bmm(Asub, Dinv_prev.transpose(1, 2))  # A_{i,i-1} D^{-T}
        L, info[i] = torch.linalg.cholesky_ex(Ad - torch.bmm(Fi, Fi.transpose(1, 2)))
        Dinv_prev = torch.linalg.solve_triangular(L, eye, upper=False)
        F[i] = Fi
        Dinv[i] = Dinv_prev
    bad = torch.nonzero(info).tolist()
    if bad:
        raise ValueError(
            f"band Cholesky: {len(bad)} pivot blocks not positive definite "
            f"(first at block row {bad[0][0]}, subdomain {bad[0][1]})"
        )
    return Dinv, F


@dataclasses.dataclass
class BandCholInv(LinearOperator):
    """y = Kreg^{-1} x via the stored block-tridiagonal Cholesky factors.
    With ``refine`` > 0 and ``op`` set, each apply runs that many
    iterative-refinement steps against ``op`` (kept in its own precision),
    recovering direct accuracy from an f32 factorization."""

    Dinv: torch.Tensor  # (nb, ns, NB, NB), scan-major
    F: torch.Tensor  # (nb, ns, NB, NB), scan-major; F[0] = 0
    shape: Tuple[int, int]
    op: Any = None
    refine: int = 0

    @classmethod
    def from_blockdia(cls, op, NB: int, dtype=None, refine: int = 0) -> "BandCholInv":
        """Factorize from a (regularized) BlockDia stencil; ``op`` doubles
        as the refinement operator when ``refine`` > 0."""
        from .dia import RegularizedBlockDia

        n = int(op.shape[0])
        if isinstance(op, RegularizedBlockDia):
            Dinv, F = factor_from_dia_sm(op.base.data, op.base.offsets, NB, dtype=dtype,
                                         upd_bi=op.bi, upd_idx=op.idx, upd_q=op.q)
        else:
            Dinv, F = factor_from_dia_sm(op.data, op.offsets, NB, dtype=dtype)
        return cls(Dinv=Dinv, F=F, shape=(n, n), op=op if refine else None,
                   refine=refine)

    def _fwd(self, xb: torch.Tensor) -> torch.Tensor:
        """y = L^{-1} x on scan-major (nb, ns, NB) blocks (L_ii = D_i,
        L_{i,i-1} = F_i): y_i = Dinv_i (b_i - F_i y_{i-1})."""
        nb, ns, NB, _ = self.Dinv.shape
        Y = torch.empty_like(xb)
        y = torch.zeros((ns, NB, 1), dtype=xb.dtype, device=xb.device)
        for i in range(nb):
            y = torch.bmm(self.Dinv[i], xb[i, :, :, None] - torch.bmm(self.F[i], y))
            Y[i] = y[..., 0]
        return Y

    def _bwd(self, Y: torch.Tensor) -> torch.Tensor:
        """x = L^{-T} y: x_i = Dinv_i' (y_i - z_{i+1}) with the carried
        cross term z_i = F_i' x_i."""
        nb, ns, NB, _ = self.Dinv.shape
        X = torch.empty_like(Y)
        z = torch.zeros((ns, NB, 1), dtype=Y.dtype, device=Y.device)
        for i in range(nb - 1, -1, -1):
            xi = torch.bmm(self.Dinv[i].transpose(1, 2), Y[i, :, :, None] - z)
            z = torch.bmm(self.F[i].transpose(1, 2), xi)
            X[i] = xi[..., 0]
        return X

    def _to_blocks(self, x):
        nb, ns, NB, _ = self.Dinv.shape
        return x.reshape(ns, nb, NB).to(self.Dinv.dtype).transpose(0, 1).contiguous()

    @staticmethod
    def _from_blocks(Xb):
        return Xb.transpose(0, 1).reshape(-1)

    def _solve(self, x):
        _check_tf32(x.device)
        return self._from_blocks(self._bwd(self._fwd(self._to_blocks(x))))

    def mv(self, x):
        y = self._solve(x).to(x.dtype)
        if self.refine and self.op is not None:
            for _ in range(self.refine):
                r = x - self.op.mv(y)
                y = y + self._solve(r).to(x.dtype)
        return y

    rmv = mv  # symmetric
