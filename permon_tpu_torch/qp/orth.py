"""Row / column orthonormalization — the port of :mod:`permon_tpu.qp.orth`
(the MatOrthRows / MatOrthColumns analog, reference:
src/mat/interface/permonmatorth.c; used by QPTOrthonormalizeEq,
qptransform.c:566-660).

Produces (Q, T) with Q = T B having orthonormal rows; T maps constraint
right-hand sides forward and (transposed) the multipliers back.  Methods:

- ``gs``: classical Gram-Schmidt with a fixed four sweeps per row
  (permonmatorth.c:207-250);
- ``gs_lingen``: Lingen's variant, re-orthogonalizing a row while its norm
  dropped below ``alpha`` times the last sweep's (permonmatorth.c:252-290);
  the test is one host read per sweep;
- ``cholesky``: BB' = LL', Q = L^{-1} B (permonmatorth.c:35-143);
- ``implicit`` / ``inexact``: no-op transforms (permonmatorth.c:145-174).

The row loops are Python loops over the constraint rows (the coarse G has
one row per nullspace column, a few hundred at most on the dense path).
:func:`orth_rows_implicit_band` is the sparse variant for wide sparse
operators: T = L^{-1} P from the band Cholesky of the RCM-ordered BB'.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from ..core.linop import LinearOperator


def _gs_sweep(Q, T, b, t):
    """One classical Gram-Schmidt sweep of (b, t) against the rows so far
    (rows not yet set are 0)."""
    coeffs = Q @ b
    return b - Q.T @ coeffs, t - T.T @ coeffs


def orth_rows_gs(B: torch.Tensor, rtol: float = 1e-10,
                 max_reorth: int = 4) -> Tuple[torch.Tensor, torch.Tensor]:
    """Iterated classical Gram-Schmidt on rows; (Q, T) with Q = T B."""
    m, n = B.shape
    Q = torch.zeros((m, n), dtype=B.dtype, device=B.device)
    T = torch.zeros((m, m), dtype=B.dtype, device=B.device)
    for i in range(m):
        b, t = B[i], torch.zeros(m, dtype=B.dtype, device=B.device)
        t[i] = 1.0
        for _ in range(max_reorth):
            b, t = _gs_sweep(Q, T, b, t)
        nrm = torch.linalg.vector_norm(b)
        Q[i], T[i] = b / nrm, t / nrm
    return Q, T


def orth_rows_gs_lingen(B: torch.Tensor, alpha: float = 0.5,
                        max_reorth: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lingen's iterated Gram-Schmidt: one sweep, then more while the norm
    dropped below ``alpha`` times its value before the last sweep (at most
    ``max_reorth`` sweeps in all)."""
    m, n = B.shape
    Q = torch.zeros((m, n), dtype=B.dtype, device=B.device)
    T = torch.zeros((m, m), dtype=B.dtype, device=B.device)
    for i in range(m):
        b, t = B[i], torch.zeros(m, dtype=B.dtype, device=B.device)
        t[i] = 1.0
        prev = torch.linalg.vector_norm(b)
        b, t = _gs_sweep(Q, T, b, t)
        it = 1
        while it < max_reorth:
            nrm = torch.linalg.vector_norm(b)
            if not bool(nrm < alpha * prev):
                break
            prev = nrm
            b, t = _gs_sweep(Q, T, b, t)
            it += 1
        nrm = torch.linalg.vector_norm(b)
        Q[i], T[i] = b / nrm, t / nrm
    return Q, T


def orth_rows_cholesky(B: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """BB' = LL'; Q = L^{-1} B has orthonormal rows; T = L^{-1}."""
    L = torch.linalg.cholesky(B @ B.T)
    eye = torch.eye(B.shape[0], dtype=B.dtype, device=B.device)
    T = torch.linalg.solve_triangular(L, eye, upper=False)
    return T @ B, T


def orth_rows(B: torch.Tensor, method: str = "gs"):
    if method == "gs":
        return orth_rows_gs(B)
    if method == "gs_lingen":
        return orth_rows_gs_lingen(B)
    if method == "cholesky":
        return orth_rows_cholesky(B)
    if method in ("implicit", "inexact"):
        return B, torch.eye(B.shape[0], dtype=B.dtype, device=B.device)
    raise ValueError(f"unknown orthonormalization method {method!r}")


@dataclasses.dataclass
class BandOrthT(LinearOperator):
    """Implicit T = L^{-1} P from the band Cholesky P BB' P' = LL' (the row
    analog of the implicit Cholesky orthonormalization, permonmatorth.c:
    35-143): T B has orthonormal rows without a dense B, and an apply is
    one half substitution."""

    band: Any  # BandCholInv of the permuted BB' (one padded block)
    perm: torch.Tensor  # RCM ordering p: (Pv)_i = v[p_i]
    m_rows: int

    @property
    def shape(self):
        return (self.m_rows, self.m_rows)

    def _pad(self, v):
        pad = self.band.shape[0] - self.m_rows
        return torch.cat([v, v.new_zeros(pad)])

    def mv(self, x):
        """T x = L^{-1} (P x)."""
        return self.band.half_solve_lower(self._pad(x[self.perm]))[: self.m_rows]

    def rmv(self, y):
        """T' y = P' L^{-T} y; ``perm`` is a permutation, so the inverse
        is an indexed assignment."""
        u = self.band.half_solve_upper(self._pad(y))[: self.m_rows]
        out = torch.empty_like(y)
        out[self.perm] = u
        return out


def orth_rows_implicit_band(BE) -> Optional[Tuple[Any, BandOrthT]]:
    """Sparse implicit orthonormalization of a wide sparse constraint
    operator: BB' as a host sparse product, RCM and the block-tridiagonal
    Cholesky (:func:`~permon_tpu_torch.core.band.band_chol_single`), and
    (Q, T) with Q = Product((T, BE)) orthonormal by rows, never dense.
    None when BE has no sparse structure."""
    from ..core.band import band_chol_single
    from ..core.linop import Product, operator_device
    from .sparse_rows import to_scipy

    Bs = to_scipy(BE)
    if Bs is None:
        return None
    S = (Bs @ Bs.T).tocsr()
    dev = operator_device(BE)
    band, perm = band_chol_single(S, device=dev)
    T = BandOrthT(band=band, perm=torch.as_tensor(perm.copy(), dtype=torch.int64, device=dev),
                  m_rows=int(S.shape[0]))
    return Product((T, BE)), T


def orth_columns(A: torch.Tensor, method: str = "gs"):
    """Column variant: A = Q S with Q'Q = I; returns (Q, T) with Q = A T'."""
    Q, T = orth_rows(A.T, method)
    return Q.T, T
