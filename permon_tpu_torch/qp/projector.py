"""Projector factory — the port of :mod:`permon_tpu.qp.projector` (the QPPF
analog, reference: src/qppf/interface/qppf.c):

    Q      = G' (G G')^{-1} G      (projector onto im G')
    P      = I - Q                 (projector onto ker G)
    halfQ  : x  -> (G G')^{-1} G x
    halfQ' : v  -> G' (G G')^{-1} v
    CP     : v  -> (G G')^{-1} v   (the coarse-problem solve)

G has few rows (one per rigid-body mode of a floating subdomain on the
TFETI dual), so GG' is a small dense SPD matrix factorized once by
Cholesky; from ``EXPLICIT_INV_MIN_K`` rows on, the dense-Gram path
assembles (GG')^{-1} and applies it as a fixed-tree GEMV.  Past
``SPARSE_GGT_THRESHOLD`` rows (a decomposition into thousands of
subdomains), or with ``sparse=True``, a sparse-structured GG' is
RCM-ordered and factorized as a band
(:func:`~permon_tpu_torch.core.band.band_chol_single`); the coarse solve is
then permute, pad, two band substitution loops, un-permute.  With
``cp_dist`` (a :class:`~permon_tpu_torch.parallel.coarse.RedundantCoarse`,
the ``-qppf_redundancy`` analog) the coarse solve runs on redundancy groups
of ranks and takes precedence over the local factors.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

from .. import Struct
from ..core.linop import Dense, LinearOperator, operator_device
from ..sys.tracing import trace

SPARSE_GGT_THRESHOLD = 2048
EXPLICIT_INV_MIN_K = 256
_PROBE_TRIALS = 3


def _probe_vecs(n: int, trials: int, dtype, device, seed: int = 7):
    """Seeded numpy probe vectors (the JAX package draws them with
    jax.random; only the boolean answer of the probes has to agree)."""
    rs = np.random.RandomState(seed)
    return torch.as_tensor(rs.standard_normal((trials, n)), dtype=dtype, device=device)


def has_orthonormal_rows(A, tol: float = 1e-10) -> bool:
    """Random-trial test A A' x == x (MatHasOrthonormalRows,
    permonmatorth.c:525-590)."""
    dt = A.a.dtype if isinstance(A, Dense) else torch.float64
    xs = _probe_vecs(A.shape[0], _PROBE_TRIALS, dt, operator_device(A))
    return all(
        float(torch.linalg.vector_norm(A.mv(A.rmv(x)) - x))
        <= tol * float(torch.linalg.vector_norm(x))
        for x in xs
    )


def dense_rows(op: LinearOperator, dtype=None) -> torch.Tensor:
    """A wide operator (few rows) as a dense (m, n) tensor: op' applied to
    the m unit vectors, row i = G[i, :] (MatTransposeMatMultByColumns,
    permonmatutils.c).  Dense operators give their array as it is."""
    if isinstance(op, Dense):
        return op.a if dtype is None else op.a.to(dtype)
    eye = torch.eye(op.shape[0], dtype=dtype or torch.float64, device=operator_device(op))
    return torch.stack([op.rmv(e) for e in eye])


@dataclasses.dataclass
class Projector(Struct):
    G: Any  # LinearOperator (m, n)
    ggt_chol: Optional[torch.Tensor]  # None when rows are orthonormal
    orthonormal_rows: bool = False
    ggt_inv: Optional[torch.Tensor] = None
    #: sparse-path coarse factorization: band Cholesky of the RCM-permuted
    #: GG' and the permutation (None on the dense path)
    ggt_band: Any = None
    cp_perm: Optional[torch.Tensor] = None
    #: redundancy-group distributed coarse factor (parallel/coarse.py)
    cp_dist: Any = None

    @classmethod
    def create(cls, G: LinearOperator, orthonormal_rows: Optional[bool] = None,
               explicit_inv: bool = False, sparse: Optional[bool] = None,
               gram=None) -> "Projector":
        """``gram`` supplies a precomputed host GG' (scipy sparse or dense),
        so G is never densified for the Gram (qptransform.c:1089-1100)."""
        if orthonormal_rows is None and gram is None:
            orthonormal_rows = has_orthonormal_rows(G)
        if orthonormal_rows:
            return cls(G=G, ggt_chol=None, orthonormal_rows=True)
        if sparse is None:
            sparse = G.shape[0] > SPARSE_GGT_THRESHOLD
        import scipy.sparse as _sp

        dev = operator_device(G)
        S = None  # the host sparse GG' of the band path
        if sparse and gram is not None and _sp.issparse(gram):
            S = gram.tocsr()
        elif sparse and gram is None:
            from .sparse_rows import to_scipy

            Gs = to_scipy(G)  # None for an operator without sparse rows: dense below
            if Gs is not None:
                S = (Gs @ Gs.T).tocsr()
        if S is not None:
            from ..core.band import band_chol_single

            band, perm = band_chol_single(S, device=dev)
            return cls(G=G, ggt_chol=None, ggt_band=band,
                       cp_perm=torch.as_tensor(perm.copy(), dtype=torch.int64, device=dev))
        if gram is not None:
            g = gram.toarray() if _sp.issparse(gram) else np.asarray(gram)
            ggt = torch.as_tensor(g, dtype=torch.float64, device=dev)
        else:
            from ..core.detred import gram as _gram

            ggt = _gram(dense_rows(G))  # fixed-tree reduction in deterministic mode
        chol = torch.linalg.cholesky(ggt)
        inv = None
        if explicit_inv or (gram is not None and ggt.shape[0] >= EXPLICIT_INV_MIN_K):
            eye = torch.eye(ggt.shape[0], dtype=ggt.dtype, device=ggt.device)
            inv = torch.cholesky_solve(eye, chol)
        return cls(G=G, ggt_chol=chol, orthonormal_rows=False, ggt_inv=inv)

    def apply_cp(self, v):
        """Coarse-problem solve (GG')^{-1} v (QPPFApplyCP, qppf.c:610-645);
        the factor math runs at the factor's precision, the result is cast
        back to the input dtype; the span ``projector.apply_cp``."""
        with trace("projector.apply_cp"):
            if self.orthonormal_rows:
                return v
            if self.cp_dist is not None:
                return self.cp_dist.mv(v)
            if self.ggt_band is not None:
                m = self.G.shape[0]
                vp = torch.zeros(self.ggt_band.shape[0], dtype=v.dtype, device=v.device)
                vp[:m] = v[self.cp_perm]
                y = self.ggt_band.mv(vp)
                # cp_perm is a permutation: an indexed assignment, no accumulation
                out = torch.empty_like(v)
                out[self.cp_perm] = y[:m]
                return out
            if self.ggt_inv is not None:
                if self.ggt_inv.shape[0] >= EXPLICIT_INV_MIN_K:
                    from ..core.detred import det_sum

                    return det_sum(self.ggt_inv, -1,
                                   v[None, :].to(self.ggt_inv.dtype)).to(v.dtype)
                return (self.ggt_inv @ v.to(self.ggt_inv.dtype)).to(v.dtype)
            vc = v.to(self.ggt_chol.dtype)[:, None]
            return torch.cholesky_solve(vc, self.ggt_chol)[:, 0].to(v.dtype)

    def apply_half_q(self, x):
        return self.apply_cp(self.G.mv(x)).to(x.dtype)

    def apply_half_q_t(self, v):
        return self.G.rmv(self.apply_cp(v)).to(v.dtype)

    def apply_q(self, x):
        return self.G.rmv(self.apply_cp(self.G.mv(x))).to(x.dtype)

    def apply_p(self, x):
        with trace("projector.apply_p"):
            if self.G.shape[0] == self.G.shape[1]:
                # a square G of full row rank has ker G = {0}: P = 0 exactly.
                # x - Q x would leave round-off of the size of eps |x|, on which
                # a projected CG iterates (its curvature may come out positive)
                return torch.zeros_like(x)
            return x - self.apply_q(x)

    def apply_gtg(self, x):
        return self.G.rmv(self.G.mv(x))


@dataclasses.dataclass
class _SquareProjOp(LinearOperator):
    """An n x n symmetric operator made of a projector's applies."""

    pf: Projector

    @property
    def shape(self):
        n = self.pf.G.shape[1]
        return (n, n)

    def rmv(self, x):
        return self.mv(x)


@dataclasses.dataclass
class ProjOp(_SquareProjOp):
    """P = I - G'(GG')^{-1}G as a LinearOperator (QPPFCreateP, qppf.c:650)."""

    def mv(self, x):
        return self.pf.apply_p(x)


@dataclasses.dataclass
class QOp(_SquareProjOp):
    """Q = G'(GG')^{-1}G (QPPFCreateQ, qppf.c:650-718)."""

    def mv(self, x):
        return self.pf.apply_q(x)


@dataclasses.dataclass
class GtGOp(_SquareProjOp):
    """G'G (QPPFCreateGtG)."""

    def mv(self, x):
        return self.pf.apply_gtg(x)


@dataclasses.dataclass
class HalfQOp(LinearOperator):
    """(GG')^{-1}G: mv = halfQ, rmv = halfQ' (QPPFCreateHalfQ)."""

    pf: Projector

    @property
    def shape(self):
        return self.pf.G.shape

    def mv(self, x):
        return self.pf.apply_half_q(x)

    def rmv(self, v):
        return self.pf.apply_half_q_t(v)


class CachedProjector:
    """Wrapper adding the QPPF last-result cache (qppf.c:454-503: ApplyQ
    keeps the last (v, Qv) pair and returns it when the SAME vector object
    is applied again, which happens between consecutive transform stages),
    and the count of coarse-problem applications
    (QPPFGetNumberOfCPApplications)."""

    def __init__(self, pf: Projector):
        self.pf = pf
        self._last: Optional[Tuple[Any, Any]] = None
        self.cp_applications = 0
        self.hits = 0

    def apply_q(self, x):
        if self._last is not None and self._last[0] is x:
            self.hits += 1
            return self._last[1]
        out = self.pf.apply_q(x)
        self.cp_applications += 1
        self._last = (x, out)
        return out

    def apply_p(self, x):
        with trace("projector.apply_p"):
            if self.pf.G.shape[0] == self.pf.G.shape[1]:
                return torch.zeros_like(x)  # ker G = {0}, as Projector.apply_p
            return x - self.apply_q(x)

    def apply_half_q(self, x):
        self.cp_applications += 1
        return self.pf.apply_half_q(x)

    def apply_half_q_t(self, v):
        self.cp_applications += 1
        return self.pf.apply_half_q_t(v)
