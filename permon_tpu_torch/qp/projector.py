"""Projector factory — the port of :mod:`permon_tpu.qp.projector` (the QPPF
analog, reference: src/qppf/interface/qppf.c):

    Q      = G' (G G')^{-1} G      (projector onto im G')
    P      = I - Q                 (projector onto ker G)
    halfQ  : x  -> (G G')^{-1} G x
    halfQ' : v  -> G' (G G')^{-1} v
    CP     : v  -> (G G')^{-1} v   (the coarse-problem solve)

G has few rows (one per floating subdomain on the TFETI dual), so GG' is
a small dense SPD matrix factorized once by Cholesky; from
``EXPLICIT_INV_MIN_K`` rows on, the dense-Gram path assembles (GG')^{-1}
and applies it as a fixed-tree GEMV.  The sparse (band) GG' of the JAX
package (more than 2048 coarse rows) is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from .. import Struct, not_ported
from ..core.linop import Dense, LinearOperator

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
    dev = A.a.device if isinstance(A, Dense) else None
    xs = _probe_vecs(A.shape[0], _PROBE_TRIALS, dt, dev)
    return all(
        float(torch.linalg.vector_norm(A.mv(A.rmv(x)) - x))
        <= tol * float(torch.linalg.vector_norm(x))
        for x in xs
    )


def dense_rows(op: LinearOperator) -> torch.Tensor:
    """The dense (m, n) rows of a wide operator; only Dense is ported."""
    if isinstance(op, Dense):
        return op.a
    raise not_ported(f"dense_rows of {type(op).__name__} (a non-Dense coarse G)")


@dataclasses.dataclass
class Projector(Struct):
    G: Any  # LinearOperator (m, n)
    ggt_chol: Optional[torch.Tensor]  # None when rows are orthonormal
    orthonormal_rows: bool = False
    ggt_inv: Optional[torch.Tensor] = None

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
        if sparse:
            raise not_ported("the sparse (band-Cholesky) GG' factorization "
                             "(band_chol_single, more than 2048 coarse rows)")
        dev = G.a.device if isinstance(G, Dense) else None
        if gram is not None:
            import scipy.sparse as _sp

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
        back to the input dtype."""
        if self.orthonormal_rows:
            return v
        if self.ggt_inv is not None:
            if self.ggt_inv.shape[0] >= EXPLICIT_INV_MIN_K:
                from ..core.detred import det_sum

                return det_sum(self.ggt_inv * v[None, :].to(self.ggt_inv.dtype),
                               dim=-1).to(v.dtype)
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
        return x - self.apply_q(x)


@dataclasses.dataclass
class ProjOp(LinearOperator):
    """P = I - G'(GG')^{-1}G as a LinearOperator (QPPFCreateP, qppf.c:650)."""

    pf: Projector

    @property
    def shape(self):
        n = self.pf.G.shape[1]
        return (n, n)

    def mv(self, x):
        return self.pf.apply_p(x)

    rmv = mv  # orthogonal projector is symmetric
