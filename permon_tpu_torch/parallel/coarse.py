"""Redundancy-group coarse solve — the port of
:mod:`permon_tpu.parallel.coarse`, the ``-qppf_redundancy`` analog.

The reference redistributes the coarse problem GG' onto groups of ranks:
each group holds ONE full copy, stored and factored distributed across the
group's ranks (src/qppf/interface/qppf.c:182-183,
src/mat/impls/inv/matinv.c:551-575).  On the two-axis ('host', 'sd') mesh
one host group is one redundancy group: the (kc, kc) Cholesky factor L of
GG' is sharded by BLOCK ROWS over the group's 'sd' axis (each rank stores
kc/nsd rows) and replicated over 'host'.

The coarse solve (GG')^{-1} v is a blocked forward and backward
substitution: at step j the owner of block row j solves its (kb, kb)
diagonal block and the result reaches the group with one masked
``all_reduce`` over 'sd' (the other ranks add zeros), 2 * nsd
all_reduces of kb-vectors (2 kb in the backward sweep) per solve.  Every
sum has one nonzero term, so the result is the same on every rank of
every group, and equal to the replicated ``cho_solve`` up to the blocking
of the same f64 sums.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import Struct
from .dist import Mesh, all_reduce_sum


@dataclasses.dataclass
class RedundantCoarse(Struct):
    """Distributed coarse factor: ``mv(v) = (GG')^{-1} v`` with this rank's
    block row of the Cholesky factor (coarse.py:47-78)."""

    L: torch.Tensor  # (kb, nsd * kb) this rank's block row of the lower factor
    kc: int
    kb: int  # rows per rank
    nsd: int  # ranks per group
    mesh: Mesh
    axis: str

    @classmethod
    def create(cls, gram, mesh: Mesh, axis: str = "sd", device=None) -> "RedundantCoarse":
        """``gram``: the (kc, kc) SPD coarse matrix GG' (numpy, scipy sparse
        or a tensor).  Factored once on the host (the role of MUMPS'
        factorization of the redundant matrix, matinv.c:551-575), padded to
        nsd block rows with the identity; the rank keeps its block row on
        ``device`` (default: the mesh's)."""
        import scipy.sparse as sp

        if isinstance(gram, torch.Tensor):
            gram = gram.cpu().numpy()
        S = np.asarray(gram.toarray() if sp.issparse(gram) else gram, dtype=np.float64)
        kc = S.shape[0]
        nsd = mesh.axis_size(axis)
        kb = max(-(-kc // nsd), 1)
        Sp = np.eye(nsd * kb)
        Sp[:kc, :kc] = S
        return cls.from_factor(np.linalg.cholesky(Sp), kc, mesh, axis, device)

    @classmethod
    def from_factor(cls, L, kc: int, mesh: Mesh, axis: str = "sd",
                    device=None) -> "RedundantCoarse":
        """From a full lower factor L (kcp, kcp) of the identity-padded GG'
        (kcp >= kc; padded again with the identity to a multiple of the
        group size)."""
        L = np.asarray(L, dtype=np.float64)
        nsd = mesh.axis_size(axis)
        kb = max(-(-L.shape[0] // nsd), 1)
        Lp = np.eye(nsd * kb)
        Lp[: L.shape[0], : L.shape[0]] = L
        j = mesh.axis_index(axis)
        dev = mesh.device if device is None else device
        return cls(L=torch.as_tensor(Lp[j * kb:(j + 1) * kb], device=dev), kc=int(kc),
                   kb=kb, nsd=nsd, mesh=mesh, axis=axis)

    def mv(self, v: torch.Tensor) -> torch.Tensor:
        """(GG')^{-1} v — replicated in, replicated out (coarse.py:80-125):
        per block row one triangular solve on its owner and one masked
        all_reduce over the group axis, forward then backward."""
        kc, kb, nsd, ax = self.kc, self.kb, self.nsd, self.axis
        my = self.mesh.axis_index(ax)
        L = self.L
        dt = L.dtype
        kcp = nsd * kb
        yp = torch.zeros(kcp, dtype=dt, device=L.device)
        yp[:kc] = v.to(dt)
        Ljj = L[:, my * kb:(my + 1) * kb]
        # forward: z = L^{-1} y; the owner of row j has its whole block row
        # and the replicated z of the rows before it
        z = torch.zeros(kcp, dtype=dt, device=L.device)
        for j in range(nsd):
            sl = slice(j * kb, (j + 1) * kb)
            zj = torch.zeros(kb, dtype=dt, device=L.device)
            if my == j:
                rhs = yp[sl] - L @ z
                zj = torch.linalg.solve_triangular(Ljj, rhs[:, None], upper=False)[:, 0]
            z[sl] = z[sl] + all_reduce_sum(zj, self.mesh, ax)
        # backward: x = L^{-T} z; the owner of row j adds its cross terms
        # L_j' x_j for the rows before it into a replicated carry
        x = torch.zeros(kcp, dtype=dt, device=L.device)
        acc = torch.zeros(kcp, dtype=dt, device=L.device)
        for j in reversed(range(nsd)):
            sl = slice(j * kb, (j + 1) * kb)
            both = torch.zeros(kb + kcp, dtype=dt, device=L.device)
            if my == j:
                xj = torch.linalg.solve_triangular(Ljj.T, (z[sl] - acc[sl])[:, None],
                                                   upper=True)[:, 0]
                both[:kb] = xj
                both[kb:] = L.T @ xj
            both = all_reduce_sum(both, self.mesh, ax)
            x[sl] = x[sl] + both[:kb]
            acc = acc + both[kb:]
        return x[:kc].to(v.dtype)


def redundant_projector(G, gram, mesh: Mesh, axis: str = "sd"):
    """A :class:`~permon_tpu_torch.qp.projector.Projector` whose coarse
    solve runs on redundancy groups (coarse.py:128-135)."""
    from ..qp.projector import Projector

    return Projector(G=G, ggt_chol=None, orthonormal_rows=False,
                     cp_dist=RedundantCoarse.create(gram, mesh, axis=axis))
