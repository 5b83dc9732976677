"""Batched per-subdomain DIA stencil operator — the port of ``BlockDia``
and ``RegularizedBlockDia`` from :mod:`permon_tpu.core.dia` (:95-237).

Layout: ``data[s, d, i] = K_s[i, i + offsets[d]]`` (row-aligned, zero
padded at the ends).  ``mv`` is ndiag shifted multiply-adds over an
(ns, nlp) view, the same order of adds as the JAX package, so on the CPU
the result is bitwise equal to it.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .. import as_torch_dtype, resolve_device
from .linop import LinearOperator


@dataclasses.dataclass
class BlockDia(LinearOperator):
    data: torch.Tensor  # (ns, ndiag, nlp)
    offsets: Tuple[int, ...]
    shape: Tuple[int, int]

    @classmethod
    def from_scipy_blocks(cls, blocks, nlp: int = None, dtype=None,
                          device=None) -> "BlockDia":
        """Build from a list of scipy sparse (nl, nl) blocks, zero-padding
        each to nlp rows (padding dofs get a unit diagonal).  ``dtype`` is
        a torch or numpy float dtype (default float64)."""
        import scipy.sparse as sp

        dev = resolve_device(device)
        ns = len(blocks)
        nl = blocks[0].shape[0]
        nlp = nl if nlp is None else int(nlp)
        dias = [sp.dia_matrix(b.tocsr().todia()) for b in blocks]
        offsets = sorted({int(o) for d in dias for o in d.offsets})
        oidx = {o: k for k, o in enumerate(offsets)}
        data = np.zeros((ns, len(offsets), nlp))
        for s, d in enumerate(dias):
            n = d.shape[0]
            for j, off in enumerate(int(o) for o in d.offsets):
                k = oidx[off]
                lo, hi = max(0, -off), min(n, n - off)
                # scipy dia is column-aligned: data[j, c] = A[c - off, c]
                data[s, k, lo:hi] = d.data[j, lo + off: hi + off]
        if 0 in oidx:  # unit diagonal on padding rows
            data[:, oidx[0], nl:] = 1.0
        tdt = as_torch_dtype(dtype) or torch.float64
        return cls(data=torch.as_tensor(data, dtype=tdt, device=dev), offsets=tuple(offsets),
                   shape=(ns * nlp, ns * nlp))

    @property
    def ns(self) -> int:
        return int(self.data.shape[0])

    @property
    def nlp(self) -> int:
        return int(self.data.shape[2])

    def mv(self, x):
        ns, ndiag, nlp = self.data.shape
        xb = x.reshape(ns, nlp).to(self.data.dtype)
        maxoff = max(max(abs(o) for o in self.offsets), 1)
        xp = torch.nn.functional.pad(xb, (maxoff, maxoff))
        y = torch.zeros_like(xb)
        for k, off in enumerate(self.offsets):
            y = y + self.data[:, k, :] * xp[:, maxoff + off: maxoff + off + nlp]
        return y.reshape(-1).to(x.dtype)

    rmv = mv  # symmetric stiffness blocks


@dataclasses.dataclass
class RegularizedBlockDia(LinearOperator):
    """Kreg = K + per-block rho * R_I (R_I'R_I)^{-1} R_I' as the ORIGINAL
    stencil plus an explicit rank-k fixing-dof correction (never folded
    into the stencil planes; the factor loop injects it into one diagonal
    block per subdomain, core/band.factor_from_dia_sm)."""

    base: BlockDia
    idx: torch.Tensor  # (ns, kf) int64 fixing dofs relative to block row bi
    q: torch.Tensor  # (ns, kf, kf) rho * Q per block (zero for fixed blocks)
    bi: torch.Tensor  # (ns,) int64 band-block index of each fixing window
    NB: int

    @property
    def shape(self):
        return self.base.shape

    @property
    def data(self):
        return self.base.data

    @property
    def offsets(self):
        return self.base.offsets

    def _corr(self, x):
        ns, _, nlp = self.base.data.shape
        xb = x.reshape(ns, nlp)
        gidx = self.bi[:, None] * self.NB + self.idx  # (ns, kf) local dofs
        g = torch.gather(xb, 1, gidx).to(self.q.dtype)
        h = torch.einsum("sij,sj->si", self.q, g)
        # the fixing dofs of one block are distinct (padded slots carry
        # q = 0), so this scatter-add has no competing real writes
        out = torch.zeros_like(xb).scatter_add_(1, gidx, h.to(xb.dtype))
        return out.reshape(-1)

    def mv(self, x):
        return self.base.mv(x) + self._corr(x).to(x.dtype)

    rmv = mv  # symmetric

