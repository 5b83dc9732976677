"""DIA stencil operators — the port of ``Dia`` (:40-91), ``BlockDia`` and
``RegularizedBlockDia`` (:95-237) from :mod:`permon_tpu.core.dia`.

``Dia`` layout: ``data[d, i] = A[i, i + offsets[d]]``; ``BlockDia`` layout:
``data[s, d, i] = K_s[i, i + offsets[d]]`` (both row-aligned, zero padded at
the ends).  ``mv`` is ndiag shifted multiply-adds over slices of a
zero-padded x, the diagonals added in ``offsets`` order as in the JAX
package, so on the CPU the result is bitwise equal to it.  Plain torch ops:
in JAX this is the XLA lowering, no hand kernel is owed.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .. import as_torch_dtype, resolve_device
from .linop import LinearOperator


def _row_aligned(d, n: int) -> np.ndarray:
    """scipy dia is column-aligned (data[k, c] = A[c - off, c]); re-align to
    rows: out[k, i] = A[i, i + off]."""
    out = np.zeros((len(d.offsets), n), dtype=np.float64)
    for k, off in enumerate(int(o) for o in d.offsets):
        lo, hi = max(0, -off), min(n, n - off)
        out[k, lo:hi] = d.data[k, lo + off: hi + off]
    return out


@dataclasses.dataclass
class Dia(LinearOperator):
    data: torch.Tensor  # (ndiag, n) row-aligned diagonal values
    offsets: Tuple[int, ...]
    shape: Tuple[int, int]

    @classmethod
    def from_scipy(cls, a, device=None) -> "Dia":
        import scipy.sparse as sp

        dev = resolve_device(device)
        d = sp.dia_matrix(a.tocsr().todia())
        n = a.shape[0]
        return cls(data=torch.as_tensor(_row_aligned(d, n), device=dev),
                   offsets=tuple(int(o) for o in d.offsets), shape=(n, n))

    @property
    def nnz(self) -> int:
        return int(self.data.numel())

    def mv(self, x):
        n = x.shape[0]
        maxoff = max(max(abs(o) for o in self.offsets), 1)
        xp = torch.nn.functional.pad(x, (maxoff, maxoff))
        y = torch.zeros_like(x)
        for k, off in enumerate(self.offsets):
            y = y + self.data[k] * xp[maxoff + off: maxoff + off + n]
        return y

    def rmv(self, x):
        # A' has diagonals at -off with row-aligned values shifted by off
        n = self.n
        maxoff = max(max(abs(o) for o in self.offsets), 1)
        y = torch.zeros_like(x)
        for k, off in enumerate(self.offsets):
            contrib = torch.nn.functional.pad(self.data[k] * x, (maxoff, maxoff))
            y = y + contrib[maxoff - off: maxoff - off + n]
        return y

    def diagonal(self):
        if 0 in self.offsets:
            return self.data[self.offsets.index(0)]
        return torch.zeros(self.n, dtype=self.data.dtype, device=self.data.device)

    def todense(self):
        n = self.n
        out = torch.zeros((n, n), dtype=self.data.dtype, device=self.data.device)
        for k, off in enumerate(self.offsets):
            idx = torch.arange(max(0, -off), min(n, n - off), device=self.data.device)
            out[idx, idx + off] = self.data[k, idx]
        return out


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
        # one conversion per distinct object: equal blocks are often ONE
        # matrix (the problem generators cache them by box shape)
        aligned: dict = {}
        for b in blocks:
            if id(b) not in aligned:
                d = sp.dia_matrix(b.tocsr().todia())
                aligned[id(b)] = ([int(o) for o in d.offsets], _row_aligned(d, d.shape[0]))
        offsets = sorted({o for offs, _ in aligned.values() for o in offs})
        oidx = {o: k for k, o in enumerate(offsets)}
        data = np.zeros((ns, len(offsets), nlp))
        for s, b in enumerate(blocks):
            offs, rows = aligned[id(b)]
            data[s, [oidx[o] for o in offs], : rows.shape[1]] = rows
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

    def diagonal(self):
        if 0 in self.offsets:
            return self.data[:, self.offsets.index(0), :].reshape(-1)
        return torch.zeros(self.n, dtype=self.data.dtype, device=self.data.device)


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

    def diagonal(self):
        """The base diagonal plus q's diagonal at ``bi * NB + idx`` of each
        block.  A block's fixing dofs are distinct, so slot j adds to one
        dof per block: kf indexed adds over unique indices, in slot order
        (padded slots add q = 0), and no atomics on CUDA."""
        ns, _, nlp = self.base.data.shape
        d = self.base.diagonal().reshape(ns, nlp).clone()
        gidx = self.bi[:, None] * self.NB + self.idx  # (ns, kf) local dofs
        qd = torch.diagonal(self.q, dim1=1, dim2=2).to(d.dtype)
        rows = torch.arange(ns, device=d.device)
        for j in range(gidx.shape[1]):
            d[rows, gidx[:, j]] += qd[:, j]
        return d.reshape(-1)
