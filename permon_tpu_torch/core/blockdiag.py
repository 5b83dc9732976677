"""Block-diagonal operators — the port of :mod:`permon_tpu.core.blockdiag`
(the MATBLOCKDIAG analog, reference: src/mat/impls/blockdiag/
matblockdiag.c:190-233).

One dense block per subdomain, stored batched (ns, nl, nl), so the
product is one batched GEMV (``torch.bmm``) with no cross-block traffic.
The products run in the blocks' dtype with TF32 off (a TF32 product would
round f32 operands to 10 mantissa bits).  ``BlockColumns`` holds the
per-subdomain nullspace bases R = diag(R_1..R_s) with rectangular blocks.
"""

from __future__ import annotations

import dataclasses

import torch

from .band import _check_tf32
from .linop import LinearOperator


def _bmv(blocks: torch.Tensor, xb: torch.Tensor) -> torch.Tensor:
    """y[s] = blocks[s] @ xb[s], in the promoted dtype of both."""
    _check_tf32(blocks.device)
    dt = torch.promote_types(blocks.dtype, xb.dtype)
    return torch.bmm(blocks.to(dt), xb.to(dt).unsqueeze(-1)).squeeze(-1)


def _blockdiag_dense(blocks: torch.Tensor) -> torch.Tensor:
    """The (ns*r, ns*c) dense matrix with ``blocks`` (ns, r, c) on its diagonal."""
    return torch.block_diag(*blocks.unbind(0))


@dataclasses.dataclass
class BlockDiagDense(LinearOperator):
    """y = diag(K_1..K_s) x with equal-size dense blocks (ns, nl, nl)."""

    blocks: torch.Tensor

    @property
    def shape(self):
        ns, nl, _ = self.blocks.shape
        return (ns * nl, ns * nl)

    def mv(self, x):
        ns, nl, _ = self.blocks.shape
        return _bmv(self.blocks, x.reshape(ns, nl)).reshape(-1)

    def rmv(self, x):
        ns, nl, _ = self.blocks.shape
        return _bmv(self.blocks.transpose(1, 2), x.reshape(ns, nl)).reshape(-1)

    def diagonal(self):
        return torch.diagonal(self.blocks, dim1=1, dim2=2).reshape(-1)

    def todense(self):
        return _blockdiag_dense(self.blocks)


@dataclasses.dataclass
class BlockColumns(LinearOperator):
    """R = diag(R_1..R_s) with rectangular blocks (ns, nl, k): the
    per-subdomain nullspace bases; a subdomain without a nullspace carries
    zero columns."""

    blocks: torch.Tensor  # (ns, nl, k)

    @property
    def shape(self):
        ns, nl, k = self.blocks.shape
        return (ns * nl, ns * k)

    def mv(self, a):
        ns, nl, k = self.blocks.shape
        return _bmv(self.blocks, a.reshape(ns, k)).reshape(-1)

    def rmv(self, x):
        ns, nl, k = self.blocks.shape
        return _bmv(self.blocks.transpose(1, 2), x.reshape(ns, nl)).reshape(-1)

    def todense(self):
        return _blockdiag_dense(self.blocks)
