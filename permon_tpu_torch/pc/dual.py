"""Dual preconditioner for the FETI dual operator F = B K+ B' — the port of
:class:`permon_tpu.pc.dual.PCDual` (the PCDUAL analog, reference:
src/pc/impls/dual/pcdual.c).

Types (pcdual.c:9-14, enum none/lumped):
- ``none``:   identity (VecCopy apply, pcdual.c:85-91);
- ``lumped``: M = B K B' applied as y = B(K(B'x)) using the original (not
  inverted) stiffness — the classical lumped FETI preconditioner
  (pcdual.c:63-78).

When the surrounding pipeline projects onto ker G, wrap with ``projected``
to get P∘M (or the symmetric P∘M∘P with ``symmetric=True``), exactly like
PCCreate_QPTEnforceEqByProjector (qptransform.c:154-183).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

from ..core.linop import LinearOperator

PC_TYPES = ("none", "lumped")


@dataclasses.dataclass
class PCDual(LinearOperator):
    """Preconditioner operator in the dual (link) space."""

    B: Any  # the gluing/constraint operator (m, N)
    K: Optional[Any] = None  # the primal stiffness (N, N); None => type 'none'
    pc_type: str = "none"

    @classmethod
    def create(cls, B, K=None, pc_type: str = "none") -> "PCDual":
        if pc_type not in PC_TYPES:
            raise ValueError(f"pc_type {pc_type!r}: one of {PC_TYPES}")
        if pc_type == "lumped" and K is None:
            raise ValueError("lumped PCDual needs the stiffness operator K")
        return cls(B=B, K=K if pc_type == "lumped" else None, pc_type=pc_type)

    @property
    def shape(self):
        m = self.B.shape[0]
        return (m, m)

    def mv(self, x):
        if self.pc_type == "none":
            return x
        return self.B.mv(self.K.mv(self.B.rmv(x)))

    rmv = mv  # symmetric

    def projected(self, apply_p: Callable, symmetric: bool = False) -> Callable:
        """P∘M (or P∘M∘P) wrapper (qptransform.c:154-183)."""
        if self.pc_type == "none" and not symmetric:
            # pass-through fast path: pc 'none' composes to plain P
            return apply_p

        def apply(x):
            if symmetric:
                x = apply_p(x)
            return apply_p(self.mv(x))

        return apply
