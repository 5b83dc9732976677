"""The QP problem object — the port of :class:`permon_tpu.qp.qp.QP`
(without box or inequality constraints):

    min 1/2 x'Ax - b'x   s.t.  BE x = cE

plus the nullspace basis R of A (for singular TFETI stiffness operators).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from .. import Struct


@dataclasses.dataclass
class QP(Struct):
    A: Any  # LinearOperator — the Hessian
    b: torch.Tensor  # rhs (objective is 1/2 x'Ax - b'x)
    x0: Optional[torch.Tensor] = None
    BE: Any = None  # equality constraint operator
    cE: Optional[torch.Tensor] = None
    R: Any = None  # operator whose columns span ker(A)
    pf: Any = None  # Projector over BE (the QPPF analog)
    #: reduction-promotion dtype for solver dots/norms (None = the vector dtype)
    dots_dtype: Optional[str] = None

    @property
    def n(self) -> int:
        return self.A.shape[1]

    def initial_vector(self) -> torch.Tensor:
        if self.x0 is not None:
            return self.x0.to(self.b.dtype)
        return torch.zeros_like(self.b)
