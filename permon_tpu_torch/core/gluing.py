"""Star-forest gluing operator — the port of :class:`permon_tpu.core.gluing.
Gluing` (the MATGLUING analog, reference: src/mat/impls/gluing/
gluing.c:47-159).

B is stored as leaves: entry t contributes ``vals[t] * u[dofs[t]]`` to dual
entry ``lams[t]``.  The JAX package reduces both directions with
``segment_sum`` (a scatter-add).  Here each direction is a plane-major
gather table built once on the host (:func:`~permon_tpu_torch.core.
extension.pack_planes`), applied by the gather kernel on a CUDA device:

- ``mv``  (B u):   row r of the dual sums its leaves in entry order;
- ``rmv`` (B'l):   dof j of the primal sums its leaves in entry order, two
  slots per dof in the table and the rest in its overflow planes.

Both reduce in the order the JAX package's sequential segment sum adds,
and neither uses an atomic, so the result is the same on every run.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .extension import GatherTable, pack_planes
from .linop import LinearOperator


@dataclasses.dataclass
class Gluing(LinearOperator):
    """B as leaves (host arrays) with its two device gather tables."""

    lams: np.ndarray  # (nnz,) int64 dual (root) indices
    dofs: np.ndarray  # (nnz,) int64 decomposed-primal (leaf) indices
    vals: np.ndarray  # (nnz,) float64
    m_dual: int
    n_primal: int
    gB: GatherTable = None  # mv table over the primal, pad = n_primal
    gBt: GatherTable = None  # rmv table over the dual, pad = m_dual

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.m_dual, self.n_primal)

    @classmethod
    def from_coo(cls, rows, cols, vals, m: int, n: int, device=None) -> "Gluing":
        """Leaves from COO; the gather tables go to ``device`` (None: the
        card).  The B' table keeps two slots per dof (a dof of a gluing has
        one row per other copy), the tail goes to its overflow planes."""
        lams = np.asarray(rows, dtype=np.int64)
        dofs = np.asarray(cols, dtype=np.int64)
        v = np.asarray(vals, dtype=np.float64)
        gi, gv, _ = pack_planes(lams, dofs.astype(np.int32), v, int(m), int(n))
        ti, tv, ov = pack_planes(dofs, lams.astype(np.int32), v, int(n), int(m),
                                 cap=2)
        return cls(lams=lams, dofs=dofs, vals=v, m_dual=int(m), n_primal=int(n),
                   gB=GatherTable.from_host(gi, gv, device, n_src=int(n)),
                   gBt=GatherTable.from_host(ti, tv, device, n_src=int(m), overflow=ov))

    def with_kernel(self, on: bool) -> "Gluing":
        """Route both tables through the CUDA kernel (True) or the plain
        PyTorch version (False)."""
        return self.replace(gB=self.gB.replace(kernel=bool(on)),
                            gBt=self.gBt.replace(kernel=bool(on)))

    def mv(self, u):
        """B u: leaf gather, multiply, root sum (SFReduce(SUM))."""
        return self.gB.apply(u)

    def rmv(self, lam):
        """B' lambda: root gather, multiply, leaf sum (gluing.c:47-81)."""
        return self.gBt.apply(lam)

    def todense(self):
        out = np.zeros((self.m_dual, self.n_primal))
        np.add.at(out, (self.lams, self.dofs), self.vals)
        return torch.as_tensor(out, device=self.gB.idx.device)
