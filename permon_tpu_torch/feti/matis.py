"""MATIS -> block-diagonal transform — the port of
:mod:`permon_tpu.feti.matis` (QPTMatISToBlockDiag, reference:
src/qp/interface/qptransform.c:2006-2148).

:class:`MatIS` is the unassembled finite-element operator y = sum_s P_s'
A_s P_s x: the restriction P_s is a gather by the local-to-global map
(padding reads 0), the local products one batched GEMV, and the sum of the
copies a fixed-order gather table over the flat copies (each global dof
adds its copies in ascending (subdomain, local index) order, two slots per
dof and the rest in overflow planes), applied by the gather kernel on a
CUDA device — where the JAX package scatter-adds (``.at[].add``).  The
transform :func:`matis_to_blockdiag` and :func:`feti_problem_from_matis`
carry on to :func:`~permon_tpu_torch.feti.solve.feti_solve`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..core.blockdiag import BlockDiagDense, _bmv
from ..core.extension import GatherTable, copy_sum_table
from ..core.linop import LinearOperator
from ..qp.qp import QP


@dataclasses.dataclass
class MatIS(LinearOperator):
    """Unassembled FE operator: y = sum_s P_s' A_s P_s x (the MATIS MatMult
    of KSPFETI's Amat, src/ksp/impls/feti/feti.c:98-123).  ``l2g`` entries
    of -1 mark padding dofs; their rows and columns of ``blocks`` carry
    only a diagonal, so they never reach the assembled product."""

    blocks: torch.Tensor  # (ns, nl, nl)
    l2g: torch.Tensor  # (ns, nl) int64, -1 = padding
    n_global: int
    copies: GatherTable  # the copy sum, see copy_sum_table
    l2g_c: torch.Tensor  # (ns, nl) int64, padding -> n_global (a zero slot)

    @classmethod
    def create(cls, blocks, l2g, n_global: Optional[int] = None, device=None) -> "MatIS":
        """From host arrays (put on ``device``, None: the card) or tensors."""
        dev = blocks.device if isinstance(blocks, torch.Tensor) else resolve_device(device)
        l2g_h = l2g.cpu().numpy() if isinstance(l2g, torch.Tensor) else np.asarray(l2g)
        l2g_h = l2g_h.astype(np.int64)
        if n_global is None:
            n_global = int(l2g_h.max()) + 1
        blocks = blocks if isinstance(blocks, torch.Tensor) else torch.tensor(
            np.asarray(blocks), device=dev)
        return cls(blocks=blocks,
                   l2g=torch.as_tensor(l2g_h, device=dev), n_global=int(n_global),
                   copies=copy_sum_table(l2g_h, n_global, dev),
                   l2g_c=torch.as_tensor(np.where(l2g_h >= 0, l2g_h, n_global), device=dev))

    @property
    def shape(self):
        return (self.n_global, self.n_global)

    def with_kernel(self, on: bool) -> "MatIS":
        """Route the copy sum through the CUDA kernel (True) or the plain
        PyTorch version (False)."""
        return self.replace(copies=self.copies.replace(kernel=bool(on)))

    def _restrict(self, x):
        return torch.cat([x, x.new_zeros(1)])[self.l2g_c]  # (ns, nl), padding reads 0

    def _assemble(self, y_loc):
        return self.copies.apply(y_loc.reshape(-1))

    def mv(self, x):
        return self._assemble(_bmv(self.blocks, self._restrict(x)))

    def rmv(self, x):
        return self._assemble(_bmv(self.blocks.transpose(1, 2), self._restrict(x)))

    def todense(self):
        eye = torch.eye(self.n_global, dtype=self.blocks.dtype, device=self.blocks.device)
        return torch.stack([self.mv(eye[:, j]) for j in range(self.n_global)], dim=1)


@dataclasses.dataclass
class MatISCtx:
    """The FETI-ctx analog on the child QP (qptransform.c:2120-2127): the
    l2g map and the interface / interior index sets derived from it."""

    l2g: np.ndarray  # (ns, nl)
    multiplicity: np.ndarray  # (n_global,)
    i2g: np.ndarray  # global ids of interface dofs (multiplicity >= 2), sorted
    interior: np.ndarray  # global ids of interior dofs (multiplicity == 1)
    interface_masks: np.ndarray  # (ns, nl) bool, local interface dofs


def _multiplicity(l2g: np.ndarray, n_global: int) -> np.ndarray:
    real = l2g >= 0
    return np.bincount(l2g[real], minlength=n_global).astype(np.float64)


def matis_ctx(l2g, n_global: Optional[int] = None) -> MatISCtx:
    """Interface / interior scan of the l2g map (qptransform.c:2050-2100):
    a dof is interface iff more than one subdomain holds a copy."""
    l2g = np.asarray(l2g)
    if n_global is None:
        n_global = int(l2g.max()) + 1
    mult = _multiplicity(l2g, n_global)
    masks = (l2g >= 0) & (mult[np.clip(l2g, 0, n_global - 1)] >= 2)
    return MatISCtx(l2g=l2g, multiplicity=mult, i2g=np.flatnonzero(mult >= 2),
                    interior=np.flatnonzero(mult == 1), interface_masks=masks)


def decompose_vec(v_global, l2g, mult=None, scale: bool = True) -> np.ndarray:
    """Split a global vector onto the dof copies: ``scale=True`` gives each
    copy v / multiplicity (the D-scaled rhs, whose copy sum is v,
    qptransform.c:2097-2115), ``scale=False`` plain copies."""
    v_global = np.asarray(v_global)
    l2g = np.asarray(l2g)
    if mult is None:
        mult = _multiplicity(l2g, v_global.shape[0])
    out = np.zeros(l2g.shape, dtype=v_global.dtype)
    real = l2g >= 0
    vals = v_global[l2g[real]]
    if scale:
        vals = vals / mult[l2g[real]]
    out[real] = vals
    return out


def assemble_vec(u_decomposed, l2g, n_global: int, average: bool = True) -> np.ndarray:
    """A global vector from the dof copies, averaged (solution reassembly)
    or summed (rhs); on the host, each dof's copies added in flat order."""
    l2g = np.asarray(l2g)
    u = np.asarray(u_decomposed).reshape(l2g.shape)
    real = l2g >= 0
    out = np.zeros(n_global, dtype=u.dtype)
    np.add.at(out, l2g[real], u[real])
    if average:
        out /= np.maximum(np.bincount(l2g[real], minlength=n_global), 1.0)
    return out


def matis_to_blockdiag(qp: QP, check_residual: bool = False, residual_rtol: float = 1e-5):
    """QPTMatISToBlockDiag (qptransform.c:2006-2148): ``qp.A`` a
    :class:`MatIS`; returns ``(child, post_solve, ctx)``, the child on the
    decomposed space (BlockDiagDense Hessian, D-scaled rhs, the initial
    vector scattered to the copies) and ``ctx`` the l2g / i2g context.
    ``check_residual`` checks ||Ax - b|| / ||b|| of the reassembled solution
    on the parent operator and raises past ``residual_rtol``
    (-qpt_matis_to_diag_norm, qptransform.c:1958-1976)."""
    if not isinstance(qp.A, MatIS):
        raise TypeError("matis_to_blockdiag needs a MatIS Hessian")
    if qp.BE is not None or qp.BI is not None:
        raise ValueError("apply matis_to_blockdiag at the top of the chain (the reference "
                         "requires the KSPFETI Amat before constraints are added)")
    A_is: MatIS = qp.A
    dev = A_is.blocks.device
    l2g = A_is.l2g.cpu().numpy()
    ctx = matis_ctx(l2g, A_is.n_global)
    b_global = qp.b.cpu().numpy()
    b_loc = decompose_vec(b_global, l2g, ctx.multiplicity, scale=True)
    x0 = None
    if qp.x0 is not None:
        x0 = torch.as_tensor(decompose_vec(qp.x0.cpu().numpy(), l2g, ctx.multiplicity,
                                           scale=False).reshape(-1), device=dev)
    child = qp.replace(A=BlockDiagDense(blocks=A_is.blocks),
                       b=torch.as_tensor(b_loc.reshape(-1), device=dev), x0=x0)

    from ..qp.transforms import Solution

    def post(sol: Solution) -> Solution:
        x_global = assemble_vec(sol.x.cpu().numpy(), l2g, A_is.n_global, average=True)
        if check_residual:
            r = A_is.mv(torch.as_tensor(x_global, device=dev)).cpu().numpy() - b_global
            rnorm, bnorm = float(np.linalg.norm(r)), float(np.linalg.norm(b_global))
            if rnorm > residual_rtol * max(bnorm, 1.0):
                raise RuntimeError(
                    f"MatIS reassembly check failed: ||Ax-b|| = {rnorm:.3e} "
                    f"> {residual_rtol:g} * ||b|| = {residual_rtol * bnorm:.3e}")
        return sol.replace(x=torch.as_tensor(x_global, device=dev), lambda_E=None,
                           lambda_I=None, Bt_lambda=None, g=None)

    return child, post, ctx


def feti_problem_from_matis(A_is: MatIS, b_global, dirichlet=None, dirichlet_values=None,
                            dirichlet_numtype: str = "global_undecomposed", coords=None):
    """Continue the KSPFETI setup from a MATIS operator: run
    :func:`matis_to_blockdiag` and package the decomposed data as a
    :class:`~permon_tpu_torch.feti.assembly.FetiProblem` for
    :func:`~permon_tpu_torch.feti.solve.feti_solve`.  Returns ``(prob,
    post_solve, ctx)``: ``post_solve`` reassembles a decomposed solution with
    the ||Ax - b|| check; ``FetiResult.x_global`` is the same average."""
    from .assembly import FetiProblem

    dev = A_is.blocks.device
    qp = QP(A=A_is, b=torch.as_tensor(np.asarray(b_global, dtype=np.float64), device=dev))
    child, post, ctx = matis_to_blockdiag(qp, check_residual=True)
    ns, nl = A_is.l2g.shape
    prob = FetiProblem(
        K_blocks=A_is.blocks.cpu().numpy(),
        b_loc=child.b.cpu().numpy().reshape(ns, nl),
        l2g=A_is.l2g.cpu().numpy(),
        dirichlet=(np.asarray(dirichlet, dtype=np.int64) if dirichlet is not None
                   else np.array([], dtype=np.int64)),
        dirichlet_values=dirichlet_values,
        dirichlet_numtype=dirichlet_numtype,
        coords=coords,
    )
    return prob, post, ctx
