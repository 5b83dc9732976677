"""Conjugate gradients and projected CG (PCPG) — the port of
:func:`permon_tpu.solvers.cg.cg` (reference: src/qps/impls/ksp/qpsksp.c,
src/qps/impls/pcpg/pcpg.c).

The JAX ``lax.while_loop`` becomes a Python loop with ONE host read per
iteration: the residual norm and the breakdown flag of the previous step
come back together and feed :func:`converged_default`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from .. import Struct, not_ported
from ..core import detred
from ..core.convergence import ConvergedReason, Tolerances, converged_default
from ..qp.qp import QP


@dataclasses.dataclass
class CGResult(Struct):
    x: torch.Tensor
    reason: int
    iterations: int
    rnorm: float
    nmv: int
    #: per-iteration ||Pr|| (NaN past the last iteration) when history > 0
    rnorm_history: Optional[torch.Tensor] = None


def cg(qp: QP, tol: Tolerances = Tolerances(), precond: Optional[Callable] = None,
       project: Optional[Callable] = None, history: int = 0) -> CGResult:
    """(Projected) CG on 1/2 x'Ax - b'x.  With ``project`` = P this is
    PCPG with reprojection every iteration (pcpg.c:51-134); convergence
    is tested on ||P r||.  ``history`` > 0 records that many residual
    norms."""
    from ..core.precision import dot_bundler, reducers

    if precond is not None:
        raise not_ported("cg with a preconditioner (pc_dual='lumped')")
    A, b = qp.A, qp.b
    vdot, vnorm = reducers(qp.dots_dtype)
    vdots = dot_bundler(qp.dots_dtype)
    fuse = qp.dots_dtype is not None or detred.enabled()
    x = qp.initial_vector()

    norm_rhs = float(vnorm(b))
    ttol = max(tol.rtol * norm_rhs, tol.atol)
    P = project if project is not None else (lambda v: v)
    nh = int(history)

    r = b - A.mv(x)
    w = P(r)
    p = w
    rdtype = getattr(torch, qp.dots_dtype) if qp.dots_dtype else b.dtype
    hist = torch.full((max(nh, 1),), float("nan"), dtype=rdtype, device=b.device)
    if fuse:
        wz, rn2 = vdots([(w, w), (w, w)])
    else:
        wz, rn2 = vdot(w, w), None
    broke = torch.zeros((), dtype=torch.bool, device=b.device)
    it, nmv, reason = 0, 1, 0
    while True:
        rnorm_t = torch.sqrt(rn2.real) if fuse else vnorm(w)
        # the one host read of the iteration: ||Pr|| and the last step's
        # breakdown flag
        rnorm, broke_h = torch.stack([rnorm_t.to(torch.float64),
                                      broke.to(torch.float64)]).tolist()
        if broke_h:
            # breakdown a la KSPSolve_CG: nonpositive or non-finite
            # curvature — the iterate was kept, stop with CONVERGED_ATOL
            reason = int(ConvergedReason.CONVERGED_ATOL)
            break
        if nh:
            hist[min(it, nh - 1)] = rnorm_t
        reason = converged_default(it, rnorm, ttol=ttol, atol=tol.atol,
                                   divtol=tol.divtol, norm_rhs_div=norm_rhs,
                                   max_it=tol.max_it)
        if reason != 0:
            break
        Ap = A.mv(p)
        pAp = vdot(p, Ap)
        a = wz / pAp
        broke = torch.logical_not(torch.isfinite(a)) | (pAp <= 0.0)
        a = torch.where(broke, torch.zeros_like(a), a).to(x.dtype)
        x = x + a * p
        r = r - a * Ap
        w = P(r)
        if fuse:
            wz2, rn2 = vdots([(w, w), (w, w)])
        else:
            wz2 = vdot(w, w)
        beta = torch.where(broke, torch.zeros_like(wz2), wz2 / wz).to(x.dtype)
        p = w + beta * p
        wz = wz2
        it += 1
        nmv += 1
    return CGResult(x=x, reason=int(reason), iterations=it, rnorm=float(vnorm(w)),
                    nmv=nmv, rnorm_history=hist if nh else None)
