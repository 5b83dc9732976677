"""Conjugate gradients and projected preconditioned CG (PCPG) — the port
of :func:`permon_tpu.solvers.cg.cg` and ``pcpg`` (reference: src/qps/impls/ksp/qpsksp.c,
src/qps/impls/pcpg/pcpg.c: w = P r, z = M w, y = P z, the CG recurrence on
the projected quantities).

The JAX ``lax.while_loop`` becomes a Python loop with ONE host read per
iteration: the residual norm and the breakdown flag of the previous step
come back together and feed :func:`converged_default` (and the
``monitor`` line, which so costs no read of its own).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from .. import Struct
from ..core import detred
from ..core.convergence import ConvergedReason, Tolerances, converged_default
from ..qp.qp import QP
from ..sys.tracing import trace


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
       project: Optional[Callable] = None, monitor: bool = False,
       history: int = 0) -> CGResult:
    """(Projected, preconditioned) CG on 1/2 x'Ax - b'x.  With ``project``
    = P this is PCPG with reprojection every iteration (pcpg.c:51-134);
    convergence is tested on ||P r||.  ``precond`` = M gives z = M w and,
    being applied, a second projection y = P z.  ``monitor`` prints
    ``{it:>3} CG ||Pr||={rnorm:.10e}`` before each convergence test, as
    the JAX package does.  ``history`` > 0 records that many residual
    norms.  The whole call is the span ``cg.solve``, each turn of its loop
    ``cg.iteration`` (iterations + 1 turns), each host read ``cg.read``
    (iterations + 3)."""
    with trace("cg.solve"):
        return _cg(qp, tol, precond, project, monitor, history)


def _cg(qp, tol, precond, project, monitor, history) -> CGResult:
    from ..core.precision import dot_bundler, reducers

    A, b = qp.A, qp.b
    vdot, vnorm = reducers(qp.dots_dtype)
    vdots = dot_bundler(qp.dots_dtype)
    fuse = qp.dots_dtype is not None or detred.enabled()
    x = qp.initial_vector()

    with trace("cg.read"):
        norm_rhs = float(vnorm(b))
    ttol = max(tol.rtol * norm_rhs, tol.atol)
    P = project if project is not None else (lambda v: v)
    nh = int(history)

    def precondition(w):
        return P(precond(w)) if precond is not None else w

    r = b - A.mv(x)
    w = P(r)
    y = precondition(w)
    p = y
    rdtype = getattr(torch, qp.dots_dtype) if qp.dots_dtype else b.dtype
    hist = torch.full((max(nh, 1),), float("nan"), dtype=rdtype, device=b.device)
    if fuse:
        wz, rn2 = vdots([(w, y), (w, w)])
    else:
        wz, rn2 = vdot(w, y), None
    broke = torch.zeros((), dtype=torch.bool, device=b.device)
    it, nmv, reason = 0, 1, 0
    while True:
        # one span a turn: the read, the convergence test and the update
        with trace("cg.iteration"):
            rnorm_t = torch.sqrt(rn2.real) if fuse else vnorm(w)
            # the one host read of the iteration: ||Pr|| and the last step's
            # breakdown flag
            with trace("cg.read"):
                rnorm, broke_h = torch.stack([rnorm_t.to(torch.float64),
                                              broke.to(torch.float64)]).tolist()
            if broke_h:
                # breakdown a la KSPSolve_CG: nonpositive or non-finite
                # curvature — the iterate was kept, stop with CONVERGED_ATOL
                reason = int(ConvergedReason.CONVERGED_ATOL)
                break
            if monitor:
                print(f"{it:>3} CG ||Pr||={rnorm:.10e}")
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
            y = precondition(w)
            if fuse:
                wz2, rn2 = vdots([(w, y), (w, w)])
            else:
                wz2 = vdot(w, y)
            beta = torch.where(broke, torch.zeros_like(wz2), wz2 / wz).to(x.dtype)
            p = y + beta * p
            wz = wz2
            it += 1
            nmv += 1
    with trace("cg.read"):
        rnorm = float(vnorm(w))
    return CGResult(x=x, reason=int(reason), iterations=it, rnorm=rnorm,
                    nmv=nmv, rnorm_history=hist if nh else None)


def pcpg(qp: QP, tol: Tolerances = Tolerances(), precond: Optional[Callable] = None,
         monitor: bool = False) -> CGResult:
    """PCPG, projected preconditioned CG for an equality-constrained QP
    (the QPSPCPG solver type, reference: src/qps/impls/pcpg/pcpg.c).  A
    nonzero cE is homogenized away first, as QPSSolve_PCPG does
    (pcpg.c:32-41); the projector onto ker BE comes from the QP's projector
    factory, and the preconditioner sits inside the sandwich y = P M P r."""
    if qp.BE is None:
        raise ValueError("PCPG requires linear equality constraints")
    from ..qp.transforms import Solution, ensure_pf, homogenize_eq

    qp = ensure_pf(qp)
    post = None
    if qp.cE is not None:
        qp, post = homogenize_eq(qp)
        qp = ensure_pf(qp)
    res = cg(qp, tol=tol, precond=precond, project=qp.pf.apply_p, monitor=monitor)
    if post is not None:
        res = res.replace(x=post(Solution(x=res.x)).x)
    return res
