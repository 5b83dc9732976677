"""SMALXE — SeMi-monotonic Augmented Lagrangian with adaptive M1/rho/eta.

The equality-constraint outer loop around an inner bound-constrained MPRGP
solve; the port of :func:`permon_tpu.solvers.smalxe.smalxe` (reference:
QPSSMALXE, src/qps/impls/smalxe/smalxe.c).  Each outer iteration solves the
penalized QP

    min 1/2 u'(A + rho B'B)u - (b - Btmu)'u   s.t. lb <= u <= ub

with MPRGP, then updates M1 / rho semi-monotonically.

The JAX package runs the outer loop as a ``lax.while_loop`` with rho, M1
and the multiplier as traced carries; here it is a Python loop.  The
scalars of the loop (rho, M1, eta, alpha, the inner maxeig, the
Lagrangian) stay 0-dim tensors on the device in the dtype the JAX package
makes them in, every product and quotient of them is taken there, and only
the decisions are made on the host, from values read back exactly.

Host reads: the inner test needs ||B u|| at every inner iteration.  It
hands MPRGP its device scalars (:meth:`_InnerTest.device_scalars`), which
ride in the first of MPRGP's two reads per iteration; the outer loop adds
two reads per outer iteration (the divergence threshold before the inner
solve, the Lagrangian flag after it).

Semantics mirrored for iteration-count parity:
- inner convergence test evaluated every inner iteration
  (QPSConverged_Inner_SMALXE, smalxe.c:612-692): recompute ||Bu||, set outer
  rnorm = max(E, G) with E = ||Bu||/rtol_E, set inner atol =
  min(M1*||Bu||, eta), check outer convergence from inside, inner-iteration
  budget = inner_max_it minus accumulated, gtol-based state 1 -> 3 transition,
- update rule (QPSSMALXEUpdate_SMALXE, smalxe.c:438-488): M1 /= M1_update only
  when L - (L_old + rho/2 ||Bu||^2) < threshold AND the inner solver stopped
  on the M1 criterion (ATOL); rho *= rho_update (state 1) or rho_update_late
  (state 3, Lagrangian condition waived) only when G <= E; MPRGP's maxeig /
  alpha are rescaled on rho updates (QPSMPGPUpdateMaxEigenvalue),
- multiplier update Btmu += rho_used * B'Bu before each inner solve and once
  after the loop (QPSSMALXEUpdateLambda_SMALXE + loop structure,
  smalxe.c:957-997),
- defaults M1 = 1e2*||A||, eta = 1e-1*||b||, rho = 1.1*||A||, M1_update 2,
  rho_update 1, rho_update_late 2, rtol_E 1 (smalxe.c:1159-1186).

As in the JAX package, the lagged ||Bu|| update
(-qps_smalxe_norm_update_lag*) is not ported.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from .. import Struct
from ..core.convergence import ConvergedReason, Tolerances, converged_default
from ..core.eig import max_eigenvalue
from ..core.linop import Penalized
from ..core.precision import reducers
from ..qp.qp import QP
from .mprgp import MPRGPOptions, mprgp


@dataclasses.dataclass(frozen=True)
class SMALXEOptions:
    M1: float = 1e2
    M1_direct: bool = False
    M1_update: float = 2.0
    eta: float = 1e-1
    eta_direct: bool = False
    rho: float = 1.1
    rho_direct: bool = False
    rho_update: float = 1.0
    rho_update_late: float = 2.0
    rtol_E: float = 1.0
    update_threshold: float = 0.0
    maxeig: Optional[float] = None
    maxeig_tol: float = 1e-4
    maxeig_iter: int = 50
    inject_maxeig: bool = False  # set True when BE has orthonormal rows
    #: explicit inner (penalized-operator) maxeig estimate, bypassing the
    #: power method
    maxeig_inner: Optional[Any] = None
    inner_iter_min: int = 1
    inner_no_gtol_stop: int = 0
    knoll: bool = False
    inner: MPRGPOptions = MPRGPOptions()
    inner_max_it: int = 10000
    monitor: bool = False
    #: per-outer-iteration Lagrangian/update report (the reference's
    #: -qps_smalxe_monitor_outer block, smalxe.c:453-461)
    monitor_outer: bool = False


@dataclasses.dataclass
class _InnerAux(Struct):
    """Context of the coupled inner/outer convergence test.  Tensors stay
    on the device; the floats were read back from tensors of the dtype the
    JAX package holds them in, so host comparisons decide as device
    comparisons would."""

    # constants for one inner solve
    M1: torch.Tensor
    eta: torch.Tensor
    rtol_E: torch.Tensor
    eta_h: float
    gtol: float
    ttol_outer: float
    atol_outer: float
    div_thresh: float  # divtol * ||b_inner||, the product taken on the device
    outer_it: int
    outer_max_it: int
    budget: int  # inner_max_it - inner_iter_accu
    inner_iter_min: int
    inner_no_gtol_stop: int
    # evolving
    state: int  # 1 or 3
    normBu: torch.Tensor
    outer_rnorm: torch.Tensor
    enorm: float = math.inf
    MNormBu: float = math.inf
    outer_reason: int = 0
    m1_hit: bool = False
    eta_hit: bool = False


@dataclasses.dataclass
class SMALXEResult(Struct):
    x: torch.Tensor
    reason: int
    iterations: int  # outer iterations
    inner_iterations: int
    rnorm: float  # outer max(G, E)
    normBu: float
    Bt_lambda: torch.Tensor  # B' mu (eq.-constraint multiplier premultiplied by B')
    rho: float
    M1: float
    M1_updates: int
    rho_updates: int
    M1_hits: int
    eta_hits: int
    # accumulated inner MPRGP statistics
    nmv: int
    ncg: int
    nexp: int
    nprop: int
    inner_reason: int
    #: per-OUTER-iteration max(G, E) buffer when called with ``history > 0``
    rnorm_history: Optional[torch.Tensor] = None


class _InnerTest:
    """The SMALXE inner convergence test (smalxe.c:612-692) in the two
    halves MPRGP's hook takes: :meth:`device_scalars` computes ||Bu|| and
    what follows from it on the device, MPRGP reads those values back with
    its own first read of the iteration, and :meth:`__call__` decides on
    the host."""

    def __init__(self, B, monitor, norm_fn):
        self.B, self.monitor, self.norm_fn = B, monitor, norm_fn

    def device_scalars(self, aux: _InnerAux, gnorm, u, g):
        normBu = self.norm_fn(self.B.mv(u))
        enorm = normBu / aux.rtol_E
        outer_rnorm = torch.maximum(enorm, gnorm.to(enorm.dtype))
        MNormBu = aux.M1 * normBu
        inner_atol = torch.minimum(MNormBu, aux.eta.to(MNormBu.dtype))
        aux = aux.replace(normBu=normBu, outer_rnorm=outer_rnorm)
        return aux, (enorm, outer_rnorm, MNormBu, inner_atol)

    def __call__(self, aux: _InnerAux, i, gnorm, u, g, scalars):
        enorm, outer_rnorm, MNormBu, inner_atol = scalars
        if self.monitor:
            print(f"  {i:>4}  G={gnorm:.8e}  E={enorm:.8e}  atol_inner={inner_atol:.8e}",
                  flush=True)
        # outer convergence checked from inside the inner loop
        outer_reason = converged_default(
            aux.outer_it, outer_rnorm, ttol=aux.ttol_outer, atol=aux.atol_outer,
            divtol=1.0, norm_rhs_div=aux.div_thresh, max_it=aux.outer_max_it)

        over_budget = i > aux.budget
        nan = math.isnan(gnorm) or math.isinf(gnorm)
        atol_stop = gnorm < inner_atol
        m1_crit = MNormBu < aux.eta_h

        # gtol-based stop / state 1 -> 3 transition.  The block is skipped
        # entirely while state==3 holds and the iteration floor / no-stop flag
        # applies (smalxe.c:673); gtol only counts when G <= E (smalxe.c:675-677)
        early_stop = over_budget or nan or outer_reason != 0 or atol_stop
        state3_wait = aux.state == 3 and (i < aux.inner_iter_min or aux.inner_no_gtol_stop > 0)
        gtol_hit = (not early_stop and not state3_wait
                    and gnorm <= aux.gtol and gnorm <= enorm)
        gtol_stop = gtol_hit and aux.inner_no_gtol_stop < 2

        if over_budget:
            reason = ConvergedReason.DIVERGED_ITS
        elif nan:
            reason = ConvergedReason.DIVERGED_NANORINF
        elif outer_reason > 0:
            reason = ConvergedReason.CONVERGED_HAPPY_BREAKDOWN  # KSPReason=7
        elif outer_reason < 0:
            reason = ConvergedReason.DIVERGED_BREAKDOWN  # -5
        elif atol_stop:
            reason = ConvergedReason.CONVERGED_ATOL
        elif gtol_stop:
            reason = ConvergedReason.CONVERGED_RTOL
        else:
            reason = ConvergedReason.ITERATING
        by_atol = reason == ConvergedReason.CONVERGED_ATOL
        aux = aux.replace(
            state=3 if gtol_hit else aux.state, enorm=enorm, MNormBu=MNormBu,
            # KSP_DIVERGED_BREAKDOWN propagated to the outer loop
            outer_reason=-5 if (over_budget or nan) else outer_reason,
            m1_hit=by_atol and m1_crit, eta_hit=by_atol and not m1_crit,
        )
        return int(reason), aux


def smalxe(qp: QP, opts: SMALXEOptions = SMALXEOptions(), tol: Tolerances = Tolerances(),
           projector_apply_P=None, history: int = 0) -> SMALXEResult:
    """Solve min 1/2 x'Ax - b'x s.t. BE x = 0 (+ box constraints).

    A nonzero cE must be homogenized away first (the reference auto-applies
    QPTHomogenizeEq in QPSSetUp_SMALXE, smalxe.c:771-779; ``solve`` does).
    ``projector_apply_P`` enables the Knoll initial guess u0 = P b.
    """
    if qp.BE is None:
        raise ValueError("SMALXE requires equality constraints")
    A, B, b = qp.A, qp.BE, qp.b
    vdot, vnorm = reducers(qp.dots_dtype)  # f64-promoted dots under 'mixed'
    dtype, dev = b.dtype, b.device
    rdtype = getattr(torch, qp.dots_dtype) if qp.dots_dtype else dtype

    def scalar(v, dt=dtype):
        if isinstance(v, torch.Tensor):
            return v.to(device=dev, dtype=dt)
        return torch.tensor(v, dtype=dt, device=dev)

    def ones():
        return torch.ones(A.shape[1], dtype=dtype, device=dev)

    # --- parameter initialization (QPSSetUp_SMALXE, smalxe.c:800-830) -------
    normb = vnorm(b)
    eta = scalar(opts.eta) if opts.eta_direct else opts.eta * normb
    need_maxeig = (not opts.M1_direct) or (not opts.rho_direct) or opts.inject_maxeig
    if opts.maxeig is not None:
        maxeig_A = scalar(opts.maxeig)
    elif need_maxeig:
        maxeig_A = max_eigenvalue(A, v0=ones(), tol=opts.maxeig_tol, maxits=opts.maxeig_iter)
    else:
        maxeig_A = scalar(0.0)
    M1 = scalar(opts.M1) if opts.M1_direct else opts.M1 * maxeig_A
    rho = scalar(opts.rho) if opts.rho_direct else opts.rho * maxeig_A

    gtol = scalar(tol.rtol * normb)
    ttol_outer = torch.clamp(tol.rtol * normb, min=tol.atol)
    gtol_h, ttol_outer_h, eta_h = torch.stack(
        [gtol.to(torch.float64), ttol_outer.to(torch.float64), eta.to(torch.float64)]).tolist()
    atol_outer_h = float(scalar(tol.atol))
    divtol = scalar(tol.divtol)
    rtol_E = scalar(opts.rtol_E)

    # inner MPRGP maxeig handling (smalxe.c:869-874): injected estimate
    # max(rho, maxeig_A) when G is orthonormal, else power method on the
    # penalized operator (computed once; rescaled on rho updates)
    if opts.maxeig_inner is not None:
        maxeig_inner = scalar(opts.maxeig_inner)
    elif opts.inject_maxeig:
        maxeig_inner = torch.maximum(rho, maxeig_A)
    else:
        maxeig_inner = max_eigenvalue(Penalized(a=A, b=B, rho=rho), v0=ones(),
                                      tol=opts.maxeig_tol, maxits=opts.maxeig_iter)
    alpha_user = 2.0 if opts.inner.alpha_user is None else opts.inner.alpha_user
    alpha = scalar(alpha_user) if opts.inner.alpha_direct else alpha_user / maxeig_inner

    inner_test = _InnerTest(B, opts.monitor, vnorm)

    u = qp.initial_vector()
    if opts.knoll and projector_apply_P is not None:
        u = projector_apply_P(b)

    def btbu(v):
        return B.rmv(B.mv(v))

    def lagrangian(v, b_inner, rho_):
        return 0.5 * vdot(v, Penalized(a=A, b=B, rho=rho_).mv(v)) - vdot(b_inner, v)

    # --- outer loop ---------------------------------------------------------
    Btmu = torch.zeros_like(b)
    rho_lambda = rho  # rho used in the last inner solve (for the Btmu update)
    state = 1
    Lag_old = lagrangian(u, b, rho)
    normBu = vnorm(B.mv(u))
    rnorm = scalar(math.inf, rdtype)
    it = accu = reason = inner_reason = 0
    m1_updates = rho_updates = m1_hits = eta_hits = 0
    nmv = ncg = nexp = nprop = 0
    nh = int(history)
    hist = torch.full((max(nh, 1),), float("nan"), dtype=rdtype, device=dev)

    while reason == 0:
        # multiplier update with the rho of the previous inner solve
        # (QPSSMALXEUpdateLambda_SMALXE)
        Btmu = Btmu + rho_lambda * btbu(u)
        b_inner = b - Btmu
        aux0 = _InnerAux(
            M1=M1, eta=eta, rtol_E=rtol_E, eta_h=eta_h, gtol=gtol_h,
            ttol_outer=ttol_outer_h, atol_outer=atol_outer_h,
            div_thresh=float(divtol * vnorm(b_inner)),
            outer_it=it, outer_max_it=tol.max_it, budget=opts.inner_max_it - accu,
            inner_iter_min=opts.inner_iter_min,
            inner_no_gtol_stop=opts.inner_no_gtol_stop,
            state=state, normBu=normBu, outer_rnorm=scalar(math.inf, rdtype),
        )
        qp_inner = qp.replace(A=Penalized(a=A, b=B, rho=rho), b=b_inner, x0=u,
                              BE=None, cE=None)
        res = mprgp(qp_inner, opts=opts.inner, conv_test=inner_test, conv_aux=aux0,
                    maxeig=maxeig_inner, alpha0=alpha)
        aux = res.aux
        u, it = res.x, it + 1

        # Lagrangian-based M1 / rho adaptation (QPSSMALXEUpdate_SMALXE)
        Lag = lagrangian(u, b_inner, rho)
        t = 0.5 * rho * aux.normBu**2
        d2 = Lag - (Lag_old + t)
        lag_flag = bool(d2 < opts.update_threshold)
        if opts.monitor_outer:
            L, d1, d2_h, t_h, rn = torch.stack(
                [v.to(torch.float64) for v in (Lag, Lag - Lag_old, d2, t, aux.outer_rnorm)]
            ).tolist()
            print(f"END   outer {it:>3}:  L={L:+.10e}  L-L_old={d1:+.3e}  "
                  f"L-(L_old+1/2*rho*||Bu||^2)={d2_h:+.3e} (flag={lag_flag})  "
                  f"1/2*rho*||Bu||^2={t_h:.3e}\n"
                  f"          max(G,E)={rn:.8e} ttol_outer={aux.ttol_outer:.8e}  |  "
                  f"G={res.rnorm:.8e} min(M1||Bu||,eta)={min(aux.MNormBu, eta_h):.8e}  |  "
                  f"gtol={aux.gtol:.8e}", flush=True)
        m1_do = (lag_flag and opts.M1_update != 1.0
                 and res.reason == ConvergedReason.CONVERGED_ATOL)
        rho_used = rho
        if m1_do:
            M1 = M1 / opts.M1_update

        # the state may have transitioned during this inner solve; the rho
        # update reads the CURRENT state (QPSSMALXEUpdateRho_SMALXE)
        state = aux.state
        rho_upd = opts.rho_update_late if state == 3 else opts.rho_update
        rho_flag = True if state == 3 else lag_flag
        rho_do = res.rnorm <= aux.enorm and rho_flag and rho_upd != 1.0
        # propagate to the inner MPRGP spectral data (QPSMPGPUpdateMaxEigenvalue)
        upd = rho_upd if rho_do else 1.0
        if rho_do:
            rho = rho * rho_upd
        maxeig_inner = maxeig_inner * upd
        alpha = res.alpha if opts.inner.alpha_direct else (res.alpha / upd).to(dtype)

        reason = aux.outer_reason
        if reason == 0 and it >= tol.max_it:
            reason = int(ConvergedReason.DIVERGED_ITS)
        if nh:
            hist[min(it - 1, nh - 1)] = aux.outer_rnorm
        rho_lambda, Lag_old, accu = rho_used, Lag, accu + res.iterations
        rnorm, normBu = aux.outer_rnorm, aux.normBu
        m1_updates += int(m1_do)
        rho_updates += int(rho_do)
        m1_hits += int(aux.m1_hit)
        eta_hits += int(aux.eta_hit)
        nmv, ncg, nexp, nprop = (nmv + res.nmv, ncg + res.ncg, nexp + res.nexp,
                                 nprop + res.nprop)
        inner_reason = res.reason

    # final multiplier update of the aborted iteration (smalxe.c:958-961)
    Bt_lambda = Btmu + rho_lambda * btbu(u)
    rnorm_h, normBu_h, rho_h, M1_h = torch.stack(
        [v.to(torch.float64) for v in (rnorm, normBu, rho, M1)]).tolist()
    return SMALXEResult(
        x=u, reason=int(reason), iterations=it, inner_iterations=accu,
        rnorm=rnorm_h, normBu=normBu_h, Bt_lambda=Bt_lambda, rho=rho_h, M1=M1_h,
        M1_updates=m1_updates, rho_updates=rho_updates, M1_hits=m1_hits,
        eta_hits=eta_hits, nmv=nmv, ncg=ncg, nexp=nexp, nprop=nprop,
        inner_reason=int(inner_reason),
        rnorm_history=hist if nh else None,
    )
