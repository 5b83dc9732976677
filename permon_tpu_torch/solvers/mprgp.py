"""MPRGP — Modified Proportioning with (Reduced) Gradient Projections.

The bound-constrained QP solver; the port of
:func:`permon_tpu.solvers.mprgp.mprgp` (reference: QPSMPGP,
src/qps/impls/mpgp/mpgp.c; algorithm: Kruzik, Horak, Cermak, Pospisil,
Pecha, "Active set expansion strategies in MPRGP algorithm", Advances in
Engineering Software 149 (2020)).

The JAX package runs the solve as one ``lax.while_loop`` with nested
``lax.cond``; here it is a Python loop in which only the branch taken runs
its Hessian product, so each iteration costs 1 product (CG, proportioning)
or 2 (expansion) and ``nmv`` equals the reference's count.  The three
decisions of an iteration need host values; they are made on the device in
the dtype the JAX package makes them in, and read in TWO host reads per
iteration: (||gP||, gc'gc <= gamma^2 gf'gf) at the top and
(acg <= afeas) after the product.

Semantics mirrored for iteration-count parity:
- convergence tested at the top of each iteration on ||gP|| (mpgp.c:514-534),
- proportionality test gc'gc <= gamma^2 * gf'gf (mpgp.c:538),
- expansion makes the maximal feasible half-step, re-splits gradients,
  computes the step length, steps along the expansion direction, and only
  projects when required (projection is skipped for the default std+fixed
  combination exactly as in QPSSetup_MPGP, mpgp.c:384-388),
- step length types fixed/opt/optapprox/bb (mpgp.c:226-287) and expansion
  direction types std/projcg/gf/g/gfgr/ggr (mpgp.c:3),
- optional fallback / fallback2 objective-increase rollback (mpgp.c:561-616),
- alpha = alpha_user / lambda_max with lambda_max from the deterministic
  all-ones power method unless supplied (mpgp.c:404-414).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from .. import Struct
from ..core import detred
from ..core.convergence import Tolerances, converged_default
from ..core.eig import max_eigenvalue
from ..core.precision import dot_bundler, reducers
from ..qp.qp import QP
from ..qpc.box import BoxConstraint

# step-type codes for the monitor (reference prints chars c/e/p/f)
_STEP_NONE, _STEP_CG, _STEP_EXP, _STEP_PROP, _STEP_FALL = 0, 1, 2, 3, 4
STEP_CHARS = {_STEP_NONE: " ", _STEP_CG: "c", _STEP_EXP: "e", _STEP_PROP: "p", _STEP_FALL: "f"}

EXPANSION_TYPES = ("std", "projcg", "gf", "g", "gfgr", "ggr")
EXPANSION_LENGTH_TYPES = ("fixed", "opt", "optapprox", "bb")


@dataclasses.dataclass(frozen=True)
class MPRGPOptions:
    """Static solver configuration (defaults per QPSCreate_MPGP, mpgp.c:826-846)."""

    gamma: float = 1.0
    alpha_user: Optional[float] = None  # None -> 2.0 (as a multiple of 1/maxeig)
    alpha_direct: bool = False  # True: alpha_user IS the step length
    maxeig: Optional[float] = None  # None -> power method
    maxeig_tol: float = 1e-4
    maxeig_iter: int = 50
    bchop_tol: float = 0.0
    expansion_type: str = "std"
    explength_type: str = "fixed"
    resetalpha: bool = False
    fallback: bool = False
    fallback2: bool = False
    monitor: bool = False
    monitor_cost: bool = False  # QPSMonitorCostFunction analog

    def __post_init__(self):
        if self.expansion_type not in EXPANSION_TYPES:
            raise ValueError(f"expansion_type {self.expansion_type!r}: one of {EXPANSION_TYPES}")
        if self.explength_type not in EXPANSION_LENGTH_TYPES:
            raise ValueError(f"explength_type {self.explength_type!r}: "
                             f"one of {EXPANSION_LENGTH_TYPES}")


@dataclasses.dataclass
class _State(Struct):
    x: torch.Tensor
    g: torch.Tensor  # g = A x - b
    p: torch.Tensor
    gf: torch.Tensor
    gc: torch.Tensor
    gr: torch.Tensor
    alpha: torch.Tensor
    step: int = _STEP_NONE  # last step-type code
    nmv: int = 1
    ncg: int = 0
    nexp: int = 0
    nprop: int = 0
    nfinc: int = 0
    nfall: int = 0


@dataclasses.dataclass
class MPRGPResult(Struct):
    x: torch.Tensor
    reason: int
    iterations: int
    rnorm: float
    nmv: int
    ncg: int
    nexp: int
    nprop: int
    nfinc: int
    nfall: int
    g: torch.Tensor  # final gradient A x - b (multiplier recovery reuses it)
    alpha: Optional[torch.Tensor] = None  # final step length (persists across SMALXE inner solves)
    #: per-iteration ||gP|| buffer when called with ``history > 0``
    #: (QPS residual history, qpsimpl.h:62-70)
    rnorm_history: Optional[torch.Tensor] = None
    aux: Any = None


def _grads_all(box, x, g, alpha):
    gf, gc = box.grads(x, g)
    gr = box.grad_reduced(x, gf, alpha)
    return gf, gc, gr


def mprgp(
    qp: QP,
    opts: MPRGPOptions = MPRGPOptions(),
    tol: Tolerances = Tolerances(),
    conv_test: Optional[Callable] = None,
    conv_aux: Any = (),
    maxeig: Optional[torch.Tensor] = None,
    alpha0: Optional[torch.Tensor] = None,
    history: int = 0,
) -> MPRGPResult:
    """Solve min 1/2 x'Ax - b'x s.t. lb <= x <= ub.

    ``conv_test(aux, it, rnorm, x, g) -> (reason, aux)`` may replace the
    default test (``it`` a Python int, ``rnorm`` a Python float, ``reason``
    an int) — SMALXE injects its coupled inner/outer test this way
    (reference: QPSConverged_Inner_SMALXE, smalxe.c:609-692).  A test that
    needs device values of its own has a method ``device_scalars(aux,
    rnorm_t, x, g) -> (aux, tuple of 0-dim tensors)``: those scalars come
    back in the first host read of the iteration, beside ||gP||, and the
    test is called as ``conv_test(aux, it, rnorm, x, g, floats)`` — no
    further synchronisation.  The loop knows this one protocol: a test
    without the method is wrapped once, with no scalars of its own.
    ``history`` > 0 records that many per-iteration ||gP|| values in a
    fixed-size device buffer surfaced as ``result.rnorm_history``.
    """
    A, b = qp.A, qp.b
    vdot, vnorm = reducers(qp.dots_dtype)  # f64-promoted dots under 'mixed'
    vdots = dot_bundler(qp.dots_dtype)  # fused same-point dot bundles
    # fuse the body's three reductions only when the bundle actually batches
    # (promoted or deterministic trees, bit-identical per row); the plain-f64
    # path keeps the library norm so oracle numerics are untouched
    fuse_body = qp.dots_dtype is not None or detred.enabled()
    dtype, dev = b.dtype, b.device
    if qp.box is None:
        # unbounded box: the algorithm degenerates to plain CG (no chopped
        # gradient, infinite feasible steps) — used by SMALXE for
        # equality-only QPs where the reference picks the KSP inner solver
        box = BoxConstraint.create(qp.n, dtype=dtype, device=dev)
    else:
        box = qp.box.chop_bounds(opts.bchop_tol)
    gamma2 = opts.gamma**2

    def scalar(v):
        """A 0-dim tensor of the vector dtype from a float or tensor (a
        float is rounded once, to ``dtype``, not through float32)."""
        if isinstance(v, torch.Tensor):
            return v.to(device=dev, dtype=dtype)
        return torch.tensor(v, dtype=dtype, device=dev)

    # --- alpha initialization (QPSSetup_MPGP, mpgp.c:404-414) ---------------
    alpha_user = 2.0 if opts.alpha_user is None else opts.alpha_user
    if opts.alpha_direct:
        alpha_init = scalar(alpha_user)
        maxeig_val = scalar(0.0) if maxeig is None else maxeig
    else:
        if maxeig is None:
            maxeig = (
                scalar(opts.maxeig)
                if opts.maxeig is not None
                else max_eigenvalue(A, v0=torch.ones(A.shape[1], dtype=dtype, device=dev),
                                    tol=opts.maxeig_tol, maxits=opts.maxeig_iter)
            )
        maxeig_val = scalar(maxeig)
        alpha_init = scalar(alpha_user / maxeig_val)
    if alpha0 is not None:
        alpha_init = scalar(alpha0)  # warm-started alpha (SMALXE)

    if conv_test is None:
        norm_rhs_t = vnorm(b)
        norm_rhs = float(norm_rhs_t)
        # ttol is made on the device in the reduction dtype, as the JAX
        # package makes it, and compared on the host
        ttol = float(torch.clamp(tol.rtol * norm_rhs_t, min=tol.atol))

        def conv_test(aux, it, rnorm, x, g):
            return (
                converged_default(it, rnorm, ttol=ttol, atol=tol.atol, divtol=tol.divtol,
                                  norm_rhs_div=norm_rhs, max_it=tol.max_it),
                aux,
            )

    # --- expansion direction / length-vector selectors (mpgp.c:384-414) -----
    et = opts.expansion_type
    # expdir: which split drives the expansion step; explv: which drives the length
    _sel = {"std": ("gr", "gr"), "gf": ("gf", "gf"), "g": ("g", "g"),
            "gfgr": ("gf", "gr"), "ggr": ("g", "gr"), "projcg": ("gf", "gf")}
    expdir_key, explv_key = _sel[et]
    expproject = not (et == "std" and opts.explength_type == "fixed")

    def pick(key, g, gf, gr):
        return {"g": g, "gf": gf, "gr": gr}[key]

    def length_from(dots0, dots1, alpha):
        bad = dots1 == 0.0
        reset = torch.logical_and(bad, torch.as_tensor(opts.resetalpha, device=dev))
        return torch.where(reset, (alpha / maxeig_val).to(dots0.dtype),
                           alpha_user * dots0 / dots1).to(alpha.dtype)

    def explength(alpha, x, g, gf, gr, dold, xold, nmv):
        """New alpha per MPGPExpansionLength (mpgp.c:226-287). Called after the
        half feasible step with the re-split gradients."""
        d = pick(explv_key, g, gf, gr)
        lt = opts.explength_type
        if lt == "fixed":
            return alpha, nmv
        if lt == "opt":
            ad = A.mv(d)
            dots0, dots1 = vdots([(d, g), (d, ad)])
            return length_from(dots0, dots1, alpha), nmv + 1
        if lt == "optapprox":
            if explv_key == "g":
                return scalar(alpha_user / maxeig_val), nmv
            dots0, dots1 = vdots([(d, g), (d, d)])
            return (alpha_user * dots0 / dots1 / maxeig_val).to(alpha.dtype), nmv
        # bb: differences across the half-step within this expansion
        v0 = d - dold
        v1 = x - xold
        dots0, dots1 = vdots([(v0, v0), (v0, v1)])
        return length_from(dots0, dots1, alpha), nmv

    def expansion_std(st, Ap, afeas, project_after):
        """Half feasible step + re-split + length + expansion-direction step
        (MPGPExpansion_Std, mpgp.c:296-326)."""
        xold, gold = st.x, st.g
        dold = pick(explv_key, st.g, st.gf, st.gr)
        x1 = st.x - afeas * st.p
        g1 = st.g - afeas * Ap
        gf1, gc1, gr1 = _grads_all(box, x1, g1, st.alpha)
        alpha_new, nmv = explength(st.alpha, x1, g1, gf1, gr1, dold, xold, st.nmv)
        d = pick(expdir_key, g1, gf1, gr1)
        x2 = x1 - alpha_new * d
        if project_after:
            x2 = box.project(x2)
        return st.replace(x=x2, alpha=alpha_new, nmv=nmv), xold, gold

    def expansion_projcg(st, acg):
        """Unconstrained CG step projected back (MPGPExpansion_ProjCG,
        mpgp.c:334-356); projection happens via expproject=True."""
        x2 = box.project(st.x - acg.to(dtype) * st.p)
        return st.replace(x=x2), st.x, st.g

    # ------------------------------------------------------------------ body

    def monitor(st, it, rnorm):
        if opts.monitor:
            gfn, gcn, a = torch.stack([vnorm(st.gf).to(torch.float64),
                                       vnorm(st.gc).to(torch.float64),
                                       st.alpha.to(torch.float64)]).tolist()
            print(f"{it:>3} MPGP [{st.step}] ||gp||={rnorm:.10e},\t||gf||={gfn:.10e},"
                  f"\t||gc||={gcn:.10e},\talpha={a:.10e}", flush=True)
        if opts.monitor_cost:
            # f(x) = 1/2 x'Ax - b'x = 1/2 x'(g - b) with g = Ax - b
            # (QPSMonitorCostFunction, qps.c cost-function monitor)
            print(f"{it:>3} MPGP f(x)={float(0.5 * vdot(st.x, st.g - b)):.10e}", flush=True)

    def take_cg(st, Ap, pAp, acg):
        acg = acg.to(dtype)
        x = st.x - acg * st.p
        g = st.g - acg * Ap
        gf, gc, gr = _grads_all(box, x, g, st.alpha)
        bcg = (vdot(Ap, gf) / pAp).to(dtype)
        p = gf - bcg * st.p
        return st.replace(x=x, g=g, p=p, gf=gf, gc=gc, gr=gr, ncg=st.ncg + 1, step=_STEP_CG)

    def take_expansion(st, Ap, acg, afeas):
        if et == "projcg":
            st2, xold, gold = expansion_projcg(st, acg)
        else:
            st2, xold, gold = expansion_std(st, Ap, afeas, expproject)
        g2 = A.mv(st2.x) - b
        st2 = st2.replace(g=g2, nmv=st2.nmv + 1, step=_STEP_EXP)

        if opts.fallback or opts.fallback2:
            fold = 0.5 * vdot(xold, gold - b)
            f = 0.5 * vdot(st2.x, st2.g - b)
            if bool(f > fold):  # the objective increased
                st2 = st2.replace(nfinc=st2.nfinc + 1)
                do_fall = True
                if opts.fallback2:
                    gf2, gc2 = box.grads(st2.x, st2.g)
                    do_fall = not bool(vdot(gc2, gc2) <= gamma2 * vdot(gf2, gf2))
                if do_fall:
                    # roll back and redo a std-style expansion from the saved
                    # point, then always project (mpgp.c:598-609)
                    gfo, gco, gro = _grads_all(box, xold, gold, st2.alpha)
                    s3 = st2.replace(x=xold, g=gold, gf=gfo, gc=gco, gr=gro)
                    s3, _, _ = expansion_std(s3, Ap, afeas, project_after=False)
                    x3 = box.project(s3.x)
                    g3 = A.mv(x3) - b
                    st2 = s3.replace(x=x3, g=g3, nmv=s3.nmv + 1, nfall=s3.nfall + 1,
                                     step=_STEP_FALL)

        gf, gc, gr = _grads_all(box, st2.x, st2.g, st2.alpha)
        return st2.replace(gf=gf, gc=gc, gr=gr, p=gf, nexp=st2.nexp + 1)

    def proportional_branch(st):
        Ap = A.mv(st.p)
        pAp, gTp = vdots([(st.p, Ap), (st.g, st.p)])
        acg = gTp / pAp
        afeas = box.feas(st.x, st.p)
        st = st.replace(nmv=st.nmv + 1)
        # the second host read of the iteration
        if bool(acg <= afeas):
            return take_cg(st, Ap, pAp, acg)
        return take_expansion(st, Ap, acg, afeas)

    def proportioning_branch(st):
        p = st.gc
        Ap = A.mv(p)
        pAp, gTp = vdots([(p, Ap), (st.g, p)])
        acg = (gTp / pAp).to(dtype)
        x = st.x - acg * p
        g = st.g - acg * Ap
        gf, gc, gr = _grads_all(box, x, g, st.alpha)
        return st.replace(x=x, g=g, p=gf, gf=gf, gc=gc, gr=gr,
                          nmv=st.nmv + 1, nprop=st.nprop + 1, step=_STEP_PROP)

    # --------------------------------------------------------------- drive

    nh = int(history)
    rdtype = getattr(torch, qp.dots_dtype) if qp.dots_dtype else dtype
    hist = torch.full((max(nh, 1),), float("nan"), dtype=rdtype, device=dev)
    x0 = box.project(qp.initial_vector())
    g0 = A.mv(x0) - b
    gf0, gc0, gr0 = _grads_all(box, x0, g0, alpha_init)
    st = _State(x=x0, g=g0, p=gf0, gf=gf0, gc=gc0, gr=gr0, alpha=alpha_init)
    it, aux = 0, conv_aux
    test_scalars = getattr(conv_test, "device_scalars", None)
    if test_scalars is None:
        # a test that needs no device value beyond ||gP|| is wrapped once, so
        # the loop knows one protocol
        plain_test = conv_test

        def test_scalars(aux, rnorm_t, x, g):
            return aux, ()

        def conv_test(aux, it, rnorm, x, g, extra):
            return plain_test(aux, it, rnorm, x, g)

    while True:
        gP = st.gf + st.gc
        if fuse_body:
            # one batched tree for the three same-point reductions (||gP||^2,
            # gc'gc, gf'gf) — each row's summation order identical to the
            # separate calls, so counts/oracles cannot shift
            gPgP, gcTgc, gfTgf = vdots([(gP, gP), (st.gc, st.gc), (st.gf, st.gf)])
            rnorm_t = torch.sqrt(gPgP.real)
        else:
            rnorm_t = vnorm(gP)
            gcTgc = vdot(st.gc, st.gc)
            gfTgf = vdot(st.gf, st.gf)
        proportional_t = gcTgc <= gamma2 * gfTgf
        # the first host read of the iteration: ||gP|| and the
        # proportionality decision together
        aux, extra = test_scalars(aux, rnorm_t, st.x, st.g)
        rnorm, proportional, *extra = torch.stack(
            [v.to(torch.float64) for v in (rnorm_t, proportional_t, *extra)]).tolist()
        if nh:
            hist[min(it, nh - 1)] = rnorm_t
        monitor(st, it, rnorm)
        reason, aux = conv_test(aux, it, rnorm, st.x, st.g, extra)
        if reason != 0:
            break
        st = proportional_branch(st) if proportional else proportioning_branch(st)
        it += 1
    return MPRGPResult(
        # every MPGP step lands in the box in exact arithmetic; the
        # CG/proportioning axpys can leak ~1e-20 past an active bound in fp,
        # so project at return — a <=1-ulp change that restores
        # ||min(x-lb,0)|| = 0 exactly
        x=qp.box.project(st.x) if qp.box is not None else st.x,
        reason=int(reason), iterations=it, rnorm=rnorm,
        nmv=st.nmv, ncg=st.ncg, nexp=st.nexp, nprop=st.nprop,
        nfinc=st.nfinc, nfall=st.nfall, g=st.g, alpha=st.alpha,
        rnorm_history=hist if nh else None, aux=aux,
    )
