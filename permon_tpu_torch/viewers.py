"""Text viewers reproducing the reference's diagnostic output formats — the
port of :mod:`permon_tpu.viewers`, whose text it gives character for
character on equal results.

The reference test suite's oracle is filtered stdout: convergence reason,
iteration/step counts, and KKT residual lines (reference: gmakefile.test,
tutorial TEST blocks filter `grep -e CONVERGED -e number -e "r ="`).  These
functions generate the same lines so parity can be diffed directly.

Formats mirrored from QPSViewConvergence (qps.c:987-996),
QPSViewConvergence_MPGP (mpgp.c:750-770), QPViewKKT (qp.c:245-370) and
QPCViewKKT_Box (qpcbox.c:332-427).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from .core.convergence import REASON_NAMES
from .qp.qp import QP

_norm = torch.linalg.vector_norm


def _fmt(x) -> str:
    return f"{float(x):.2e}"


def _dtype_name(dt) -> str:
    """numpy's spelling of a dtype ('float64'), as the JAX viewer prints it."""
    return str(dt).replace("torch.", "")


def view_convergence(result, solver: str = "mpgp", tol=None,
                     indent: int = 1) -> str:
    """'last QPSSolve ...' + per-solver step counters, with the reference's
    ASCII-viewer indentation (two spaces per level) so the output diffs
    LITERALLY against the committed expected-output files
    (src/tutorials/output/*.out)."""
    pad = "  " * indent
    reason = int(result.reason)
    name = REASON_NAMES.get(reason, str(reason))
    status = "CONVERGED" if reason > 0 else "DIVERGED"
    lines = [
        f"{pad}last QPSSolve {status} due to {name}, KSPReason={reason}, "
        f"required {int(result.iterations)} iterations"
    ]
    pad2 = "  " * (indent + 1)
    if hasattr(result, "nmv"):
        lines.append(f"{pad2}number of Hessian multiplications {int(result.nmv)}")
    if hasattr(result, "ncg"):
        lines += [
            f"{pad2}number of CG steps {int(result.ncg)}",
            f"{pad2}number of expansion steps {int(result.nexp)}",
            f"{pad2}number of proportioning steps {int(result.nprop)}",
        ]
    return "\n".join(lines)


def view_convergence_smalxe(result, indent: int = 1) -> str:
    """QPSViewConvergence_SMALXE (smalxe.c:1000-1019): outer line, inner
    iteration total, M1/eta hit + update counters, then the INNER solver's
    convergence view one level deeper — the exact nesting of the reference's
    ASCII viewer (cf. output/ex3_nullspace.out)."""
    pad2 = "  " * (indent + 1)
    lines = [view_convergence(result, indent=indent)]
    lines += [
        f"{pad2}Total number of inner iterations {int(result.inner_iterations)}",
        f"{pad2}#hits    of M1, eta: {int(result.M1_hits):3d}, {int(result.eta_hits):3d}",
        f"{pad2}#updates of M1, rho: {int(result.M1_updates):3d}, {int(result.rho_updates):3d}",
    ]
    # inner solver view (QPSViewConvergence(smalxe->inner)) one level deeper
    inner_reason = int(result.inner_reason)
    name = REASON_NAMES.get(inner_reason, str(inner_reason))
    status = "CONVERGED" if inner_reason > 0 else "DIVERGED"
    pad3 = "  " * (indent + 2)
    pad4 = "  " * (indent + 3)
    lines += [
        f"{pad3}last QPSSolve {status} due to {name}, KSPReason={inner_reason}, "
        f"required {int(result.inner_iterations)} iterations",
        f"{pad4}number of Hessian multiplications {int(result.nmv)}",
        f"{pad4}number of CG steps {int(result.ncg)}",
        f"{pad4}number of expansion steps {int(result.nexp)}",
        f"{pad4}number of proportioning steps {int(result.nprop)}",
    ]
    return "\n".join(lines)


def view_history(result, solver: str = "QPS") -> str:
    """Per-iteration residual-norm lines from a recorded history buffer
    (the default QPS monitor format, qps.c monitors + residual-history
    arrays qpsimpl.h:62-70).  Solvers record the history when called with
    ``history > 0``."""
    hist = getattr(result, "rnorm_history", None)
    if hist is None:
        return f"(no residual history recorded for this {solver} result)"
    h = hist.detach().cpu().numpy() if isinstance(hist, torch.Tensor) else np.asarray(hist)
    n = min(int(result.iterations) + 1, len(h))
    return "\n".join(
        f"{i:3d} {solver} ||r||={h[i]:.12e}" for i in range(n)
        if not np.isnan(h[i])
    )


def view_kkt(qp: QP, x, g=None, lambda_E=None, lambda_I=None,
             merged_label: bool = False) -> str:
    """KKT residual report for a solved QP.

    ``g`` is the final gradient A x - b (+ B'lambda if the solver worked on the
    Lagrangian); box multipliers are recovered from it as in
    QPComputeMissingBoxMultipliers (qp.c:829-889).  ``merged_label`` prints
    the constraint term as `` + B'*lambda`` — the reference's label when the
    MERGED multiplier is valid (a dualize postSolve populated qp->lambda,
    qp.c:723-727), which is how the committed ex3 output reads.
    """
    lines: List[str] = []
    b = qp.b
    normb = _norm(b)
    if g is None:
        g = qp.A.mv(x) - b

    r = g
    kkt_name = "A*x - b"
    llb = lub = None
    if qp.box is not None:
        llb, lub = qp.box.multipliers_from_lagrangian(r)
        if qp.box.has_lb:
            r = r - llb
            kkt_name += " - lambda_lb"
        if qp.box.has_ub:
            r = r + lub
            kkt_name += " + lambda_ub"
    had_constraint = False
    if lambda_E is not None and qp.BE is not None:
        r = r + qp.BE.rmv(lambda_E)
        had_constraint = True
        if not merged_label:
            kkt_name += " + BE'*lambda_E"
    if lambda_I is not None and qp.BI is not None:
        r = r + qp.BI.rmv(lambda_I)
        had_constraint = True
        if not merged_label:
            kkt_name += " + BI'*lambda_I"
    if merged_label and had_constraint:
        kkt_name += " + B'*lambda"

    norm = _norm(r)
    lines.append(f"r = ||{kkt_name}|| = {_fmt(norm)}    rO/||b|| = {_fmt(norm / normb)}")

    if qp.BE is not None:
        rE = qp.BE.mv(x)
        label = "||BE*x||            "
        if qp.cE is not None:
            rE = rE - qp.cE
            label = "||BE*x-cE||         "
        nE = _norm(rE)
        lines.append(f"r = {label} = {_fmt(nE)}    r/||b|| = {_fmt(nE / normb)}")

    if qp.BI is not None:
        rI = qp.BI.mv(x)
        if qp.cI is not None:
            rI = rI - qp.cI
        nI = _norm(torch.clamp(rI, min=0.0))
        lines.append(f"r = ||max(BI*x-cI,0)||   = {_fmt(nI)}    r/||b|| = {_fmt(nI / normb)}")
        if lambda_I is not None:
            nL = _norm(torch.clamp(lambda_I, max=0.0))
            lines.append(f"r = ||min(lambda_I,0)||  = {_fmt(nL)}    r/||b|| = {_fmt(nL / normb)}")
            comp = torch.abs(torch.vdot(lambda_I, rI))
            lines.append(f"r = |lambda_I'*(BI*x-cI)|= {_fmt(comp)}    r/||b|| = {_fmt(comp / normb)}")

    if qp.box is not None:
        for label, val in qp.box.kkt_terms(x, llb, lub):
            lines.append(f"r = {label} = {_fmt(val)}    r/||b|| = {_fmt(val / normb)}")
    return "\n".join(lines)


def view_chain_kkt_feti(res, prob=None, A_asm=None, b_asm=None) -> str:
    """The ``-qp_chain_view_kkt`` r-lines of a dense-facade TFETI solve —
    the exact per-node sequence QPChainPostSolve emits for the KSPFETI
    chain (qpchain.c:200-276 walking last -> root, QPViewKKT per node,
    qp.c:245-370), so the report diffs VERBATIM against the committed
    feti expected outputs (src/tutorials/feti/output/ex71_*.out).

    Chain anatomy reproduced here (reference transform list:
    feti.c:86-91 -> QPTAllInOne, qptransform.c):

    - MATIS root -> blockdiag (QPTMatISToBlockDiag) -> QPTScale no-op node
      (QPTransformBegin runs unconditionally, so a pointer-copy node exists
      even with scale type NONE — hence the DUPLICATED view pairs in the
      .out files) -> dualize -> QPTScale no-op -> [homogenize -> project,
      only when the dual has equality constraints, i.e. floating
      subdomains exist].
    - the projected node's multiplier is "missing", so
      QPComputeMissingEqMultiplier sets Bt_lambda := -(A x - b) of the
      HOMOGENIZED node and its stationarity line prints 0.00e+00 exactly
      (qp.c:696-702); the dual nodes inherit that aliased Bt_lambda
      (QP_DUPLICATE_COPY_POINTERS) and their recomputed residual is the
      floating-point nonlinearity F(lam+xt) - F lam - F xt — machine
      noise, label "(B'*lambda)";
    - the primal decomposed nodes carry the MERGED multiplier set by the
      dualize postSolve (label "+ B'*lambda", no parens);
    - the root view is the ASSEMBLED residual (pass ``A_asm``/``b_asm``),
      after the MatIS postSolve propagated the solution up.
    """
    qp, dual = res.qp, res.dual_qp
    lam_h = res.result.x
    F, d = dual.A, dual.b
    lines: List[str] = []

    def rline(name, r, nb):
        return f"r = ||{name}|| = {_fmt(r)}    rO/||b|| = {_fmt(r / nb)}"

    def beline(x, be, ce, nb):
        rE = be.mv(x)
        label = "||BE*x||            "
        if ce is not None:
            rE = rE - ce
            label = "||BE*x-cE||         "
        nE = _norm(rE)
        return f"r = {label} = {_fmt(nE)}    r/||b|| = {_fmt(nE / nb)}"

    k = 0 if dual.BE is None else int(dual.BE.shape[0])
    if k:
        pf = dual.pf
        if pf is None:
            from .qp.projector import Projector

            pf = Projector.create(dual.BE)
        xt = pf.apply_half_q_t(dual.cE)  # homogenize shift
        b_h = d - F.mv(xt)
        # projected node: A = PFP, b = P b_h (x = lam_h)
        r6 = pf.apply_p(F.mv(pf.apply_p(lam_h))) - pf.apply_p(b_h)
        nb6 = _norm(pf.apply_p(b_h))
        lines.append(rline("A*x - b", _norm(r6), nb6))
        # homogenized node: missing multiplier -> exact zero stationarity
        nb5 = _norm(b_h)
        lines.append(
            f"r = ||A*x - b + (B'*lambda)|| = {_fmt(0.0)}"
            f"    rO/||b|| = {_fmt(0.0)}"
        )
        lines.append(beline(lam_h, dual.BE, None, nb5))
        # dual node (and its QPTScale pointer copy): aliased Bt_lambda
        lam_full = lam_h + xt
        r4 = _norm(F.mv(lam_full) - d - (F.mv(lam_h) - b_h))
        nb4 = _norm(d)
        pair = [rline("A*x - b + (B'*lambda)", r4, nb4),
                beline(lam_full, dual.BE, dual.cE, nb4)]
        lines += pair + pair
    else:
        lam_full = lam_h
        r4 = _norm(F.mv(lam_full) - d)
        nb4 = _norm(d)
        pair = [rline("A*x - b", r4, nb4)]
        lines += pair + pair
    # primal decomposed node (and its QPTScale pointer copy): merged
    # multiplier from the dualize postSolve.  The reference's BE carries NO
    # cE here (homogeneous gluing; Dirichlet lives in the Hessian for the
    # ex71 family) — an all-zero cE on our side means the same NULL
    u = res.u_decomposed
    rp = _norm(qp.A.mv(u) - qp.b + qp.BE.rmv(lam_full))
    nbp = _norm(qp.b)
    cep = qp.cE if (qp.cE is not None and bool(torch.any(qp.cE != 0))) else None
    pair = [rline("A*x - b + B'*lambda", rp, nbp),
            beline(u, qp.BE, cep, nbp)]
    lines += pair + pair
    # assembled root view.  The MatIS postSolve assembles the solution with
    # a reverse VecScatter INSERT (qptransform.c:1949-1952) — for a shared
    # dof ONE copy wins (the highest-rank writer, last in the scatter), not
    # the copy mean the public API returns — so the root residual is
    # computed from that insert-convention assembly
    if A_asm is not None:
        if prob is not None:
            ng = prob.n_global
            x_ins = np.zeros(ng)
            u_np = u.detach().cpu().numpy().reshape(prob.ns, -1)[:, : prob.nl]
            # descending: rank 0's copy wins for shared dofs (matches the
            # committed ex71 root-view digits: ratio 9.31e-06, not the
            # 9.30e-06 the last-writer convention gives)
            for s in range(prob.ns - 1, -1, -1):
                real = prob.l2g[s] >= 0
                x_ins[prob.l2g[s][real]] = u_np[s][real]
        else:
            x_ins = np.asarray(res.x_global)
        r0 = np.linalg.norm(A_asm @ x_ins - b_asm)
        nb0 = np.linalg.norm(b_asm)
        lines.append(rline("A*x - b", r0, nb0))
    return "\n".join(lines)


def _op_info(name: str, op) -> str:
    """One MatPrintInfo-style line: name, type, shape, dtype (of the first
    float tensor found in the operator)."""
    from .core.precision import _storage_dtype

    if op is None:
        return f"{name:<8} = None"
    if isinstance(op, torch.Tensor):  # vector
        return f"{name:<8} Vec  shape={tuple(op.shape)} dtype={_dtype_name(op.dtype)}"
    dt = _storage_dtype(op)
    dt = "?" if dt is None else _dtype_name(dt)
    return f"{name:<8} {type(op).__name__:<22} shape={tuple(op.shape)} dtype={dt}"


def view_qp(qp: QP, title: str = "QP") -> str:
    """Pipeline-stage object info — the -permon_object_info analog
    (MatPrintInfo/VecPrintInfo dump in QPTDualizeView_Private,
    reference: qptransform.c:694-779): one line per operator/vector of the
    QP with type, shape and dtype, so a transform chain can be audited
    stage by stage."""
    lines = [f"*** {title}:"]
    lines.append(_op_info("A", qp.A))
    lines.append(_op_info("b", qp.b))
    for nm in ("BE", "cE", "BI", "cI", "R"):
        v = getattr(qp, nm)
        if v is not None:
            lines.append(_op_info(nm, v))
    if qp.box is not None:
        lines.append(_op_info("lb", qp.box.lb))
        lines.append(_op_info("ub", qp.box.ub))
    if qp.pf is not None:
        lines.append(_op_info("pf.G", qp.pf.G))
    lines.append("***")
    return "\n".join(lines)


def view_chain(steps, title: str = "QP chain") -> str:
    """Object info for a whole transform chain: ``steps`` is the
    [(child_qp, post_solve), ...] list the transforms build (the
    QPChainView analog, qpchain.c)."""
    out = [f"=== {title} ({len(steps)} stages)"]
    for i, (child, _post) in enumerate(steps):
        out.append(view_qp(child, title=f"stage {i}"))
    return "\n".join(out)
