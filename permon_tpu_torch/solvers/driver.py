"""Default solver selection and the public ``solve`` entry (the port of
the JAX package's module of the same name).

Mirrors QPSSetDefaultType (reference: src/qps/interface/qps.c:422-455):

- inequality constraints present  -> unsupported here directly (dualize first,
  exactly like the reference which errors with "use QPDualize"),
- equality constraints present    -> SMALXE,
- box constraints only            -> MPRGP,
- unconstrained                   -> CG (the KSP analog).
"""

from __future__ import annotations

from typing import Optional

from .. import not_ported
from ..core.convergence import Tolerances
from ..core.detred import deterministic_mode
from ..qp.qp import QP
from .cg import cg
from .mprgp import MPRGPOptions, mprgp


def default_solver_type(qp: QP) -> str:
    if qp.BI is not None:
        raise ValueError(
            "QP with linear inequality constraints cannot be solved directly; "
            "apply dualize() first (reference: QPSSetDefaultType, qps.c:436-438)"
        )
    if qp.BE is not None:
        return "smalxe"
    if qp.box is not None:
        return "mprgp"
    return "cg"


def make_solver(qps_type: Optional[str] = None, tol: Tolerances = Tolerances(),
                deterministic: Optional[bool] = None, **kwargs):
    """A solver callable ``f(qp) -> result`` with the solver type and
    options closed over.  ``deterministic`` (True/False) scopes the
    fixed-binary-tree reduction mode (core/detred.py) to each call of THIS
    solver; None inherits the mode in force when it is called."""

    def run(qp):
        with deterministic_mode(deterministic):
            return solve(qp, qps_type=qps_type, tol=tol, **kwargs)

    return run


def solve(qp: QP, qps_type: Optional[str] = None, tol: Tolerances = Tolerances(), **kwargs):
    """Solve the QP with the selected (or default) solver; returns the solver result."""
    qps_type = qps_type or default_solver_type(qp)
    if qps_type in ("mprgp", "mpgp"):
        opts = kwargs.pop("opts", None) or MPRGPOptions(**kwargs)
        return mprgp(qp, opts=opts, tol=tol)
    if qps_type in ("cg", "ksp"):
        return cg(qp, tol=tol, **kwargs)
    if qps_type == "smalxe":
        from ..qp.transforms import Solution, homogenize_eq
        from .smalxe import SMALXEOptions, smalxe

        opts = kwargs.pop("opts", None) or SMALXEOptions(**kwargs)
        # nonzero cE is homogenized away automatically, as in QPSSetUp_SMALXE
        # (smalxe.c:771-779); the shift is applied back to the returned x
        if qp.cE is not None:
            child, post = homogenize_eq(qp)
            res = smalxe(child, opts=opts, tol=tol)
            sol = post(Solution(x=res.x, Bt_lambda=res.Bt_lambda))
            return res.replace(x=sol.x)
        return smalxe(qp, opts=opts, tol=tol)
    if qps_type in ("tao", "pcpg"):
        raise not_ported(f"solver type {qps_type!r}")
    raise ValueError(f"unknown solver type {qps_type!r}")
