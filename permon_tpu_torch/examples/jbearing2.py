"""Journal bearing problem (MINPACK-2 DPJB) — bound-constrained QP
(reference: src/tutorials/jbearing2.c), the port of ``examples/jbearing2.py``.

Pressure of a journal bearing over [0, 2pi] x [0, 2b]: minimize the quadratic
f(x) = 1/2 x'Ax + B'x  s.t.  0 <= x <= 1000, with the 5-point stencil Hessian
using trapezoidal-rule coefficients of p(xi) = (1 + ecc cos xi)^3.

Reference parity target (output/jbearing2_4.out, mx=8 my=12 gttol=1e-6):
CONVERGED_RTOL in 23 iterations, 24 Hessian mults, 21 CG / 0 expansion /
2 proportioning steps; alpha = 2.0061100039e-01.

    python -m permon_tpu_torch.examples.jbearing2 [--device cpu]
"""

from __future__ import annotations

from ..problems import build_jbearing


def build(nx=8, ny=12, ecc=0.1, b=10.0):
    """(A, rhs, lb, ub) as FormHessian / ComputeB assemble them."""
    return build_jbearing(nx, ny, ecc, b)


def main(nx=8, ny=12, view=True, monitor=False, device=None, **kw):
    import permon_tpu_torch as pt
    from ..core.convergence import Tolerances
    from ..viewers import view_convergence, view_kkt

    A, rhs, lb, ub = build(nx, ny)
    qp = pt.QP.create(A, rhs, lb=lb, ub=ub, device=device)
    # the reference maps TAO tolerances: rtol = gttol(1e-6), atol = gatol(1e-8)
    res = pt.solve(qp, tol=Tolerances(rtol=1e-6, atol=1e-8), monitor=monitor, **kw)
    if view:
        print(view_convergence(res))
        print(view_kkt(qp, res.x, g=res.g))
    return qp, res


if __name__ == "__main__":
    from . import split_device

    device, _ = split_device()
    main(monitor=True, device=device)
