"""Tutorial ex2 — obstacle on a sub-index-set (reference: src/tutorials/ex2.c),
the port of ``examples/ex2.py``.

Solves the FD discretization of -u'' = -15 on [0,1], u(0)=u(1)=0, with the
obstacle u(x) >= sin(4 pi x - pi/6)/2 - 2 imposed only on x in [0, 1/2],
expressed with -inf bounds outside the subset (the reference's
``-infinite`` variant; both variants share one oracle).

Reference parity target (src/tutorials/output/ex2_1_infinite-{false,true}.out):
CONVERGED_RTOL, 197 iterations, 209 Hessian mults, 179 CG / 11 expansion /
7 proportioning steps.

    python -m permon_tpu_torch.examples.ex2 [n] [--device cpu]
"""

from __future__ import annotations

from ..problems import build_ex2, fobst  # noqa: F401  (fobst: the JAX example's helper)


def build(n: int = 10):
    """(A, b, lb) as ex2.c assembles them: the obstacle on i < n/2 only,
    lb[0] = 0, -inf elsewhere."""
    return build_ex2(n)


def main(n: int = 100, view: bool = True, device=None, **solver_kwargs):
    import scipy.sparse as sp

    from .. import QP, solve
    from ..viewers import view_convergence, view_kkt

    A, b, lb = build(n)
    qp = QP.create(sp.csr_matrix(A), b, lb=lb, device=device)
    res = solve(qp, **solver_kwargs)
    if view:
        print(view_convergence(res))
        print(view_kkt(qp, res.x, g=res.g))
    return qp, res


if __name__ == "__main__":
    from . import split_device

    device, args = split_device()
    main(int(args[0]) if args else 100, device=device)
