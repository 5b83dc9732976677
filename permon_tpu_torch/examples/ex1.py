"""Tutorial ex1 — 1-D obstacle problem (reference: src/tutorials/ex1.c), the
port of ``examples/ex1.py``.

Solves the FD discretization of -u'' = -15 on [0,1], u(0)=u(1)=0,
s.t. u(x) >= sin(4 pi x - pi/6)/2 - 2, as the box-constrained QP
min 1/2 x'Ax - b'x s.t. x >= lb.

Reference parity target (src/tutorials/output/ex1_1.out): CONVERGED_RTOL,
181 iterations, 200 Hessian mults, 156 CG / 18 expansion / 7 proportioning.

    python -m permon_tpu_torch.examples.ex1 [n] [--device cpu]
"""

from __future__ import annotations

from ..problems import build_ex1


def build(n: int = 10):
    """(A, b, lb) as the reference example assembles them: Dirichlet rows kept
    as identity rows with zero rhs, the obstacle on interior nodes only."""
    return build_ex1(n)


def main(n: int = 100, use_sparse: bool = True, view: bool = True, device=None,
         **solver_kwargs):
    import scipy.sparse as sp

    from .. import QP, solve
    from ..viewers import view_convergence, view_kkt

    A, b, lb = build(n)
    op = sp.csr_matrix(A) if use_sparse else A
    qp = QP.create(op, b, lb=lb, device=device)
    res = solve(qp, **solver_kwargs)
    if view:
        print(view_convergence(res))
        print(view_kkt(qp, res.x, g=res.g))
    return qp, res


if __name__ == "__main__":
    from . import split_device

    device, args = split_device()
    main(int(args[0]) if args else 100, device=device)
