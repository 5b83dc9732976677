"""Tutorial ex3 — obstacle problem with the bound as a linear inequality,
solved via dualization (reference: src/tutorials/ex3.c), the port of
``examples/ex3.py``.

Primal: min 1/2 x'Ax - b'x  s.t.  BI x <= cI  with BI = -I, cI = -obstacle
(i.e. x >= obstacle).  ``dualize`` turns this into a box-constrained dual QP
on lambda >= 0 with F = B K^{-1} B' (K^{-1} a dense Cholesky on the
device), solved by MPRGP.

Reference parity target (src/tutorials/output/ex3_1.out): CONVERGED_RTOL,
44 iterations, 71 Hessian multiplications, 17 CG / 26 expansion /
1 proportioning steps.

    python -m permon_tpu_torch.examples.ex3 [n] [--device cpu]
"""

from __future__ import annotations

from .ex1 import build  # same A, b, obstacle as ex1


def main(n: int = 100, view: bool = True, empty_nullsp: bool = False, device=None,
         **solver_kwargs):
    """``empty_nullsp`` mirrors the reference's -empty_nullsp variant: an
    explicit 0-column nullspace makes dualize keep a 0-row equality block, so
    the default-solver rule routes through SMALXE (outer converges in 1
    iteration, HAPPY_BREAKDOWN inner) with maxeig = max(rho, lambda_max)
    injected into the inner MPRGP — oracle ex3_nullspace.out: 1 outer /
    46 inner its, 74 mults, 18/27/1 steps."""
    import numpy as np
    import torch

    import permon_tpu_torch as pt
    from ..qp.transforms import Solution, dualize
    from ..viewers import view_convergence, view_kkt

    A, b, obst = build(n)
    BI = -np.eye(n)
    cI = -obst
    qp = pt.QP.create(A, b, BI=BI, cI=cI, device=device)

    dual, post = dualize(qp)
    if empty_nullsp:
        from ..core.linop import Dense
        from ..solvers.smalxe import SMALXEOptions, smalxe

        z = dict(dtype=dual.b.dtype, device=dual.b.device)
        dual0 = dual.replace(BE=Dense.create(torch.zeros((0, dual.b.shape[0]), **z)),
                             cE=torch.zeros(0, **z), pf=None)
        res = smalxe(dual0, opts=SMALXEOptions(inject_maxeig=True))
        sol = post(Solution(x=res.x))
        if view:
            print(view_convergence(res))
        return qp, dual, res, sol
    res = pt.solve(dual, **solver_kwargs)
    sol = post(Solution(x=res.x, g=res.g))

    if view:
        print(view_convergence(res))
        # chain KKT: dual (child) first, then the primal (parent), mirroring
        # -qp_chain_view_kkt output order
        print(view_kkt(dual, res.x, g=res.g))
        # merged_label: the dualize postSolve populates the MERGED lambda in
        # the reference, so its KKT header reads "+ B'*lambda" (qp.c:723-727)
        print(view_kkt(qp, sol.x, lambda_I=sol.lambda_I, merged_label=True))
    return qp, dual, res, sol


if __name__ == "__main__":
    from . import split_device

    device, args = split_device()
    main(int(args[0]) if args else 100, device=device)
