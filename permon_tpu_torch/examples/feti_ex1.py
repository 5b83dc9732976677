"""FETI tutorial ex1 — 1-D Poisson by TFETI (reference: src/tutorials/feti/ex1.c),
the port of ``examples/feti_ex1.py``.

-u'' = sin(pi x) on [0,1], homogeneous Dirichlet, ns subdomains with ne
elements each; element stiffness [[1,-1],[-1,1]], load sin((g+1/2)h pi)h^2/2
per element end.  Dirichlet enforced by constraint rows (TFETI) by default.
B and B' run on the gather kernel (csrc/gather_apply.cu) on the card.

Reference parity target (feti/output/ex1_1.out, nsize 4, -ne 7):
CONVERGED_RTOL in 1 iteration (projected dual CG);
the SMALXE variant (-project 0 -qps_smalxe_rho 1e1 -dual_qp_E_orth_type gs):
16 iterations (ex1_smalxe_orth_dual_qp_E_orth_type-gs.out).

    python -m permon_tpu_torch.examples.feti_ex1 [--device cpu]
"""

from __future__ import annotations

from ..problems import build_feti_ex1


def build(ns: int = 4, ne: int = 7):
    """The decomposed problem (a FetiProblem), the rhs re-split by
    multiplicity as the reference's MATIS decomposition does."""
    return build_feti_ex1(ns, ne)


def main(ns=4, ne=7, project=True, view=True, device=None, **kw):
    from ..core.convergence import REASON_NAMES
    from ..feti.solve import FetiOptions, feti_solve
    from ..viewers import view_convergence, view_kkt

    prob = build(ns, ne)
    opts = FetiOptions(project=project, **kw)
    res = feti_solve(prob, opts=opts, device=device)
    if view:
        print(view_convergence(res.result))
        print(view_kkt(res.qp, res.u_decomposed, lambda_E=res.solution.lambda_E))
        print(
            f"PERMON FETI {REASON_NAMES[int(res.result.reason)]} in "
            f"{int(res.result.iterations)} iteration"
        )  # the reference example's closing line (feti/ex1.c:99)
    return prob, res


if __name__ == "__main__":
    from . import split_device

    device, _ = split_device()
    main(device=device)
