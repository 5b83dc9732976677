"""FETI tutorial ex71 — 3-D Poisson on a DMDA-style structured grid
(reference: src/tutorials/feti/ex71.c, adapted from PETSc KSP ex71), the
port of ``examples/feti_ex71.py``.

Q1 hexahedral elements with the reference's hardcoded element stiffness,
uniform grid of cells[0] x cells[1] x cells[2] cells, b = 1 everywhere,
Dirichlet on the x=0 face enforced by symmetric zeroing with unit diagonal
(MatZeroRowsColumnsIS on the MATIS operator, ex71.c:283-327).  1-D and 2-D
grids (cells of one or two entries) and 1-3 D elasticity (``pde``) as in
the reference's -dim / -pde_type options.

Subdomains = a DMDA (m, n, p) process grid; per-axis node counts are M//m
with the remainder going to the first ranks, and element c is owned by the
rank owning its UPPER corner node c+1 (the DMDAGetElements convention).
B and B' run on the gather kernel (csrc/gather_apply.cu) on the card.

Reference parity targets (feti/output/ex71_1_feti_gluing_type-*.out,
nsize 6, -cells 7,8,9, DMDA grid (1,2,3)): CONVERGED_RTOL in 16 (nonred),
9 (full), 9 (orth) iterations.

    python -m permon_tpu_torch.examples.feti_ex71 [full|nonred|orth] [--device cpu]
    python -m permon_tpu_torch.examples.feti_ex71 elasticity [none|lumped] [--device cpu]
"""

from __future__ import annotations

from ..problems import build_ex71, q1_elasticity_emat, q1_poisson_emat  # noqa: F401


def build(cells=(7, 8, 9), grid=(1, 2, 3), dirichlet_diag="assembled", pde="poisson"):
    """The decomposed problem (a FetiProblem with node coordinates).

    dirichlet_diag: how the zeroed x=0 face sets local diagonals on shared
    fixed dofs — 'assembled': each copy gets diag/multiplicity so the
    assembled diagonal is 1.0; 'copy': each copy gets 1.0; 'owner': the
    lowest-rank copy gets 1.0 and other copies get a zero row/column (pair
    with FetiOptions(nullspace='numeric'))."""
    return build_ex71(cells, grid, dirichlet_diag=dirichlet_diag, pde=pde)


def main(cells=(7, 8, 9), grid=(1, 2, 3), gluing="full", view=True, pde="poisson",
         rtol=None, device=None, **kw):
    from ..core.convergence import Tolerances
    from ..feti.solve import FetiOptions, feti_solve
    from ..viewers import view_convergence

    prob = build(cells, grid, pde=pde)
    tol = Tolerances(rtol=rtol) if rtol else Tolerances()
    res = feti_solve(prob, opts=FetiOptions(gluing=gluing, **kw), tol=tol, device=device)
    if view:
        print(view_convergence(res.result))
    return prob, res


def main_elasticity(pc_dual="none", view=True, device=None):
    """The nsize-7 elasticity test (ex71.c test 2): -pde_type Elasticity
    -dim 3 -qps_rtol 1e-6 -dual_pc_dual_type {none,lumped}; reference
    oracles 66 (none) / 26 (lumped) iterations."""
    return main(
        cells=(8, 6, 4), grid=(7, 1, 1), pde="elasticity", gluing="nonred",
        pc_dual=pc_dual, nullspace="numeric", rtol=1e-6, view=view, device=device,
    )


if __name__ == "__main__":
    from . import split_device

    device, args = split_device()
    if args and args[0] == "elasticity":
        main_elasticity(args[1] if len(args) > 1 else "none", device=device)
    else:
        main(gluing=args[0] if args else "full", device=device)
