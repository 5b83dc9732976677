"""TFETI contact (semicoercive obstacle) problem, the port of
``examples/feti_contact.py``.

The 1-D obstacle problem of tutorial ex1 (-u'' = -30, u(0)=u(1)=0,
u >= sin(4 pi x - pi/6)/2 - 2), solved by TOTAL-FETI domain decomposition
with the obstacle as linear INEQUALITY constraints (-u <= -lb) (PERMON
README:3-12; the pipeline of QPTAllInOne, qptransform.c:2151-2205):

    decomposed QP (singular K blocks, gluing + Dirichlet equalities,
                   obstacle inequalities)
      -> dualize           (dual box lb=0 on the inequality rows,
                            coarse space G = R'B')
      -> homogenize_eq
      -> enforce_eq_by_projector  (P F P, box kept)
      -> SMALXE outer loop with MPRGP inner (SMALBE — the contact solver)

B, B' and the obstacle rows run on the gather kernel (csrc/gather_apply.cu)
on the card.  Oracle: the decomposed solution re-assembled over dof copies
matches the serial MPRGP solution of tutorial ex1 on the same grid.

    python -m permon_tpu_torch.examples.feti_contact [--device cpu]
"""

from __future__ import annotations

from ..problems import build_feti_contact


def build(ns: int = 4, ne: int = 25):
    """Decomposed obstacle problem: (FetiProblem, BI, cI, lb) with one
    inequality row per interior global node, on its first owning copy."""
    return build_feti_contact(ns, ne)


def main(ns: int = 4, ne: int = 25, view: bool = True, throughput: bool = False, device=None):
    """``throughput=True`` runs the SAME SMALBE pipeline with the dual
    iteration in scaled-leaf space (feti/leafqp.py): the stacked [B_gluing;
    B_obstacle] extension operator, explicit per-block K+ inverses, and box
    projections acting on leaf copies — identical iteration counts."""
    from ..feti.solve import FetiOptions, feti_solve
    from ..viewers import view_convergence_smalxe

    prob, BI, cI, lb = build(ns, ne)
    opts = FetiOptions(gluing="nonred", throughput=throughput)
    r = feti_solve(prob, opts, BI=BI, cI=cI, device=device)
    x_global, res, sol = r.x_global, r.result, r.solution

    if view:
        print(view_convergence_smalxe(res))
        gap = x_global - lb
        print(f"active contact nodes: {(gap < 1e-8).sum()} of {n_nodes(ns, ne)}")
    return x_global, res, sol


def n_nodes(ns: int, ne: int) -> int:
    return ns * ne + 1


if __name__ == "__main__":
    from . import split_device

    device, _ = split_device()
    main(device=device)
