"""TFETI: the dense path (feti_solve, FetiSolver on a FetiProblem), the
MATIS entry and the large-path solve."""
from .assembly import (
    FetiProblem,
    build_dirichlet_rows,
    build_gluing,
    constant_nullspace_columns,
    rigid_body_modes,
)
from .large import FetiSolverSparse, SparseFetiProblem, feti_solve_sparse
from .solve import FetiOptions, FetiResult, FetiSolver, assemble_qp, feti_solve
