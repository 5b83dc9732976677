"""permon_tpu_torch large-path TFETI solve against the JAX package
(feti/large.py) on the same problem:

- f64 factors, deterministic reductions, rtol 1e-9: the same dual CG
  iteration count and x_global within 1e-10 of the JAX solve;
- the f32 + 2-step refinement + primal_refine=1 recipe reaches an
  assembled residual < 1e-8;
- FetiSolverSparse(coarse='sparse') runs the on-device fast path; a
  re-solve with 1.5 b agrees with a fresh solve to 1e-7;
- the lumped dual preconditioner: the count equal to the JAX package's
  and unlike the unpreconditioned one, x_global to 1e-6 of the JAX
  package's at rtol 1e-5; the eager and the fast path give equal counts;
- the 64-subdomain twin of the north star converges in 23 iterations
  (as tests/test_large.py::TestNorthStarShape pins for the JAX package);
- the feti_large example's main against the JAX package's, with f64
  factors and with its f32 recipe (tests/torch_example_parity.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

import examples.feti_large as jfl
from permon_tpu.core.convergence import Tolerances as JaxTolerances
from permon_tpu.feti.large import SparseFetiProblem as JaxSparseFetiProblem
from permon_tpu.feti.large import feti_solve_sparse as jax_feti_solve_sparse
from permon_tpu.feti.solve import FetiOptions as JaxFetiOptions

from permon_tpu_torch.core.convergence import Tolerances
from permon_tpu_torch.core.sell import gather_apply
from permon_tpu_torch.feti.large import FetiSolverSparse, feti_solve_sparse
from permon_tpu_torch.feti.solve import FetiOptions
from permon_tpu_torch.problems import assembled_system, build_sparse

from torch_example_parity import check_example

torch.set_num_threads(2)

CELLS, GRID = (12, 12, 12), (2, 2, 2)
F32 = dict(kplus_dtype=torch.float32, kplus_refine=2, primal_refine=1)


@pytest.fixture(scope="module")
def prob():
    return build_sparse(CELLS, GRID)


def _resid(cells, x):
    A, b = assembled_system(cells)
    return np.linalg.norm(A @ x - b) / np.linalg.norm(b)


def test_f64_deterministic_solve_matches_jax(prob):
    # converged well past 1e-10: at rtol 1e-6 the two CG runs stop at the
    # same count but their last iterates still differ by roundoff amplified
    # along the trajectory (~5e-7 at this size), not by the operators
    tol = 1e-9
    res = feti_solve_sparse(prob, FetiOptions(gluing="nonred", deterministic=True),
                            tol=Tolerances(rtol=tol), device="cpu")
    ref = jax_feti_solve_sparse(jfl.build_sparse(CELLS, GRID),
                                JaxFetiOptions(gluing="nonred", deterministic=True),
                                tol=JaxTolerances(rtol=tol))
    assert res.result.reason == 2
    assert res.result.iterations == int(ref.result.iterations)
    np.testing.assert_allclose(res.x_global, ref.x_global, rtol=0, atol=1e-10)


def test_f32_refined_recipe_residual(prob):
    gather_apply.launches = 0
    res = feti_solve_sparse(prob, FetiOptions(gluing="nonred"), tol=Tolerances(rtol=1e-5),
                            device="cpu", **F32)
    assert res.result.reason == 2
    assert len(res.results) == 2  # main solve + one defect-correction pass
    assert _resid(CELLS, res.x_global) < 1e-8
    assert gather_apply.launches == 0


def test_solver_fast_path_reuse(prob):
    solver = FetiSolverSparse(prob, FetiOptions(gluing="nonred", coarse="sparse"),
                              device="cpu", **F32)
    r1 = solver.solve(tol=Tolerances(rtol=1e-6))
    assert solver._pf is not None and r1.dual_qp is None  # fast path ran
    b2 = prob.b_loc * 1.5
    r2 = solver.solve(b_loc=b2, tol=Tolerances(rtol=1e-6))
    ref = feti_solve_sparse(dataclasses.replace(prob, b_loc=b2),
                            FetiOptions(gluing="nonred", coarse="sparse"),
                            tol=Tolerances(rtol=1e-6), device="cpu", **F32)
    assert r2.result.reason == 2
    np.testing.assert_allclose(r2.x_global, ref.x_global, atol=1e-7)
    np.testing.assert_allclose(r2.x_global, 1.5 * r1.x_global, atol=1e-6)


def test_solver_dense_coarse_reuse(prob):
    """Small problems keep the dense coarse chain: the first solve builds
    the projector, the second reuses it."""
    solver = FetiSolverSparse(prob, FetiOptions(gluing="nonred", deterministic=True),
                              device="cpu")
    r1 = solver.solve(tol=Tolerances(rtol=1e-6))
    assert solver._pf is not None and r1.dual_qp is not None
    r2 = solver.solve(b_loc=prob.b_loc * 2.0, tol=Tolerances(rtol=1e-6))
    np.testing.assert_allclose(r2.x_global, 2.0 * r1.x_global, atol=1e-8)


def test_north_star_twin_pinned():
    prob = build_sparse((20,) * 3, (4,) * 3)
    assert prob.ns == 64 and prob.n_global == 9261
    res = feti_solve_sparse(prob, FetiOptions(gluing="nonred"), tol=Tolerances(rtol=1e-5),
                            device="cpu", **F32)
    assert res.result.reason == 2
    assert res.result.iterations == 23
    assert _resid((20,) * 3, res.x_global) < 1e-8


def test_full_gluing_solves(prob):
    res = feti_solve_sparse(prob, FetiOptions(gluing="full"), tol=Tolerances(rtol=1e-7),
                            device="cpu")
    assert res.result.reason == 2
    assert _resid(CELLS, res.x_global) < 1e-6


@pytest.mark.parametrize("opts,match", [
    # without a mesh there are no redundancy groups: the solve is the plain one
    # (large.py:655-657); a mesh is a permon_tpu_torch.parallel Mesh (the runs
    # over ranks: tests/test_torch_parallel.py)
    (dict(qppf_redundancy=True), None),
    (dict(mesh=object()), "Mesh"), (dict(coarse="redundant"), "ROADMAP"),
    # rejected by the JAX package itself on the large path, in its words
    (dict(project=False), "project=False"), (dict(throughput=True), "throughput=True"),
    (dict(orth_G="gs"), "orth_G on the large path"),
])
def test_options_outside_the_slice_raise(prob, opts, match):
    run = lambda **o: feti_solve_sparse(prob, FetiOptions(**{"gluing": "nonred", **o}),
                                        device="cpu")
    if match is None:
        res, plain = run(**opts), run()
        assert res.result.iterations == plain.result.iterations
        np.testing.assert_array_equal(res.x_global, plain.x_global)
        return
    with pytest.raises(TypeError if "mesh" in opts else NotImplementedError, match=match):
        run(**opts)


def test_orth_gluing_on_the_large_path(prob):
    """gluing='orth' (ported with the dense path) solves on the large path
    too, to the solution of the nonredundant gluing."""
    res = feti_solve_sparse(prob, FetiOptions(gluing="orth"), tol=Tolerances(rtol=1e-7),
                            device="cpu")
    assert res.result.reason == 2
    assert _resid(CELLS, res.x_global) < 1e-6


@pytest.fixture(scope="module")
def twin_default():
    prob = build_sparse((20,) * 3, (4,) * 3)
    res = feti_solve_sparse(prob, FetiOptions(gluing="nonred"), tol=Tolerances(rtol=1e-5),
                            device="cpu", **F32)
    return prob, res


@pytest.mark.parametrize("opts", [dict(nullspace="numeric"), dict(precision="mixed")])
def test_options_the_large_path_does_not_read(twin_default, opts):
    """As in the JAX package (permon_tpu/feti/large.py:329-356), the large
    path takes every nullspace but 'rbm' as the constant one and never
    reads ``precision``: the twin solves exactly as by default."""
    prob, ref = twin_default
    res = feti_solve_sparse(prob, FetiOptions(gluing="nonred", **opts),
                            tol=Tolerances(rtol=1e-5), device="cpu", **F32)
    assert res.result.iterations == ref.result.iterations == 23
    assert res.result.reason == ref.result.reason == 2
    np.testing.assert_array_equal(res.x_global, ref.x_global)


def test_explicit_cuda_device_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="CUDA"):
        FetiSolverSparse(build_sparse((4,) * 3, (2,) * 3), FetiOptions(gluing="nonred"),
                         device="cuda")


# -- the lumped dual preconditioner ------------------------------------------------


def _jax_sparse(prob):
    """The JAX package's container over the same host arrays."""
    return JaxSparseFetiProblem(
        K_blocks=prob.K_blocks, b_loc=prob.b_loc, l2g=prob.l2g, floating=prob.floating,
        dirichlet=prob.dirichlet, dirichlet_values=prob.dirichlet_values)


def test_lumped_counts_equal_jax(prob):
    jopts = JaxFetiOptions(gluing="nonred", pc_dual="lumped", deterministic=True)
    ref = jax_feti_solve_sparse(_jax_sparse(prob), jopts, tol=JaxTolerances(rtol=1e-5))
    res_n = feti_solve_sparse(prob, FetiOptions(gluing="nonred", deterministic=True),
                              tol=Tolerances(rtol=1e-5), device="cpu")
    res_l = feti_solve_sparse(prob, FetiOptions(gluing="nonred", pc_dual="lumped",
                                                deterministic=True),
                              tol=Tolerances(rtol=1e-5), device="cpu")
    assert res_l.result.reason == 2
    assert res_l.result.iterations == int(ref.result.iterations)
    assert res_l.result.iterations != res_n.result.iterations
    np.testing.assert_allclose(res_l.x_global, ref.x_global, rtol=0, atol=1e-6)
    np.testing.assert_allclose(res_l.x_global, res_n.x_global, rtol=0, atol=1e-3)


@pytest.mark.parametrize("coarse", ["auto", "sparse"])
def test_lumped_eager_and_fast_counts_equal(prob, coarse):
    solver = FetiSolverSparse(prob, FetiOptions(gluing="nonred", pc_dual="lumped",
                                                coarse=coarse), device="cpu")
    r1 = solver.solve(tol=Tolerances(rtol=1e-6))
    assert (r1.dual_qp is None) == (coarse == "sparse")  # eager first solve on 'auto'
    r2 = solver.solve(b_loc=prob.b_loc * 2.0, tol=Tolerances(rtol=1e-6))
    assert r2.dual_qp is None and r2.result.reason == 2  # the fast path
    assert r1.result.iterations == r2.result.iterations
    np.testing.assert_allclose(r2.x_global, 2.0 * r1.x_global, rtol=0, atol=1e-6)


# -- the command-line example of this path --------------------------------------


@pytest.mark.parametrize("name", ["feti_large", "feti_large-f32"])
def test_example_matches_jax_example(name):
    """The example's main against the JAX package's, in-process: every
    printed line with the numbers masked, and the solution
    (tests/torch_example_parity.py)."""
    check_example(name)
