"""The dense TFETI path of permon_tpu_torch (``feti_solve``, ``FetiSolver``,
``all_in_one`` on a decomposed QP) against the JAX package and the
reference tutorials' oracles, on the CPU: Poisson in 1-3 D and contact.

Tolerances, per check:

- counts: the reference oracles exactly (ex1: 1 iteration with Dirichlet
  rows and in the Hessian; ex71: 16 / 9 / 9 for nonred / full / orth) and
  equal to the JAX package's on the same problem;
- ``x_global`` against the JAX package's on the same problem: 1e-9 of
  max |x| at rtol 1e-10 (the two packages' K+ differ in the last bits and
  the dual iterates follow them), 1e-12 absolute where the dual converges
  in one iteration (ex1);
- against direct solves of the assembled system: the JAX package's own
  limits (ex1 1e-10, 2-D 1e-4 at the default rtol, 1-D 1e-10, ragged 1e-8);
- contact against the serial MPRGP obstacle solution: 1e-6, 3-20 active
  nodes, lambda_I >= -1e-10 (tests/test_feti.py::TestContact);
- ex71 through the MATIS entry (feti_problem_from_matis): the problem
  array-equal to the FetiProblem entry's and the JAX package's, the count
  and x_global bitwise those of the FetiProblem entry, x_global to 1e-9 of
  max |x| of the JAX package's at rtol 1e-10 (one JAX solve per gluing,
  shared with the ex71 count test);
- the feti_ex1, feti_contact and feti_ex71 examples' mains against the
  JAX package's (tests/torch_example_parity.py).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import examples.feti_contact as jcontact
import examples.feti_ex1 as jex1
import examples.feti_ex71 as jex71
import permon_tpu.feti.matis as jmatis
import permon_tpu.feti.solve as jsolve
from permon_tpu.core.convergence import Tolerances as JaxTolerances
from permon_tpu.feti.solve import FetiOptions as JaxFetiOptions

import permon_tpu_torch as pt
import permon_tpu_torch.feti.matis as tmatis
import permon_tpu_torch.feti.solve as tsolve
import permon_tpu_torch.problems as tprob
from permon_tpu_torch.core.convergence import Tolerances
from permon_tpu_torch.core.factor import BlockDiagCholInv, RaggedBlockDiagCholInv
from permon_tpu_torch.feti.assembly import FetiProblem, decompose_rhs_by_multiplicity
from permon_tpu_torch.feti.solve import FetiOptions, FetiSolver, feti_solve
from permon_tpu_torch.interop import from_arrays
from permon_tpu_torch.qp.transforms import Solution, all_in_one

from torch_example_parity import check_example

torch.set_num_threads(2)

TIGHT = dict(rtol=1e-10)


def _solve(prob, tol=None, **opts):
    return feti_solve(prob, FetiOptions(**opts), tol=Tolerances(**(tol or {})), device="cpu")


def _jsolve(prob, tol=None, **opts):
    return jsolve.feti_solve(prob, JaxFetiOptions(**opts), tol=JaxTolerances(**(tol or {})))


def _feasibility(res):
    rE = res.qp.BE.mv(res.u_decomposed) - res.qp.cE
    return float(torch.linalg.vector_norm(rE) / torch.linalg.vector_norm(res.qp.b))


def _assembled(prob):
    n = prob.n_global
    A, b = np.zeros((n, n)), np.zeros(n)
    for s in range(prob.ns):
        real = np.flatnonzero(prob.l2g[s] >= 0)
        g = prob.l2g[s][real]
        A[np.ix_(g, g)] += prob.K_blocks[s][np.ix_(real, real)]
        np.add.at(b, g, prob.b_loc[s][real])
    return A, b


# -- ex1: 1-D Poisson, 4 subdomains ----------------------------------------------


@pytest.fixture(scope="module")
def ex1():
    return tprob.build_feti_ex1(4, 7), jex1.build(4, 7)


@pytest.mark.parametrize("by_B", [True, False], ids=["rows", "in_hessian"])
def test_ex1_one_iteration(ex1, by_B):
    """Oracles ex1_1.out / ex1_2.out: one projected CG iteration, gluing
    feasibility at round-off; the solution equals the JAX package's."""
    prob, jprob = ex1
    res = _solve(prob, dirichlet_by_B=by_B)
    assert res.result.reason == 2 and res.result.iterations == 1
    assert _feasibility(res) < 1e-12
    ref = _jsolve(jprob, dirichlet_by_B=by_B)
    assert int(ref.result.iterations) == 1
    np.testing.assert_allclose(res.x_global, ref.x_global, rtol=0, atol=1e-12)


def test_ex1_matches_direct_solve_and_both_dirichlet_spellings(ex1):
    prob, _ = ex1
    A, b = _assembled(prob)
    for i in (0, -1):
        A[i, :] = A[:, i] = 0.0
        A[i, i], b[i] = 1.0, 0.0
    x_ref = np.linalg.solve(A, b)
    r_rows, r_hess = _solve(prob), _solve(prob, dirichlet_by_B=False)
    np.testing.assert_allclose(r_rows.x_global, x_ref, atol=1e-10)
    np.testing.assert_allclose(r_hess.x_global, r_rows.x_global, atol=1e-10)


@pytest.mark.parametrize("gluing", ["nonred", "full", "orth"])
def test_ex1_gluing_types(gluing):
    prob = tprob.build_feti_ex1(3, 5)
    res = _solve(prob, gluing=gluing)
    assert res.result.reason > 0
    np.testing.assert_allclose(res.x_global, _solve(prob, gluing="nonred").x_global, atol=1e-8)
    ref = _jsolve(jex1.build(3, 5), gluing=gluing)
    assert res.result.iterations == int(ref.result.iterations)
    np.testing.assert_allclose(res.x_global, ref.x_global, rtol=0, atol=1e-12)


# -- ex71: 3-D Poisson, 6 subdomains -----------------------------------------------


@pytest.fixture(scope="module")
def ex71():
    return tprob.build_ex71(), jex71.build()


@pytest.fixture(scope="module")
def jax_ex71_tight(ex71):
    """The JAX package's ex71 solve at rtol 1e-10, run once per gluing for
    the count test and the MATIS test."""
    runs = {}

    def run(gluing):
        if gluing not in runs:
            runs[gluing] = _jsolve(ex71[1], TIGHT, gluing=gluing)
        return runs[gluing]

    return run


@pytest.mark.parametrize("gluing,ref_its", [("nonred", 16), ("full", 9), ("orth", 9)])
def test_ex71_poisson_counts(ex71, jax_ex71_tight, gluing, ref_its):
    """Oracles ex71_1_feti_gluing_type-{nonred,full,orth}.out: 16 / 9 / 9;
    at rtol 1e-10 the count and the solution equal the JAX package's."""
    prob, _ = ex71
    res = _solve(prob, gluing=gluing)
    assert res.result.reason == 2 and res.result.iterations == ref_its
    tight, ref = _solve(prob, TIGHT, gluing=gluing), jax_ex71_tight(gluing)
    assert tight.result.iterations == int(ref.result.iterations)
    np.testing.assert_allclose(tight.x_global, ref.x_global, rtol=0,
                               atol=1e-9 * np.abs(ref.x_global).max())


def test_lumped_preconditioner_helps():
    """tests/test_feti.py::test_lumped_preconditioner_helps, with the counts
    equal to the JAX package's."""
    prob, jprob = tprob.build_ex71((5, 5, 5), (1, 2, 3)), jex71.build((5, 5, 5), (1, 2, 3))
    r_none, r_lump = _solve(prob, TIGHT), _solve(prob, TIGHT, pc_dual="lumped")
    assert r_lump.result.reason > 0
    assert r_lump.result.iterations <= r_none.result.iterations
    np.testing.assert_allclose(r_lump.x_global, r_none.x_global, atol=1e-6)
    j_lump = _jsolve(jprob, TIGHT, pc_dual="lumped")
    assert r_lump.result.iterations == int(j_lump.result.iterations)
    np.testing.assert_allclose(r_lump.x_global, j_lump.x_global, rtol=0,
                               atol=1e-9 * np.abs(j_lump.x_global).max())


def _same_problem(prob, jprob):
    for f in dataclasses.fields(jprob):
        a, b = getattr(prob, f.name), getattr(jprob, f.name)
        if a is None or b is None or isinstance(a, str):
            assert a == b
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(a, b), f.name


@pytest.mark.parametrize("gluing", ["nonred", "full"])
def test_ex71_through_matis_matches_problem_entry_and_jax(ex71, jax_ex71_tight, gluing):
    """ex71 as the reference builds it: the MATIS operator of the blocks ->
    feti_problem_from_matis -> feti_solve.  The problem equals the one of
    the FetiProblem entry (build_ex71) and the JAX package's; the solve
    equals both (the JAX package's solve of that same problem is the count
    test's)."""
    prob = tprob.build_ex71()
    A = tmatis.MatIS.create(prob.K_blocks, prob.l2g, device="cpu")
    mprob, _, _ = tmatis.feti_problem_from_matis(A, np.ones(prob.n_global), coords=prob.coords)
    _same_problem(mprob, prob)
    jA = jmatis.MatIS.create(jnp.asarray(prob.K_blocks), jnp.asarray(prob.l2g))
    jprob, _, _ = jmatis.feti_problem_from_matis(jA, np.ones(prob.n_global), coords=prob.coords)
    _same_problem(mprob, jprob)
    _same_problem(from_arrays(jprob, "cpu"), jprob)
    _same_problem(jprob, ex71[1])  # the input of the shared JAX solve
    tol = dict(rtol=1e-10)
    got = feti_solve(mprob, FetiOptions(gluing=gluing), tol=Tolerances(**tol), device="cpu")
    direct = feti_solve(prob, FetiOptions(gluing=gluing), tol=Tolerances(**tol), device="cpu")
    assert got.result.iterations == direct.result.iterations
    np.testing.assert_array_equal(got.x_global, direct.x_global)
    ref = jax_ex71_tight(gluing)
    assert got.result.iterations == int(ref.result.iterations)
    np.testing.assert_allclose(got.x_global, ref.x_global, rtol=0,
                               atol=1e-9 * np.abs(ref.x_global).max())


@pytest.mark.parametrize("case", ["2d", "1d"])
def test_ex71_lower_dimensions(case):
    """-dim 2 / -dim 1 against direct solves (tests/test_feti.py::
    TestEx71Dimensions): the 1-D coarse space determines every dual
    unknown, so projected CG stops at once on the homogenized solution."""
    kw, atol = (dict(cells=(8, 8), grid=(2, 2)), 1e-4) if case == "2d" else \
        (dict(cells=(12,), grid=(3,)), 1e-10)
    prob = tprob.build_ex71(**kw)
    res = _solve(prob, gluing="nonred")
    assert res.result.reason > 0
    A, b = _assembled(prob)
    np.testing.assert_allclose(res.x_global, np.linalg.solve(A, b), atol=atol)
    ref = _jsolve(jex71.build(**kw), gluing="nonred")
    np.testing.assert_allclose(res.x_global, ref.x_global, rtol=0, atol=atol)
    if case == "2d":
        assert res.result.iterations == int(ref.result.iterations)
    else:
        # G is square (2 x 2), so P = 0: the port's projector returns 0 and
        # CG stops before its first step; the JAX package's P r is round-off
        # (-7e-15) and CG breaks down after one step on negative curvature
        assert (res.result.iterations, int(ref.result.iterations)) == (0, 1)


@pytest.mark.parametrize("precision", ["mixed", "f32"])
def test_precision_policies_match_jax(ex71, precision):
    """'mixed': f32 operator storage behind f64 dual vectors; 'f32': the
    dual QP in f32.  The counts equal the JAX package's; the solutions
    agree to the storage precision."""
    prob, jprob = ex71
    res, ref = _solve(prob, precision=precision), _jsolve(jprob, precision=precision)
    assert res.result.reason == 2
    assert res.result.iterations == int(ref.result.iterations)
    np.testing.assert_allclose(res.x_global, ref.x_global, rtol=0,
                               atol=1e-4 * np.abs(ref.x_global).max())


# -- ragged K+, FetiSolver ----------------------------------------------------------


def _heterogeneous_1d(nes=(4, 9, 6)):
    """1-D Poisson with per-subdomain element counts (tests/test_ragged.py)."""
    ns, nl = len(nes), max(nes) + 1
    h = 1.0 / sum(nes)
    K = np.stack([np.eye(nl)] * ns)
    b = np.zeros((ns, nl))
    l2g = np.full((ns, nl), -1, dtype=np.int64)
    off = 0
    for s, ne in enumerate(nes):
        K[s, : ne + 1, : ne + 1] = 0.0
        i = np.arange(ne)
        for a, c, v in ((0, 0, 1.0), (0, 1, -1.0), (1, 0, -1.0), (1, 1, 1.0)):
            K[s, i + a, i + c] += v
        load = np.sin((off + i + 0.5) * h * np.pi) * 0.5 * h * h
        b[s, :ne] += load
        b[s, 1: ne + 1] += load
        l2g[s, : ne + 1] = off + np.arange(ne + 1)
        off += ne
    return FetiProblem(K_blocks=K, b_loc=decompose_rhs_by_multiplicity(b, l2g), l2g=l2g,
                       dirichlet=np.array([0, sum(nes)]))


def test_ragged_kplus():
    prob = _heterogeneous_1d()
    assert list(tsolve.ragged_sizes(prob.l2g)) == [5, 10, 7]
    assert tsolve.ragged_sizes(tprob.build_feti_ex1(4, 7).l2g) is None
    np.testing.assert_array_equal(tsolve.ragged_sizes(prob.l2g),
                                  jsolve.ragged_sizes(prob.l2g))
    solver = FetiSolver(prob, FetiOptions(ragged_kplus=True), device="cpu")
    assert isinstance(solver.kplus, RaggedBlockDiagCholInv)
    res = solver.solve()
    assert res.result.reason > 0
    A, rhs = _assembled(prob)
    keep = np.setdiff1d(np.arange(prob.n_global), prob.dirichlet)
    x = np.zeros(prob.n_global)
    x[keep] = np.linalg.solve(A[np.ix_(keep, keep)], rhs[keep])
    np.testing.assert_allclose(res.x_global, x, atol=1e-8)


def test_feti_solver_resolves_with_new_loads(ex71):
    """FetiSolver factorizes once: a re-solve with 2 b reuses the same K+
    and gives 2 x; the first solve equals feti_solve."""
    prob, _ = ex71
    solver = FetiSolver(prob, FetiOptions(gluing="nonred"), device="cpu")
    assert isinstance(solver.kplus, BlockDiagCholInv)
    assert set(solver.timings) == {"host_setup_s", "floating_s", "factor_s"}
    kplus = solver.kplus
    r1 = solver.solve(tol=Tolerances(**TIGHT))
    r2 = solver.solve(b_loc=2.0 * prob.b_loc, tol=Tolerances(**TIGHT))
    assert solver.kplus is kplus
    np.testing.assert_array_equal(r1.x_global, _solve(prob, TIGHT, gluing="nonred").x_global)
    np.testing.assert_allclose(r2.x_global, 2.0 * r1.x_global, rtol=0,
                               atol=1e-8 * np.abs(r1.x_global).max())


@pytest.mark.parametrize("opts,match", [
    # a mesh is a permon_tpu_torch.parallel Mesh (make_mesh / make_mesh2): the
    # runs over ranks are tests/test_torch_parallel.py
    (dict(throughput=True, mesh=object()), "Mesh"), (dict(mesh=object()), "Mesh"),
    # without a two-axis mesh there are no redundancy groups: ignored, as in
    # the JAX package (solve.py:380-385)
    (dict(qppf_redundancy=True), None),
])
def test_options_outside_the_slice_raise(ex1, opts, match):
    prob, jprob = ex1
    if match is not None:
        with pytest.raises(TypeError, match=match):
            _solve(prob, **opts)
        return
    res, plain, ref = _solve(prob, **opts), _solve(prob), _jsolve(jprob, **opts)
    assert res.result.iterations == plain.result.iterations == int(ref.result.iterations)
    np.testing.assert_array_equal(res.x_global, plain.x_global)


def test_save_and_bad_options(ex1, tmp_path):
    solver = FetiSolver(ex1[0], device="cpu")
    path = str(tmp_path / "solver.npz")
    solver.save(path)  # the checkpoint of utils/checkpoint.py (tests/test_torch_user.py)
    loaded = FetiSolver.load(path, ex1[0], device="cpu")
    np.testing.assert_array_equal(loaded.solve().x_global, solver.solve().x_global)
    with pytest.raises(ValueError, match="gluing"):
        _solve(ex1[0], gluing="redundant")


# -- contact ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def contact_ref():
    """The serial ex1 obstacle solution on the same 101 nodes (the port's
    MPRGP, held to the reference's output by tests/test_torch_mprgp.py)."""
    A, b, lb = tprob.build_ex1(101)
    x = pt.solve(pt.QP.create(A, b, lb=lb, device="cpu"), tol=Tolerances(rtol=1e-10)).x
    return x.numpy(), lb


def _check_contact(x, lam_I, contact_ref):
    ref, lb = contact_ref
    assert np.max(np.abs(x - ref)) < 1e-6
    assert 3 <= (x - lb < 1e-8).sum() <= 20
    assert float(lam_I.min()) >= -1e-10


def test_contact_through_all_in_one(contact_ref):
    """tests/test_feti.py::TestContact: assemble_qp + BI + the block K+ ->
    all_in_one (dualize, homogenize, project) -> SMALXE -> post-solve."""
    prob, BI, cI, _ = tprob.build_feti_contact(4, 25)
    opts = FetiOptions(gluing="nonred")
    qp, K, fixed, nb = tsolve.assemble_qp(prob, opts, device="cpu")
    qp = qp.replace(BI=BI.with_gather_apply("cpu"), cI=torch.as_tensor(cI))
    kplus = tsolve.make_blockdiag_kplus(K, fixed, prob, nb)
    child, post = all_in_one(qp, dual=True, project=True, kplus=kplus)
    res = pt.solve(child, tol=Tolerances(rtol=1e-8))
    sol = post(Solution(x=res.x, Bt_lambda=getattr(res, "Bt_lambda", None)))
    x = tsolve.assemble_global_mean(sol.x.numpy().reshape(prob.ns, prob.nl), prob.l2g,
                                    prob.n_global)
    _check_contact(x, sol.lambda_I, contact_ref)


def test_contact_through_feti_solve(contact_ref):
    """feti_solve(BI=, cI=): the same problem on the default path (SMALXE
    on the projected dual), its counts equal to the JAX package's."""
    prob, BI, cI, _ = tprob.build_feti_contact(4, 25)
    res = feti_solve(prob, FetiOptions(gluing="nonred"), tol=Tolerances(rtol=1e-8),
                     BI=BI, cI=cI, device="cpu")
    assert res.result.reason > 0
    _check_contact(res.x_global, res.solution.lambda_I, contact_ref)
    jprob, jBI, jcI, _ = jcontact.build(4, 25)
    ref = jsolve.feti_solve(jprob, JaxFetiOptions(gluing="nonred"),
                            tol=JaxTolerances(rtol=1e-8), BI=jBI, cI=jcI)
    got = (res.result.iterations, res.result.inner_iterations, res.result.nmv)
    assert got == tuple(int(v) for v in (ref.result.iterations, ref.result.inner_iterations,
                                         ref.result.nmv))
    np.testing.assert_allclose(res.x_global, ref.x_global, rtol=0, atol=1e-9)
    child, sm, sls = tsolve.prepare_contact_children(prob, FetiOptions(gluing="nonred"),
                                                     BI, cI, device="cpu")
    assert sls is None and child.box is not None and dataclasses.is_dataclass(sm)


# -- the command-line example of this path --------------------------------------


@pytest.mark.parametrize("name", ["feti_ex1", "feti_contact", "feti_ex71"])
def test_example_matches_jax_example(name):
    """The example's main against the JAX package's, in-process: every
    printed line with the numbers masked, and the solution
    (tests/torch_example_parity.py)."""
    check_example(name)
