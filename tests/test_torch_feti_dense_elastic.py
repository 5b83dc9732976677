"""The dense TFETI path of permon_tpu_torch on elasticity, the SMALXE
variants and the host setup it shares with the JAX package, on the CPU.

Tolerances, per check:

- elasticity (ex71 test 2, (8, 6, 4) cells on 7 subdomains, numeric
  nullspace, rtol 1e-6): deterministic dots 64 / 26 iterations exactly (the
  JAX package's pinned counts); the default mode equal to the JAX package's
  count on this CPU (64; the reference's oracle is 66, held within 2) and
  26 with the lumped preconditioner; x_global to 1e-7 of max |x| of the
  JAX package's at equal counts;
- rigid body modes: the port's own K+ counts 64 against the JAX package's
  63 (band 1: the largest eigenvalue of one block differs by one ulp between
  the two LAPACK calls); with the JAX package's K+ handed over the counts
  are equal; x_global to 1e-6 of max |x| either way (at rtol 1e-6 the
  iterates follow last-bit differences of the B and K+ applies);
- SMALXE on the unprojected dual with every ``orth_G`` (ex1, rho 10, the
  injected max eigenvalue): (reason, outer, inner, products) equal to the
  JAX package's, x_global to 1e-12; gluing feasibility 1e-5 of ||b|| for
  the orthonormalizing variants ('inexact' keeps G: 5e-5 in both);
- host setup (eliminate_dirichlet_in_blocks, the floating test,
  numeric_nullspace_blocks' counts, the Dirichlet renumbering): equal
  arrays; numeric bases up to rotation: R R' per block to 1e-12;
- the block K+ (both rho modes) against the JAX package's: factors to
  1e-12.
"""

import dataclasses

import numpy as np
import pytest
import torch

import examples.feti_ex1 as jex1
import examples.feti_ex71 as jex71
import permon_tpu.feti.assembly as jasm
import permon_tpu.feti.solve as jsolve
from permon_tpu.core.convergence import Tolerances as JaxTolerances
from permon_tpu.feti.solve import FetiOptions as JaxFetiOptions
from permon_tpu.solvers.smalxe import SMALXEOptions as JaxSMALXEOptions

import permon_tpu_torch.feti.assembly as tasm
import permon_tpu_torch.feti.solve as tsolve
import permon_tpu_torch.problems as tprob
from permon_tpu_torch.core.convergence import Tolerances
from permon_tpu_torch.feti.solve import FetiOptions, feti_solve
from permon_tpu_torch.interop import from_arrays
from permon_tpu_torch.solvers.smalxe import SMALXEOptions

torch.set_num_threads(2)

ELASTIC = dict(cells=(8, 6, 4), grid=(7, 1, 1), pde="elasticity")


@pytest.fixture(scope="module")
def elastic():
    return tprob.build_ex71(**ELASTIC), jex71.build(**ELASTIC)


@pytest.mark.parametrize("pc,its", [("none", 64), ("lumped", 26)])
def test_elasticity_numeric_deterministic(elastic, pc, its):
    prob, jprob = elastic
    opts = dict(gluing="nonred", pc_dual=pc, nullspace="numeric", deterministic=True)
    got = feti_solve(prob, FetiOptions(**opts), tol=Tolerances(rtol=1e-6), device="cpu")
    ref = jsolve.feti_solve(jprob, JaxFetiOptions(**opts), tol=JaxTolerances(rtol=1e-6))
    assert got.result.reason == 2 and got.result.iterations == its
    assert int(ref.result.iterations) == its
    np.testing.assert_allclose(got.x_global, ref.x_global, rtol=0,
                               atol=1e-7 * np.abs(ref.x_global).max())


@pytest.mark.parametrize("pc", ["none", "lumped"])
def test_elasticity_numeric_default_mode(elastic, pc):
    prob, jprob = elastic
    opts = dict(gluing="nonred", pc_dual=pc, nullspace="numeric")
    got = feti_solve(prob, FetiOptions(**opts), tol=Tolerances(rtol=1e-6), device="cpu")
    assert got.result.reason == 2
    if pc == "lumped":
        assert got.result.iterations == 26
        return
    ref = jsolve.feti_solve(jprob, JaxFetiOptions(**opts), tol=JaxTolerances(rtol=1e-6))
    assert got.result.iterations == int(ref.result.iterations) == 64
    assert abs(got.result.iterations - 66) <= 2  # the reference's own oracle


def test_elasticity_rbm(elastic):
    prob, jprob = elastic
    opts = dict(gluing="nonred", nullspace="rbm", deterministic=True)
    got = feti_solve(prob, FetiOptions(**opts), tol=Tolerances(rtol=1e-6), device="cpu")
    jqp, jK, jfix, jnb = jsolve.assemble_qp(jprob, JaxFetiOptions(**opts))
    jkp = jsolve.make_blockdiag_kplus(jK, jfix, jprob, jnb, rho_mode="exact")
    ref = jsolve._feti_solve_impl(jprob, JaxFetiOptions(**opts), JaxTolerances(rtol=1e-6),
                                  jqp, jkp)
    assert got.result.reason == 2
    assert (got.result.iterations, int(ref.result.iterations)) == (64, 63)
    np.testing.assert_allclose(got.x_global, ref.x_global, rtol=0,
                               atol=1e-6 * np.abs(ref.x_global).max())
    # the same inputs: the JAX package's K+ on the port's QP
    qp, *_ = tsolve.assemble_qp(prob, FetiOptions(**opts), device="cpu")
    same = tsolve._feti_solve_impl(prob, FetiOptions(**opts), Tolerances(rtol=1e-6), qp,
                                   from_arrays(jkp, "cpu"))
    assert same.result.iterations == int(ref.result.iterations)
    np.testing.assert_allclose(same.x_global, ref.x_global, rtol=0,
                               atol=1e-6 * np.abs(ref.x_global).max())


def test_elasticity_2d_matches_direct():
    """tests/test_feti.py::TestEx71Dimensions::test_elasticity_2d."""
    prob = tprob.build_ex71(cells=(6, 4), grid=(3, 1), pde="elasticity")
    res = feti_solve(prob, FetiOptions(gluing="nonred", nullspace="numeric"),
                     tol=Tolerances(rtol=1e-8), device="cpu")
    assert res.result.reason > 0
    n = prob.n_global
    A, b = np.zeros((n, n)), np.zeros(n)
    for s in range(prob.ns):
        real = np.flatnonzero(prob.l2g[s] >= 0)
        g = prob.l2g[s][real]
        A[np.ix_(g, g)] += prob.K_blocks[s][np.ix_(real, real)]
        np.add.at(b, g, prob.b_loc[s][real])
    np.testing.assert_allclose(res.x_global, np.linalg.solve(A, b), atol=1e-5)


@pytest.mark.parametrize("orth", ["gs", "implicit", "gs_lingen", "cholesky", "inexact"])
def test_smalxe_unprojected_orth_variants(orth):
    """-project 0 -qps_smalxe_rho 1e1 -dual_qp_E_orth_type <orth> on ex1
    (tests/test_feti.py::test_smalxe_variant): every count equal to the JAX
    package's, gluing feasibility to 1e-5 of ||b||."""
    sm = dict(rho=1e1, inject_maxeig=True)
    got = feti_solve(tprob.build_feti_ex1(4, 7),
                     FetiOptions(project=False, orth_G=orth, smalxe=SMALXEOptions(**sm)),
                     device="cpu")
    ref = jsolve.feti_solve(jex1.build(4, 7), JaxFetiOptions(
        project=False, orth_G=orth, smalxe=JaxSMALXEOptions(**sm)))
    keys = ("reason", "iterations", "inner_iterations", "nmv")
    assert tuple(int(getattr(got.result, k)) for k in keys) == tuple(
        int(getattr(ref.result, k)) for k in keys)
    assert got.result.reason > 0
    if orth != "inexact":  # 'inexact' keeps G as it is: 47 outer iterations, 5e-5
        assert got.result.iterations <= 20
        rE = got.qp.BE.mv(got.u_decomposed) - got.qp.cE
        assert float(torch.linalg.vector_norm(rE) / torch.linalg.vector_norm(got.qp.b)) < 1e-5
    np.testing.assert_allclose(got.x_global, ref.x_global, rtol=0, atol=1e-12)


def test_dirichlet_numbering_types():
    """QPFetiSetDirichlet's LOCAL / GLOBAL_DECOMPOSED / GLOBAL_UNDECOMPOSED
    spellings of one set give one solution (tests/test_feti.py::
    TestDirichletNumberingTypes), and the renumbering equals the JAX
    package's."""
    prob = tprob.build_feti_ex1(3, 4)
    flat = prob.l2g.reshape(-1)
    dec = np.array([np.flatnonzero(flat == g)[0] for g in prob.dirichlet])
    loc = np.stack([dec // prob.nl, dec % prob.nl], axis=1)
    res0 = feti_solve(prob, device="cpu")
    for ids, numtype in ((dec, "global_decomposed"), (loc, "local")):
        p = dataclasses.replace(prob, dirichlet=ids, dirichlet_numtype=numtype)
        np.testing.assert_array_equal(p.dirichlet_global(),
                                      jasm.dirichlet_global_ids(p.l2g, ids, numtype))
        np.testing.assert_allclose(feti_solve(p, device="cpu").x_global, res0.x_global,
                                   atol=1e-10)


# -- host setup against the JAX package ------------------------------------------


@pytest.mark.parametrize("case", ["ex1", "values_and_repeats", "multi_copy"])
def test_eliminate_dirichlet_in_blocks_equal(case):
    """Array-equal to the JAX package's loop, also with nonzero values, a
    dof listed twice and dofs held by several subdomains."""
    prob = tprob.build_feti_ex1(4, 7)
    if case == "values_and_repeats":
        prob = dataclasses.replace(prob, dirichlet=np.array([0, 28, 7, 0]),
                                   dirichlet_values=np.array([0.5, -1.25, 2.0, 3.0]))
    elif case == "multi_copy":
        prob = tprob.build_ex71((4, 4, 4), (2, 2, 1))
        prob = dataclasses.replace(prob, dirichlet=np.array([5, 37, 62, 100, 30]),
                                   dirichlet_values=np.linspace(-1.0, 2.0, 5))
    jprob = jasm.FetiProblem(**{f.name: getattr(prob, f.name)
                                for f in dataclasses.fields(prob)})
    for got, want in zip(tasm.eliminate_dirichlet_in_blocks(prob),
                         jasm.eliminate_dirichlet_in_blocks(jprob)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [dict(), dict(dirichlet_diag="owner"),
                                dict(cells=(6, 4), grid=(3, 1), pde="elasticity")])
def test_floating_mask_and_numeric_nullspace_equal(kw):
    prob, jprob = tprob.build_ex71(**kw), jex71.build(**kw)
    np.testing.assert_array_equal(prob.floating_mask(device="cpu"), jprob.floating_mask())
    got = tasm.numeric_nullspace_blocks(prob.K_blocks, prob.l2g)
    want = jasm.numeric_nullspace_blocks(jprob.K_blocks, jprob.l2g)
    assert [b.shape for b in got] == [b.shape for b in want]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a @ a.T, b @ b.T, rtol=0, atol=1e-12)


@pytest.mark.parametrize("rho_mode,nullspace", [("exact", "constant"), ("gershgorin", "constant"),
                                                ("exact", "numeric")])
def test_blockdiag_kplus_matches_jax(rho_mode, nullspace):
    kw = dict(cells=(6, 4), grid=(3, 1), pde="elasticity") if nullspace == "numeric" else {}
    prob, jprob = tprob.build_ex71(**kw), jex71.build(**kw)
    opts = dict(gluing="nonred", nullspace=nullspace)
    _, K, fixed, nb = tsolve.assemble_qp(prob, FetiOptions(**opts), device="cpu")
    _, jK, jfixed, jnb = jsolve.assemble_qp(jprob, JaxFetiOptions(**opts))
    np.testing.assert_array_equal(fixed, jfixed)
    got = tsolve.make_blockdiag_kplus(K, fixed, prob, nb, rho_mode=rho_mode)
    want = jsolve.make_blockdiag_kplus(jK, jfixed, jprob, jnb, rho_mode=rho_mode)
    np.testing.assert_allclose(got.chols.numpy(), np.asarray(want.chols), rtol=0, atol=1e-12)
