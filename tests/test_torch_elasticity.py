"""permon_tpu_torch 3-D elasticity through the large path (rigid-body
nullspace, BlockCoarse, reorder_rcm) against the JAX package and a direct
scipy oracle on the same problems, on the CPU.  Tolerances, per check:

- host setup functions (q1_elasticity_emat, rigid_body_modes,
  nullspace_columns_from_blocks with its entry ORDER, build_sparse_elasticity,
  assembled_elasticity_system, build_obstacle_elasticity, reorder_rcm,
  assembled_residual_free): np.array_equal on two shapes, one ragged;
- BlockCoarse.mv against R'(B'v) and rmv against B(Rw): 1e-12; against the
  JAX package's block_coarse_from_R on the same arrays: equal cols / Rb / k,
  applies to 1e-14 (deterministic mode); a whole solve through it on both
  packages: equal counts, solutions to 1e-9 of their size at rtol 1e-9;
- linear elasticity against the scipy direct solve: 1e-6 at rtol 1e-6, the
  dual CG counts equal to the JAX package's at f64 factors with
  deterministic reductions; f32 factors with 2 refinement steps: 1e-4, the
  count within 1 of the JAX package's (its f32 factors come from an f32
  recurrence, the port's from an f64 one);
- elastic contact against the port's own assembled box QP by MPRGP: 1e-5,
  the far face under the gap to 1e-4; SMALXE counts equal to the JAX
  package's for the projected variant at f64 factors, within 2 (outer, M1
  updates) and 5 (inner iterations, products) for SMALBE proper.
"""

import dataclasses
import importlib.util
import os

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

import examples.feti_ex71 as jex71
import examples.feti_large as jfl
import permon_tpu.feti.assembly as jasm
import permon_tpu.feti.large as jlarge
import permon_tpu.qp.transforms as jtransforms
from permon_tpu.core.convergence import Tolerances as JaxTolerances
from permon_tpu.core.detred import deterministic_mode as jax_deterministic_mode
from permon_tpu.core.linop import VStack as JaxVStack
from permon_tpu.feti.solve import FetiOptions as JaxFetiOptions

import permon_tpu_torch as pt
import permon_tpu_torch.feti.assembly as tasm
import permon_tpu_torch.feti.large as tlarge
import permon_tpu_torch.problems as tprob
import permon_tpu_torch.qp.transforms as ttransforms
from permon_tpu_torch.core.convergence import Tolerances
from permon_tpu_torch.core.detred import deterministic_mode
from permon_tpu_torch.core.linop import Product, VStack
from permon_tpu_torch.feti.solve import FetiOptions
from permon_tpu_torch.interop import from_arrays

torch.set_num_threads(2)

CELLS, GRID = (6, 6, 6), (2, 2, 1)
RAGGED = ((7, 6, 8), (2, 2, 1))  # 8 nodes over 2 ranks with a ghost layer: 4 and 5
SHAPES = [(CELLS, GRID), RAGGED]
CONTACT = ((8, 8, 8), (2, 2, 1))


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _same_csr(a, b):
    return a.shape == b.shape and (a != b).nnz == 0


def _assert_same_problem(got, ref):
    for f in ("b_loc", "l2g", "floating", "dirichlet", "coords"):
        a, b = getattr(got, f), getattr(ref, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=f)
    assert got.dirichlet_numtype == ref.dirichlet_numtype
    assert len(got.K_blocks) == len(ref.K_blocks)
    for Ka, Kb in zip(got.K_blocks, ref.K_blocks):
        Ka, Kb = sp.csr_matrix(Ka), sp.csr_matrix(Kb)
        assert _same_csr(Ka, Kb)
        np.testing.assert_array_equal(Ka.indices, Kb.indices)
        np.testing.assert_array_equal(Ka.data, Kb.data)


# -- host setup ----------------------------------------------------------------


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_q1_elasticity_emat_equal(dim):
    np.testing.assert_array_equal(tprob.q1_elasticity_emat(dim, lam=1.3, mu=0.7),
                                  jex71.q1_elasticity_emat(dim, lam=1.3, mu=0.7))


@pytest.mark.parametrize("dim", [2, 3])
def test_rigid_body_modes_equal(dim):
    coords = np.random.RandomState(dim).standard_normal((17, dim))
    got = tasm.rigid_body_modes(coords)
    np.testing.assert_array_equal(got, jasm.rigid_body_modes(coords))
    assert got.shape == (17 * dim, 3 * (dim - 1))
    np.testing.assert_allclose(got.T @ got, np.eye(got.shape[1]), atol=1e-14)
    with pytest.raises(ValueError, match="dim"):
        tasm.rigid_body_modes(np.zeros((4, 4)))


@pytest.mark.parametrize("ks", [(6, 0, 6, 3), (0, 0), (1, 1, 1)])
def test_nullspace_columns_from_blocks_equal_in_order(ks):
    rng = np.random.RandomState(len(ks))
    bases = []
    for k in ks:
        B = rng.standard_normal((40, k))
        B[rng.rand(40, k) < 0.3] = 0.0  # holes: the entries of a column are not a range
        bases.append(B)
    got, ref = tasm.nullspace_columns_from_blocks(bases), jasm.nullspace_columns_from_blocks(bases)
    for a, b in zip(got[:3], ref[:3]):
        np.testing.assert_array_equal(a, b)  # rows, cols, vals: the ORDER too
    assert got[3] == ref[3] == sum(ks)


@pytest.mark.parametrize("cells,grid", SHAPES)
def test_build_sparse_elasticity_equal(cells, grid):
    got = tprob.build_sparse_elasticity(cells, grid, lam=1.2, mu=0.9)
    _assert_same_problem(got, jfl.build_sparse_elasticity(cells, grid, lam=1.2, mu=0.9))
    assert got.coords.shape[1] * 3 == got.nl and got.floating.all()


@pytest.mark.parametrize("cells,grid", SHAPES)
def test_assembled_elasticity_system_equal(cells, grid):
    K, b = tprob.assembled_elasticity_system(cells)
    Kj, bj = jfl.assembled_elasticity_system(cells)
    assert _same_csr(K, Kj)
    np.testing.assert_array_equal(b, bj)


@pytest.mark.parametrize("cells,grid", SHAPES)
@pytest.mark.parametrize("gap", [None, 0.25])
def test_build_obstacle_elasticity_equal(cells, grid, gap):
    prob, BI, cI, g = tprob.build_obstacle_elasticity(cells, grid, gap=gap)
    jprob, jBI, jcI, jg = jfl.build_obstacle_elasticity(cells, grid, gap=gap)
    _assert_same_problem(prob, jprob)
    assert g == jg and BI.shape == tuple(jBI.shape)
    np.testing.assert_array_equal(cI, jcI)
    for f in ("rows", "cols", "vals"):  # the rows in the reference's order
        np.testing.assert_array_equal(getattr(BI, f), np.asarray(getattr(jBI, f)), err_msg=f)


@pytest.mark.parametrize("cells,grid", [((6, 6, 6), (2, 2, 2)), ((7, 6, 8), (2, 2, 1))])
def test_reorder_rcm_equal(cells, grid):
    got = tlarge.reorder_rcm(tprob.build_sparse(cells, grid))
    _assert_same_problem(got, jlarge.reorder_rcm(jfl.build_sparse(cells, grid)))
    # the reordering is a renumbering: the same solution
    o = FetiOptions(gluing="nonred")
    a = tlarge.feti_solve_sparse(got, o, tol=Tolerances(rtol=1e-9), device="cpu")
    b = tlarge.feti_solve_sparse(tprob.build_sparse(cells, grid), o, tol=Tolerances(rtol=1e-9),
                                 device="cpu")
    assert abs(a.result.iterations - b.result.iterations) <= 1
    np.testing.assert_allclose(a.x_global, b.x_global, rtol=0, atol=1e-8)


def test_reorder_rcm_node_blocked_dofs_raise():
    with pytest.raises(NotImplementedError, match="node-level permutation"):
        tlarge.reorder_rcm(tprob.build_sparse_elasticity(CELLS, GRID))


def test_reorder_rcm_one_call_per_pattern(monkeypatch):
    calls = []
    monkeypatch.setattr(tlarge, "rcm_order", lambda K: calls.append(1) or tband_rcm(K))
    from permon_tpu_torch.core.band import rcm_order as tband_rcm

    tlarge.reorder_rcm(tprob.build_sparse((11,) * 3, (3,) * 3))  # 27 boxes of 4^3 or 5^3 nodes
    assert len(calls) < 27


@pytest.mark.parametrize("cells,grid", SHAPES)
def test_assembled_residual_free_equal(cells, grid):
    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(
        "northstar_elasticity", os.path.join(here, "..", "scripts", "northstar_elasticity.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    prob = tprob.build_sparse_elasticity(cells, grid)
    x = np.random.RandomState(1).standard_normal(prob.n_global)
    got, ref = tprob.assembled_residual_free(prob, x), script.assembled_residual_free(prob, x)
    np.testing.assert_allclose(got, ref, rtol=1e-13)
    # and it is the residual of the eliminated assembled system
    K, b = tprob.assembled_elasticity_system(cells)
    xe = spla.spsolve(K.tocsc(), b)
    resid, viol = tprob.assembled_residual_free(prob, xe)
    assert resid < 1e-12 and viol == 0.0


# -- BlockCoarse ---------------------------------------------------------------


@pytest.fixture(scope="module")
def assembled():
    """The small elastic contact problem assembled by both packages
    (f64 factors, in-Hessian Dirichlet: floating and grounded blocks)."""
    opts = dict(gluing="nonred", nullspace="rbm", dirichlet_by_B=False)
    prob, BI, cI, _ = tprob.build_obstacle_elasticity(CELLS, GRID)
    qp, *_ = tlarge.assemble_qp_sparse(prob, FetiOptions(**opts), BI=BI, cI=cI, device="cpu")
    jprob, jBI, jcI, _ = jfl.build_obstacle_elasticity(CELLS, GRID)
    jqp, *_ = jlarge.assemble_qp_sparse(jprob, JaxFetiOptions(**opts), BI=jBI, cI=jcI)
    return qp, jqp


@pytest.mark.parametrize("stack", [False, True], ids=["BE", "VStack(BE,BI)"])
def test_block_coarse_applies(assembled, stack):
    qp, jqp = assembled
    B = VStack((qp.BE, qp.BI)) if stack else qp.BE
    jB = JaxVStack((jqp.BE, jqp.BI)) if stack else jqp.BE
    G = tlarge.block_coarse_from_R(qp.R, B)
    jG = jlarge.block_coarse_from_R(jqp.R, jB)
    assert isinstance(G, tlarge.BlockCoarse) and G.shape == tuple(jG.shape)
    assert G.k == jG.k == qp.R.shape[1] and G.Rb.shape[2] == 6
    np.testing.assert_array_equal(G.cols.numpy(), np.asarray(jG.cols))
    np.testing.assert_array_equal(G.Rb.numpy(), np.asarray(jG.Rb))
    # every coarse column is owned by exactly one slot
    np.testing.assert_array_equal(G.cols.reshape(-1)[G.inv].numpy(), np.arange(G.k))
    rng = np.random.RandomState(2)
    v, w = rng.standard_normal(G.shape[1]), rng.standard_normal(G.shape[0])
    with deterministic_mode(True), jax_deterministic_mode(True):
        gv, gw = G.mv(_t(v)), G.rmv(_t(w))
        np.testing.assert_allclose(gv.numpy(), np.asarray(jG.mv(jnp.asarray(v))), rtol=0,
                                   atol=1e-14 * np.abs(gv.numpy()).max())
        np.testing.assert_allclose(gw.numpy(), np.asarray(jG.rmv(jnp.asarray(w))), rtol=0,
                                   atol=1e-14 * np.abs(gw.numpy()).max())
    np.testing.assert_allclose(gv.numpy(), qp.R.rmv(B.rmv(_t(v))).numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(gw.numpy(), B.mv(qp.R.mv(_t(w))).numpy(), rtol=0, atol=1e-12)
    assert torch.equal(G.mv(_t(v)), gv)  # no accumulation whose order could move
    # interop carries the JAX operator across: the same applies
    Gi = from_arrays(jG.replace(B=jB), "cpu")
    assert torch.equal(Gi.mv(_t(v)), gv) and torch.equal(Gi.rmv(_t(w)), gw)


def test_block_coarse_needs_one_owner_per_column(assembled):
    qp, _ = assembled
    G = tlarge.block_coarse_from_R(qp.R, qp.BE)
    cols = G.cols.clone()
    cols[0, 0] = cols[-1, 0]  # two slots claim one column, another has no owner
    with pytest.raises(ValueError, match="exactly once"):
        tlarge.BlockCoarse(Rb=G.Rb, cols=cols, B=G.B, k=G.k)


def test_block_coarse_none_without_block_structure(assembled):
    from permon_tpu_torch.core.linop import Dense, Ell
    from permon_tpu_torch.qp.sparse_rows import to_scipy

    qp, _ = assembled
    R_sp = to_scipy(qp.R).tolil()
    nlp = qp.BE.nl
    spans = R_sp.copy()
    assert R_sp[:nlp].nnz == 0  # the first block is clamped: grounded, no columns
    spans[1, 0] = 1.0  # column 0 (of the second subdomain) now reaches into the first
    assert tlarge.block_coarse_from_R(Ell.from_scipy(spans.tocsr(), device="cpu"), qp.BE) is None
    empty = R_sp.copy()
    empty[:, 3] = 0.0
    assert tlarge.block_coarse_from_R(Ell.from_scipy(empty.tocsr(), device="cpu"), qp.BE) is None
    # an operator that is no extension over (ns, nl) blocks
    assert tlarge.block_coarse_from_R(qp.R, Dense.create(torch.zeros(3, qp.R.shape[0]))) is None
    assert tlarge._block_shape(VStack((qp.BE, qp.BI))) == (qp.BE.ns, qp.BE.nl)


def test_sparse_coarse_picks_block_coarse_past_the_dense_cutoff(assembled, monkeypatch):
    from permon_tpu_torch.core.linop import DenseTree, Ell
    from permon_tpu_torch.qp.sparse_rows import to_scipy

    qp, _ = assembled
    G, gram = ttransforms._sparse_coarse(qp.R, qp.BE)
    assert isinstance(G, DenseTree)
    monkeypatch.setattr(ttransforms, "DENSE_G_ELEMENTS", 16)
    Gb, gram_b = ttransforms._sparse_coarse(qp.R, qp.BE)
    assert isinstance(Gb, tlarge.BlockCoarse) and (gram != gram_b).nnz == 0
    v = _t(np.random.RandomState(3).standard_normal(G.shape[1]))
    np.testing.assert_allclose(Gb.mv(v).numpy(), G.mv(v).numpy(), rtol=0, atol=1e-12)
    # an R that is not block-diagonal: the lazy product R'(B' .)
    R_sp = to_scipy(qp.R).tolil()
    R_sp[1, 0] = 1.0
    Gl, _ = ttransforms._sparse_coarse(Ell.from_scipy(R_sp.tocsr(), device="cpu"), qp.BE)
    assert isinstance(Gl, Product)


@pytest.mark.parametrize("contact", [False, True], ids=["linear", "contact"])
def test_solve_through_block_coarse_matches_jax(monkeypatch, contact):
    """DENSE_G_ELEMENTS lowered on both packages: the whole solve runs
    through BlockCoarse; equal counts, solutions to 1e-9 of their size at
    rtol 1e-9."""
    monkeypatch.setattr(ttransforms, "DENSE_G_ELEMENTS", 16)
    monkeypatch.setattr(jtransforms, "DENSE_G_ELEMENTS", 16)
    opts = dict(gluing="nonred", nullspace="rbm", dirichlet_by_B=False, deterministic=True,
                coarse="sparse")
    prob, BI, cI, _ = tprob.build_obstacle_elasticity(CELLS, GRID)
    jprob, jBI, jcI, _ = jfl.build_obstacle_elasticity(CELLS, GRID)
    kw, jkw = (dict(BI=BI, cI=cI), dict(BI=jBI, cI=jcI)) if contact else ({}, {})
    solver = tlarge.FetiSolverSparse(prob, FetiOptions(**opts), device="cpu", **kw)
    res = solver.solve(tol=Tolerances(rtol=1e-9))
    assert isinstance(solver._pf.G, tlarge.BlockCoarse) and res.dual_qp is None  # fast path
    ref = jlarge.feti_solve_sparse(jprob, JaxFetiOptions(**opts), tol=JaxTolerances(rtol=1e-9),
                                   **jkw)
    assert type(ref.dual_qp.BE).__name__ == "BlockCoarse"
    assert res.result.reason == 2
    assert res.result.iterations == int(ref.result.iterations)
    if contact:
        assert res.result.inner_iterations == int(ref.result.inner_iterations)
    np.testing.assert_allclose(res.x_global, ref.x_global, rtol=0,
                               atol=1e-9 * np.abs(ref.x_global).max())


# -- elasticity through the large path -----------------------------------------


@pytest.fixture(scope="module")
def eprob():
    return tprob.build_sparse_elasticity(CELLS, GRID)


@pytest.fixture(scope="module")
def oracle():
    K, b = tprob.assembled_elasticity_system(CELLS)
    return spla.spsolve(K.tocsc(), b)


def _err(x, ref):
    return np.linalg.norm(x - ref) / np.linalg.norm(ref)


@pytest.mark.parametrize("by_B", [True, False], ids=["by_B", "in_hessian"])
def test_elasticity_matches_oracle_and_jax_counts(eprob, oracle, by_B):
    opts = dict(gluing="nonred", nullspace="rbm", dirichlet_by_B=by_B, deterministic=True)
    res = tlarge.feti_solve_sparse(eprob, FetiOptions(**opts), tol=Tolerances(rtol=1e-6),
                                   device="cpu")
    ref = jlarge.feti_solve_sparse(jfl.build_sparse_elasticity(CELLS, GRID),
                                   JaxFetiOptions(**opts), tol=JaxTolerances(rtol=1e-6))
    assert res.result.reason == 2
    assert res.result.iterations == int(ref.result.iterations)
    assert _err(res.x_global, oracle) < 1e-6
    k = res.qp.R.shape[1]
    assert k == (24 if by_B else 12)  # 6 modes per floating block; clamped blocks grounded
    if not by_B:  # eliminated: the clamped values are exact, the rest to the tolerance
        resid, viol = tprob.assembled_residual_free(eprob, res.x_global)
        assert resid < 1e-5 and viol == 0.0


def test_elasticity_f32_factors_with_refine(eprob, oracle):
    opts = dict(gluing="nonred", nullspace="rbm", dirichlet_by_B=True)
    res = tlarge.feti_solve_sparse(eprob, FetiOptions(**opts), tol=Tolerances(rtol=1e-6),
                                   device="cpu", kplus_dtype=torch.float32, kplus_refine=2)
    ref = jlarge.feti_solve_sparse(jfl.build_sparse_elasticity(CELLS, GRID),
                                   JaxFetiOptions(**opts), tol=JaxTolerances(rtol=1e-6),
                                   kplus_dtype=jnp.float32, kplus_refine=2)
    assert res.result.reason == 2 and _err(res.x_global, oracle) < 1e-4
    # the port's f32 factors are an f64 recurrence rounded once, the JAX
    # package's an f32 recurrence: the counts may differ by one
    assert abs(res.result.iterations - int(ref.result.iterations)) <= 1


def test_elasticity_ragged_decomposition(oracle):
    """Padding nodes: the modes come from the real nodes only."""
    cells, grid = RAGGED
    prob = tprob.build_sparse_elasticity(cells, grid)
    assert (prob.l2g < 0).any()
    K, b = tprob.assembled_elasticity_system(cells)
    res = tlarge.feti_solve_sparse(prob, FetiOptions(gluing="nonred", nullspace="rbm"),
                                   tol=Tolerances(rtol=1e-7), device="cpu")
    assert res.result.reason == 2
    assert _err(res.x_global, spla.spsolve(K.tocsc(), b)) < 1e-6


def test_elasticity_solver_resolve_equals_fresh_solve(eprob):
    opts = FetiOptions(gluing="nonred", nullspace="rbm", dirichlet_by_B=False, coarse="sparse")
    kw = dict(kplus_dtype=torch.float32, kplus_refine=2, primal_refine=1, device="cpu")
    solver = tlarge.FetiSolverSparse(eprob, opts, **kw)
    r1 = solver.solve(tol=Tolerances(rtol=1e-7))
    assert r1.dual_qp is None  # the fast path, 3 dofs per node through the reassembly tables
    b2 = eprob.b_loc * np.random.RandomState(4).uniform(0.5, 1.5, eprob.b_loc.shape)
    b2 = tasm.decompose_rhs_by_multiplicity(b2, eprob.l2g)
    r2 = solver.solve(b_loc=b2, tol=Tolerances(rtol=1e-7))
    fresh = tlarge.feti_solve_sparse(dataclasses.replace(eprob, b_loc=b2), opts,
                                     tol=Tolerances(rtol=1e-7), **kw)
    assert r2.result.reason == 2
    np.testing.assert_allclose(r2.x_global, fresh.x_global, rtol=0,
                               atol=1e-7 * np.abs(fresh.x_global).max())
    assert np.abs(r2.x_global[eprob.dirichlet]).max() == 0.0
    assert _err(r2.x_global, r1.x_global) > 1e-3  # a different load, a different answer


def test_rbm_needs_whole_nodes_and_coords(eprob):
    l2g = eprob.l2g.copy()
    l2g[1, 4] = -1  # one dof of a node becomes padding, its two siblings stay real
    with pytest.raises(ValueError, match="wholly real or wholly padding"):
        tlarge.assemble_qp_sparse(dataclasses.replace(eprob, l2g=l2g),
                                  FetiOptions(gluing="nonred", nullspace="rbm"), device="cpu")
    with pytest.raises(ValueError, match="coords"):
        tlarge.assemble_qp_sparse(dataclasses.replace(eprob, coords=None),
                                  FetiOptions(gluing="nonred", nullspace="rbm"), device="cpu")
    with pytest.raises(NotImplementedError, match="numeric.*ROADMAP"):
        tlarge.assemble_qp_sparse(eprob, FetiOptions(gluing="nonred", nullspace="numeric"),
                                  device="cpu")


# -- elastic contact -----------------------------------------------------------


@pytest.fixture(scope="module")
def contact_ref():
    """The assembled box QP of the contact problem by the port's MPRGP."""
    cells, grid = CONTACT
    prob, BI, cI, gap = tprob.build_obstacle_elasticity(cells, grid)
    K, b = tprob.assembled_elasticity_system(cells)
    Mx = cells[0] + 1
    ids = np.arange(len(b))
    face = (ids % 3 == 0) & ((ids // 3) % Mx == Mx - 1)
    ub = np.full(len(b), np.inf)
    ub[face] = gap
    xr = pt.solve(pt.QP.create(K, b, ub=ub, device="cpu"),
                  tol=Tolerances(rtol=1e-9, max_it=5000)).x.numpy()
    assert (xr[face] > gap - 1e-8).sum() > 0  # the obstacle binds
    return prob, BI, cI, gap, face, xr


@pytest.mark.parametrize("project", [True, False], ids=["projected", "smalbe"])
def test_elastic_contact_matches_assembled_box_qp(contact_ref, project):
    prob, BI, cI, gap, face, xr = contact_ref
    opts = dict(gluing="nonred", nullspace="rbm", project=project, deterministic=True)
    r = tlarge.feti_solve_sparse(prob, FetiOptions(**opts), BI=BI, cI=cI,
                                 tol=Tolerances(rtol=1e-7), device="cpu")
    assert r.result.reason == 2
    assert _err(r.x_global, xr) < 1e-5
    assert (r.x_global[face] <= gap + 1e-4).all()
    jprob, jBI, jcI, _ = jfl.build_obstacle_elasticity(*CONTACT)
    ref = jlarge.feti_solve_sparse(jprob, JaxFetiOptions(**opts), BI=jBI, cI=jcI,
                                   tol=JaxTolerances(rtol=1e-7))
    got = (r.result.iterations, r.result.inner_iterations, r.result.nmv, r.result.M1_updates)
    want = tuple(int(v) for v in (ref.result.iterations, ref.result.inner_iterations,
                                  ref.result.nmv, ref.result.M1_updates))
    if project:  # the JAX package, same options: equal SMALXE counts
        assert got == want
        np.testing.assert_allclose(r.x_global, ref.x_global, rtol=0, atol=1e-6)
    else:
        # the unprojected dual follows last-bit noise in K+ (27 / 604 / 641 / 14
        # against 28 / 601 / 639 / 13): outer and M1 updates within 2, inner
        # iterations and products within 5, as for the Poisson twin
        assert all(abs(g - w) <= band for g, w, band in zip(got, want, (2, 5, 5, 2))), (got, want)
