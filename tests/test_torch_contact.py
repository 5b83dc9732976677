"""permon_tpu_torch contact on the large path and Dirichlet handling against
the JAX package on the same inputs, with the tolerance stated per check:

- host setup (build_obstacle, build_contact, build_dirichlet_rows in both
  search regimes of the JAX package, eliminate_dirichlet_in_sparse_blocks):
  np.array_equal;
- dualize with BI fed the JAX package's factors: d, e, G, box to 1e-13;
- projected contact (SMALXE around MPRGP on P F P) at f64 factors,
  deterministic reductions: outer = 1 on the obstacle box, every count equal
  to the JAX package's, x_global to 1e-8 (rtol 1e-8: at a looser stop the
  last active-set change lands on one side or the other of it); against the
  port's own MPRGP solve of the assembled box QP to 2e-4;
- the unprojected SMALBE twin (16^3 cells, 8 subdomains, rtol_E 0.1): every
  count equal at f64 factors; at f32 factors (whose recurrence the port
  runs in f64, ROADMAP C) outer within 2, inner within 5, updates within 2
  of the JAX package's, both within 5e-3 of the projected solution and
  the KKT residual of the assembled box QP under 5e-4 ||b||;
- solver reuse with contact, Dirichlet in the Hessian (by-B agreement 1e-7,
  boundary values 1e-8..1e-10, new rhs, primal_refine); the lumped
  preconditioner is ignored for contact.  The lumped preconditioner on the
  linear 12^3 problem is tests/test_torch_feti_large.py's, beside the JAX
  solves of that problem it shares programs with.
"""

import dataclasses
import types

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse as sp
import torch

import examples.feti_contact as jfc
import examples.feti_ex1 as jex1
import examples.feti_large as jfl
import permon_tpu.feti.assembly as jasm
import permon_tpu.feti.large as jlarge
from permon_tpu.core.convergence import Tolerances as JaxTolerances
from permon_tpu.feti.solve import FetiOptions as JaxFetiOptions
from permon_tpu.qp.transforms import dualize as jax_dualize
from permon_tpu.solvers.smalxe import SMALXEOptions as JaxSMALXEOptions

import permon_tpu_torch as pt
import permon_tpu_torch.feti.assembly as tasm
import permon_tpu_torch.feti.large as tlarge
from permon_tpu_torch.core.convergence import Tolerances
from permon_tpu_torch.core.linop import VStack
from permon_tpu_torch.feti.large import FetiSolverSparse, SparseFetiProblem, feti_solve_sparse
from permon_tpu_torch.feti.solve import FetiOptions
from permon_tpu_torch.interop import from_arrays
from permon_tpu_torch.problems import (assembled_system, build_contact, build_obstacle,
                                       build_sparse)
from permon_tpu_torch.qp.transforms import dualize
from permon_tpu_torch.solvers.smalxe import SMALXEResult

torch.set_num_threads(2)

COUNTS = ("iterations", "inner_iterations", "nmv", "ncg", "nexp", "nprop", "M1_updates",
          "rho_updates", "reason")
OBSTACLE = ((10,) * 3, (2,) * 3)
TWIN = ((16,) * 3, (2,) * 3)
TWIN_CAP = 0.1 * 16 ** 2 / 2.0


def _counts(res):
    return {f: int(getattr(res, f)) for f in COUNTS}


def _jax_sparse(prob):
    """The JAX package's container over the same host arrays."""
    return jlarge.SparseFetiProblem(
        K_blocks=prob.K_blocks, b_loc=prob.b_loc, l2g=prob.l2g, floating=prob.floating,
        dirichlet=prob.dirichlet, dirichlet_values=prob.dirichlet_values)


def _jax_ext(BI):
    from permon_tpu.core.extension import SubdomainExtension as JaxExt

    return JaxExt(rows=jnp.asarray(BI.rows), cols=jnp.asarray(BI.cols),
                  vals=jnp.asarray(BI.vals), m_dual=BI.m_dual, ns=BI.ns, nl=BI.nl)


def _dirichlet_sprob(vals=(0.5, -0.25)):
    """The 1-D Poisson chain of examples/feti_ex1.py (4 subdomains of 6
    elements) with Dirichlet values at both ends."""
    prob_d = jex1.build(4, 6)
    return SparseFetiProblem(
        K_blocks=[sp.csr_matrix(prob_d.K_blocks[s]) for s in range(4)],
        b_loc=prob_d.b_loc, l2g=prob_d.l2g, floating=np.ones(4, dtype=bool),
        dirichlet=prob_d.dirichlet,
        dirichlet_values=None if vals is None else np.asarray(vals, dtype=float))


def _box_kkt(cells, cap, x, delta=1e-6):
    """||projected gradient|| / ||b|| of the assembled box QP (u <= cap on
    the far face) at x, in scipy f64; a far-face dof within ``delta`` of
    the cap counts as active."""
    A, b = assembled_system(cells)
    Mx = cells[0] + 1
    far = np.arange(len(b)) % Mx == Mx - 1
    g = A @ x - b
    active = far & (x >= cap - delta)
    gP = np.where(active, np.maximum(g, 0.0), g)  # at an upper bound: max(g, 0)
    return float(np.linalg.norm(gP) / np.linalg.norm(b))


# -- host setup --------------------------------------------------------------


@pytest.mark.parametrize("cells,grid", [((6, 5, 4), (2, 2, 1)), ((9, 9, 9), (3, 2, 2))])
def test_build_obstacle_array_equal(cells, grid):
    prob, BI, cI, cap = build_obstacle(cells, grid)
    jprob, jBI, jcI, jcap = jfl.build_obstacle(cells, grid)
    assert cap == jcap and BI.shape == tuple(jBI.shape)
    np.testing.assert_array_equal(cI, jcI)
    for f in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(BI, f), np.asarray(getattr(jBI, f)))
    np.testing.assert_array_equal(prob.l2g, jprob.l2g)
    _, BI2, cI2, cap2 = build_obstacle(cells, grid, cap=1.25)
    assert cap2 == 1.25 and (cI2 == 1.25).all() and BI2.shape == BI.shape


@pytest.mark.parametrize("ns,ne", [(4, 25), (3, 7)])
def test_build_contact_array_equal(ns, ne):
    prob, BI, cI, lb = build_contact(ns, ne)
    jprob, jBI, jcI, jlb = jfc.build(ns, ne)
    np.testing.assert_array_equal(cI, jcI)
    np.testing.assert_array_equal(lb, jlb)
    for f in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(BI, f), np.asarray(getattr(jBI, f)))
    np.testing.assert_array_equal(prob.b_loc, jprob.b_loc)
    np.testing.assert_array_equal(prob.l2g, jprob.l2g)
    np.testing.assert_array_equal(prob.dirichlet, jprob.dirichlet)
    for s in range(ns):
        np.testing.assert_array_equal(prob.K_blocks[s].toarray(), jprob.K_blocks[s])


@pytest.mark.parametrize("regime", ["broadcast", "sorted"])
def test_build_dirichlet_rows_array_equal(regime):
    """The JAX package searches by an O(nd n) broadcast below 2^24 and by a
    sorted search above; the port's one sorted search equals both."""
    rng = np.random.RandomState(0)
    ns, nl, ng = (4, 50, 120) if regime == "broadcast" else (8, 30000, 150000)
    l2g = rng.randint(-1, ng, size=(ns, nl)).astype(np.int64)
    dirichlet = rng.permutation(ng)[:9 if regime == "broadcast" else 80].astype(np.int64)
    prob = types.SimpleNamespace(l2g=l2g, dirichlet=dirichlet,
                                 dirichlet_values=rng.standard_normal(len(dirichlet)),
                                 dirichlet_global=lambda: dirichlet)
    assert (len(dirichlet) * l2g.size < (1 << 24)) == (regime == "broadcast")
    got, ref = tasm.build_dirichlet_rows(prob), jasm.build_dirichlet_rows(prob)
    assert got[3] == ref[3] > 0
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    prob.dirichlet_values = None
    np.testing.assert_array_equal(tasm.build_dirichlet_rows(prob)[4],
                                  jasm.build_dirichlet_rows(prob)[4])


@pytest.mark.parametrize("vals", [None, (0.5, -0.25)])
def test_eliminate_dirichlet_in_sparse_blocks_array_equal(vals):
    prob = _dirichlet_sprob(vals)
    K = [sp.csr_matrix(k) for k in prob.K_blocks]
    Kt, bt, tt, et = tlarge.eliminate_dirichlet_in_sparse_blocks(prob, K)
    Kj, bj, tj, ej = jlarge.eliminate_dirichlet_in_sparse_blocks(_jax_sparse(prob), K)
    np.testing.assert_array_equal(bt, bj)
    np.testing.assert_array_equal(tt, tj)
    assert et.alpha == ej.alpha and set(et.fix_idx) == set(ej.fix_idx)
    for s in range(prob.ns):
        np.testing.assert_array_equal(Kt[s].toarray(), Kj[s].toarray())
    b2 = prob.b_loc * 1.7 + 0.3
    np.testing.assert_array_equal(et.apply_b(b2), ej.apply_b(b2))
    ep = et.eliminated_prob(prob)
    assert len(ep.dirichlet) == 0 and ep.dirichlet_values is None
    np.testing.assert_array_equal(ep.b_loc, bt)


# -- dualize with inequality rows ----------------------------------------------


def test_dualize_with_bi_matches_jax():
    prob, BI, cI, _ = build_obstacle((6, 6, 6), (2, 2, 2))
    jqp, jk, _, _ = jlarge.assemble_qp_sparse(
        _jax_sparse(prob), JaxFetiOptions(gluing="nonred"), BI=_jax_ext(BI), cI=cI)
    qp, kplus = from_arrays(jqp, "cpu"), from_arrays(jk, "cpu")
    assert qp.BI is not None and qp.cI is not None
    jd, _ = jax_dualize(jqp, kplus=jk)
    d, post = dualize(qp, kplus=kplus)
    mE, m = qp.BE.shape[0], qp.BE.shape[0] + qp.BI.shape[0]
    assert isinstance(d.A.ops[0], VStack) and d.A.shape == (m, m)
    np.testing.assert_allclose(d.b.numpy(), np.asarray(jd.b), rtol=0, atol=1e-13)
    np.testing.assert_allclose(d.cE.numpy(), np.asarray(jd.cE), rtol=0, atol=1e-13)
    np.testing.assert_allclose(d.BE.todense().numpy(), np.asarray(jd.BE.todense()), rtol=0,
                               atol=1e-13)
    np.testing.assert_array_equal(d.box.lb.numpy(), np.asarray(jd.box.lb))
    np.testing.assert_array_equal(d.box.ub.numpy(), np.asarray(jd.box.ub))
    assert d.box.has_lb and not d.box.has_ub
    assert torch.isinf(d.box.lb[:mE]).all() and (d.box.lb[mE:] == 0).all()
    lam = torch.as_tensor(np.random.RandomState(1).standard_normal(m))
    np.testing.assert_allclose(d.A.mv(lam).numpy(), np.asarray(jd.A.mv(jnp.asarray(lam.numpy()))),
                               rtol=0, atol=1e-11)
    sol = post(pt.qp.transforms.Solution(x=lam))
    assert sol.lambda_E.shape == (mE,) and sol.lambda_I.shape == (m - mE,)
    # the coarse build over the stacked rows on the host equals the dense one
    ds, _ = dualize(qp, kplus=kplus, coarse="sparse")
    np.testing.assert_allclose(ds.BE.todense().numpy(), d.BE.todense().numpy(), rtol=0,
                               atol=1e-13)
    pf = tlarge.build_sparse_pf(qp, FetiOptions(coarse="sparse"))
    np.testing.assert_array_equal(pf.G.a.numpy(), ds.BE.a.numpy())


def test_dualize_needs_constraints():
    qp = pt.QP.create(np.eye(3), np.ones(3), device="cpu")
    with pytest.raises(ValueError, match="constraints"):
        dualize(qp, kplus=qp.A)


def test_homogenize_shifts_box_and_ci():
    from permon_tpu.qp.transforms import homogenize_eq as jax_homogenize
    from permon_tpu_torch.qp.transforms import homogenize_eq
    import permon_tpu as jpt

    rng = np.random.RandomState(2)
    n = 9
    A = np.eye(n) * 3.0
    b, BE, BI = rng.standard_normal(n), rng.standard_normal((2, n)), rng.standard_normal((3, n))
    lb = np.where(np.arange(n) % 2 == 0, -np.inf, -1.0)
    kw = dict(BE=BE, cE=np.array([0.4, -1.0]), BI=BI, cI=np.ones(3), lb=lb)
    jc, _ = jax_homogenize(jpt.QP.create(A, b, **kw))
    c, post = homogenize_eq(pt.QP.create(A, b, device="cpu", **kw))
    assert c.cE is None
    for f in ("b", "cI"):
        np.testing.assert_allclose(getattr(c, f).numpy(), np.asarray(getattr(jc, f)), rtol=0,
                                   atol=1e-13)
    np.testing.assert_allclose(c.box.lb.numpy(), np.asarray(jc.box.lb), rtol=0, atol=1e-13)
    assert torch.isinf(c.box.lb[::2]).all() and torch.isinf(c.box.ub).all()
    x = post(pt.qp.transforms.Solution(x=torch.zeros(n, dtype=torch.float64))).x
    np.testing.assert_allclose(BE @ x.numpy(), kw["cE"], atol=1e-12)


# -- projected contact ---------------------------------------------------------


@pytest.fixture(scope="module", params=[None, (-0.2, 0.1)], ids=["zero", "values"])
def contact_1d(request):
    """The 1-D obstacle chain; with end values the Dirichlet rows carry a
    nonzero cE."""
    prob, BI, cI, lb = build_contact(4, 25)
    if request.param is not None:
        prob = dataclasses.replace(prob, dirichlet_values=np.asarray(request.param))
    tol = 1e-6
    ref = jlarge.feti_solve_sparse(
        _jax_sparse(prob), JaxFetiOptions(gluing="nonred", deterministic=True),
        BI=_jax_ext(BI), cI=cI, tol=JaxTolerances(rtol=tol))
    return prob, BI, cI, lb, tol, ref


def test_contact_with_dirichlet_rows_matches_jax(contact_1d):
    """Dirichlet rows (a nonzero cE: homogenize shifts the dual box) and
    contact rows together."""
    prob, BI, cI, lb, tol, ref = contact_1d
    res = feti_solve_sparse(prob, FetiOptions(gluing="nonred", deterministic=True), BI=BI,
                            cI=cI, tol=Tolerances(rtol=tol), device="cpu")
    ends = [0.0, 0.0] if prob.dirichlet_values is None else prob.dirichlet_values
    assert isinstance(res.result, SMALXEResult)
    assert (res.qp.cE is None) == (prob.dirichlet_values is None)
    assert _counts(res.result) == _counts(ref.result)
    assert res.result.reason == 2
    np.testing.assert_allclose(res.x_global, ref.x_global, rtol=0, atol=1e-8)
    assert (res.x_global >= lb - 5e-4).all()  # the obstacle, to the dual feasibility level
    np.testing.assert_allclose(res.x_global[[0, -1]], ends, rtol=0, atol=1e-5)
    assert (res.x_global - lb < 1e-6).any()  # the contact set is not empty


def test_solver_reuse_contact(contact_1d):
    """Repeated contact solves reuse the band factors and the coarse
    projector; coarse='sparse' sends the first solve too through
    _ensure_pf, and the nonzero cE keeps both on the eager chain."""
    prob, BI, cI, lb, tol, ref = contact_1d
    opts = FetiOptions(gluing="nonred", coarse="sparse")
    solver = FetiSolverSparse(prob, opts, BI=BI, cI=cI, device="cpu")
    r1 = solver.solve(tol=Tolerances(rtol=tol))
    assert solver._pf is not None
    r2 = solver.solve(tol=Tolerances(rtol=tol))
    np.testing.assert_allclose(r2.x_global, r1.x_global, rtol=0, atol=1e-8)
    fresh = feti_solve_sparse(prob, opts, BI=BI, cI=cI, tol=Tolerances(rtol=tol), device="cpu")
    np.testing.assert_allclose(r1.x_global, fresh.x_global, rtol=0, atol=1e-6)
    np.testing.assert_allclose(r1.x_global, ref.x_global, rtol=0, atol=1e-5)
    r3 = solver.solve(b_loc=prob.b_loc * 1.2, tol=Tolerances(rtol=tol))
    assert r3.result.reason == 2 and (r3.x_global >= lb - 5e-4).all()
    assert np.abs(r3.x_global - r1.x_global).max() > 1e-3


@pytest.fixture(scope="module")
def obstacle_3d():
    prob, BI, cI, cap = build_obstacle(*OBSTACLE)
    tol = 1e-8
    ref = jlarge.feti_solve_sparse(
        _jax_sparse(prob), JaxFetiOptions(gluing="nonred", deterministic=True),
        BI=_jax_ext(BI), cI=cI, tol=JaxTolerances(rtol=tol))
    res = feti_solve_sparse(prob, FetiOptions(gluing="nonred", deterministic=True), BI=BI,
                            cI=cI, tol=Tolerances(rtol=tol), device="cpu")
    return prob, BI, cI, cap, tol, ref, res


def test_obstacle_projected_counts_equal_jax(obstacle_3d):
    prob, BI, cI, cap, tol, ref, res = obstacle_3d
    assert res.result.iterations == 1  # the iterates stay in ker G
    assert _counts(res.result) == _counts(ref.result)
    assert res.result.reason == 2 and res.qp.cE is None
    np.testing.assert_allclose(res.x_global, ref.x_global, rtol=0, atol=1e-8)
    assert res.solution.lambda_I is not None and (res.solution.lambda_I >= 0).all()


def test_obstacle_vs_assembled_box_mprgp(obstacle_3d):
    """Cross-solver, cross-formulation: the port's MPRGP on the assembled
    box-constrained QP (as tests/test_large.py:177-205 holds the JAX
    package)."""
    prob, BI, cI, cap, tol, ref, res = obstacle_3d
    cells = OBSTACLE[0]
    A, b = assembled_system(cells)
    Mx = cells[0] + 1
    ub = np.full(len(b), np.inf)
    ub[np.arange(len(b)) % Mx == Mx - 1] = cap
    xref = pt.solve(pt.QP.create(A, b, ub=ub, device="cpu"),
                    tol=Tolerances(rtol=1e-9, max_it=3000)).x.numpy()
    assert (xref >= ub - 1e-6).any()  # contact is active
    np.testing.assert_allclose(res.x_global, xref, rtol=0, atol=2e-4)
    assert (res.x_global <= ub + 5e-4).all()
    assert _box_kkt(cells, cap, res.x_global) < 1e-6


def test_obstacle_fast_path_and_gather_plain(obstacle_3d):
    """coarse='sparse': first and warm solve on the fast path with the full
    SMALXE result; gather_kernel=False changes nothing on the CPU."""
    prob, BI, cI, cap, tol, ref, res = obstacle_3d
    base = dict(gluing="nonred", deterministic=True, coarse="sparse")
    solver = FetiSolverSparse(prob, FetiOptions(**base), BI=BI, cI=cI, device="cpu")
    r1 = solver.solve(tol=Tolerances(rtol=tol))
    assert r1.dual_qp is None and isinstance(r1.result, SMALXEResult)  # fast path
    assert r1.result.iterations == 1 and r1.result.reason == 2
    np.testing.assert_allclose(r1.x_global, res.x_global, rtol=0, atol=1e-7)
    r2 = solver.solve(b_loc=prob.b_loc * 1.001, tol=Tolerances(rtol=tol))
    assert r2.result.iterations == 1 and r2.result.reason == 2
    plain = FetiSolverSparse(prob, FetiOptions(**base, gather_kernel=False), BI=BI, cI=cI,
                             device="cpu").solve(tol=Tolerances(rtol=tol))
    assert _counts(plain.result) == _counts(r1.result)
    np.testing.assert_array_equal(plain.x_global, r1.x_global)


def test_lumped_is_ignored_for_contact(obstacle_3d, capsys):
    from permon_tpu_torch.sys import tracing

    prob, BI, cI, cap, tol, ref, res = obstacle_3d
    old = tracing.info_enabled
    tracing.set_from_options(info=True)  # the notice is a tracing.info line
    try:
        r = feti_solve_sparse(prob, FetiOptions(gluing="nonred", deterministic=True,
                                                pc_dual="lumped"), BI=BI, cI=cI,
                              tol=Tolerances(rtol=tol), device="cpu")
    finally:
        tracing.set_from_options(info=old)
    assert "INFO: pc_dual='lumped' ignored for contact" in capsys.readouterr().out
    assert _counts(r.result) == _counts(res.result)


# -- SMALBE proper: the unprojected twin ----------------------------------------


@pytest.fixture(scope="module")
def twin():
    prob, BI, cI, _ = build_obstacle(*TWIN, cap=TWIN_CAP)
    return prob, BI, cI


def _twin_solve(twin, f32, project, jax):
    prob, BI, cI = twin
    base = dict(gluing="nonred", deterministic=True, coarse="sparse")
    if jax:
        opts = JaxFetiOptions(**base) if project else JaxFetiOptions(
            **base, project=False, smalxe=JaxSMALXEOptions(rtol_E=0.1))
        kw = dict(kplus_dtype=jnp.float32, kplus_refine=2) if f32 else {}
        return jlarge.FetiSolverSparse(_jax_sparse(prob), opts, BI=_jax_ext(BI), cI=cI,
                                       **kw).solve(tol=JaxTolerances(rtol=1e-6))
    opts = FetiOptions(**base) if project else FetiOptions(
        **base, project=False, smalxe=pt.SMALXEOptions(rtol_E=0.1))
    kw = dict(kplus_dtype=torch.float32, kplus_refine=2) if f32 else {}
    return FetiSolverSparse(prob, opts, BI=BI, cI=cI, device="cpu", **kw).solve(
        tol=Tolerances(rtol=1e-6))


def test_unprojected_twin_f64_counts_equal_jax(twin):
    ref = _twin_solve(twin, f32=False, project=False, jax=True)
    res = _twin_solve(twin, f32=False, project=False, jax=False)
    assert _counts(res.result) == _counts(ref.result)
    assert res.result.reason == 2 and res.result.iterations > 1
    assert res.result.M1_updates >= 1  # the adaptive machinery ran
    np.testing.assert_allclose(res.x_global, ref.x_global, rtol=0, atol=1e-8)
    proj = _twin_solve(twin, f32=False, project=True, jax=False)
    assert proj.result.iterations == 1  # the degenerate case
    assert np.abs(res.x_global - proj.x_global).max() < 5e-3


def test_unprojected_twin_f32_inside_band(twin):
    """f32 factors: the two packages' K+ differ in the last bits (the port
    runs the factor recurrence in f64), and the unprojected SMALBE
    trajectory is sensitive to that noise (the JAX package re-pinned its own
    inner count 121 -> 122 after a one-ulp change)."""
    ref = _twin_solve(twin, f32=True, project=False, jax=True).result
    r = _twin_solve(twin, f32=True, project=False, jax=False)
    res = r.result
    assert res.reason == int(ref.reason) == 2
    assert abs(res.iterations - int(ref.iterations)) <= 2
    assert abs(res.inner_iterations - int(ref.inner_iterations)) <= 5
    assert abs(res.nmv - int(ref.nmv)) <= 7
    assert abs(res.M1_updates - int(ref.M1_updates)) <= 2
    assert abs(res.rho_updates - int(ref.rho_updates)) <= 2
    assert res.M1_updates >= 1 and res.iterations > 1
    proj = _twin_solve(twin, f32=True, project=True, jax=False)
    assert proj.result.iterations == 1
    assert np.abs(r.x_global - proj.x_global).max() < 5e-3
    # the augmented Lagrangian holds the constraints to its own tolerance:
    # the contact set is read with the 5e-3 the solutions agree to
    kkt = _box_kkt(TWIN[0], TWIN_CAP, r.x_global, delta=5e-3)
    assert kkt < 5e-4, kkt  # 4.0e-5 here; the projected solve reads 1.7e-5


# -- Dirichlet in the Hessian ----------------------------------------------------


def test_dirichlet_in_hessian_matches_by_b():
    tol = Tolerances(rtol=1e-8)
    sprob = _dirichlet_sprob(None)
    r_byB = feti_solve_sparse(sprob, FetiOptions(gluing="nonred"), tol=tol, device="cpu")
    r_inK = feti_solve_sparse(sprob, FetiOptions(gluing="nonred", dirichlet_by_B=False),
                              tol=tol, device="cpu")
    ref = jlarge.feti_solve_sparse(_jax_sparse(sprob),
                                   JaxFetiOptions(gluing="nonred", dirichlet_by_B=False),
                                   tol=JaxTolerances(rtol=1e-8))
    np.testing.assert_allclose(r_inK.x_global, r_byB.x_global, rtol=0, atol=1e-7)
    np.testing.assert_allclose(r_inK.x_global, ref.x_global, rtol=0, atol=1e-9)
    assert r_inK.result.iterations == int(ref.result.iterations)
    assert abs(r_inK.x_global[0]) < 1e-10 and abs(r_inK.x_global[-1]) < 1e-10
    assert r_inK.qp.cE is None and r_byB.qp.cE is None  # zero values: nothing to shift
    assert r_inK.qp.R.shape[1] == 2  # the two end blocks are grounded


def test_dirichlet_in_hessian_values():
    tol = Tolerances(rtol=1e-9)
    sprob = _dirichlet_sprob()
    r_byB = feti_solve_sparse(sprob, FetiOptions(gluing="nonred"), tol=tol, device="cpu")
    r_inK = feti_solve_sparse(sprob, FetiOptions(gluing="nonred", dirichlet_by_B=False),
                              tol=tol, device="cpu")
    assert r_byB.qp.cE is not None  # the Dirichlet rows carry the values
    for r in (r_byB, r_inK):
        np.testing.assert_allclose(r.x_global[[0, -1]], [0.5, -0.25], rtol=0, atol=1e-8)
    np.testing.assert_allclose(r_inK.x_global, r_byB.x_global, rtol=0, atol=1e-6)


def test_resolve_new_rhs_reapplies_dirichlet_elimination():
    sprob = _dirichlet_sprob()
    tol = Tolerances(rtol=1e-10)
    opts = FetiOptions(gluing="nonred", dirichlet_by_B=False)
    solver = FetiSolverSparse(sprob, opts, device="cpu")
    solver.solve(tol=tol)
    assert len(solver.prob.dirichlet) == 0  # the problem is kept as solved
    b2 = sprob.b_loc * 1.7 + 0.3
    r2 = solver.solve(b_loc=b2, tol=tol)
    fresh = FetiSolverSparse(dataclasses.replace(sprob, b_loc=b2), opts, device="cpu").solve(
        tol=tol)
    np.testing.assert_allclose(r2.x_global, fresh.x_global, rtol=0, atol=1e-9)
    np.testing.assert_allclose(r2.x_global[[0, -1]], [0.5, -0.25], rtol=0, atol=1e-9)


@pytest.mark.parametrize("by_B", [False, True])
def test_primal_refine_with_dirichlet(by_B):
    """f32 factors + one defect pass: against the eliminated blocks
    (in the Hessian) or with the cE correction of the pass (by rows)."""
    tol = Tolerances(rtol=1e-10)
    opts = FetiOptions(gluing="nonred", dirichlet_by_B=by_B)
    res = FetiSolverSparse(_dirichlet_sprob(), opts, kplus_dtype=torch.float32,
                           primal_refine=1, device="cpu").solve(tol=tol)
    assert len(res.results) == 2
    byB = FetiSolverSparse(_dirichlet_sprob(), FetiOptions(gluing="nonred"),
                           device="cpu").solve(tol=tol)
    np.testing.assert_allclose(res.x_global, byB.x_global, rtol=0, atol=1e-6)
    # by rows the f32 K+ of the one pass bounds the boundary values
    np.testing.assert_allclose(res.x_global[[0, -1]], [0.5, -0.25], rtol=0,
                               atol=1e-6 if by_B else 1e-8)


# -- the linear problem of the rejections ------------------------------------------


@pytest.fixture(scope="module")
def linear_prob():
    return build_sparse((12,) * 3, (2,) * 3)


# -- what raises ---------------------------------------------------------------


def test_contact_with_primal_refine_raises():
    prob, BI, cI, _ = build_obstacle((4,) * 3, (2, 1, 1))
    for call in (feti_solve_sparse, FetiSolverSparse):
        with pytest.raises(ValueError, match="primal_refine assumes a LINEAR solve"):
            call(prob, FetiOptions(gluing="nonred"), primal_refine=1, BI=BI, cI=cI, device="cpu")


@pytest.mark.parametrize("opts,words", [
    (dict(project=False), "project=False"),
    (dict(throughput=True), "throughput=True"),
])
def test_reference_rejections_keep_their_words(linear_prob, opts, words):
    """The two options the JAX package itself rejects on the large path
    raise with the same message in both packages."""
    with pytest.raises(NotImplementedError) as jexc:
        jlarge.assemble_qp_sparse(_jax_sparse(linear_prob), JaxFetiOptions(**opts))
    for call in (feti_solve_sparse, FetiSolverSparse):
        with pytest.raises(NotImplementedError, match=words) as exc:
            call(linear_prob, FetiOptions(**opts), device="cpu")
        assert str(exc.value) == str(jexc.value)


def test_throughput_raises_with_contact_too():
    prob, BI, cI, _ = build_obstacle((4,) * 3, (2, 1, 1))
    with pytest.raises(NotImplementedError, match="throughput"):
        feti_solve_sparse(prob, FetiOptions(throughput=True), BI=BI, cI=cI, device="cpu")
    with pytest.raises(ValueError, match="pc_dual"):
        feti_solve_sparse(prob, FetiOptions(pc_dual="jacobi"), device="cpu")
