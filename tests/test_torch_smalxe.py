"""permon_tpu_torch SMALXE, its operators and preconditioned CG against the
JAX package on the same numpy inputs, with the tolerance stated per check:

- VStack / Penalized / OneRow / PCDual ``mv`` / ``rmv`` through ``interop``:
  rtol 1e-14 (the same products in the same order);
- ``smalxe`` on the equality(+box) QPs of tests/test_smalxe.py, called
  directly and through ``solve``: outer / inner / product / update / hit
  counts and the reason EQUAL, ``x`` and ``Bt_lambda`` to 1e-10, the final
  ``rnorm`` / ``normBu`` to 1e-9 absolute, ``rho`` / ``M1`` to 1e-12;
- a nonzero ``cE`` through the automatic homogenize of ``solve``: the same;
- the inner test's reason ladder against the JAX test on a grid of inputs
  (budget, NaN, outer convergence and divergence, atol, gtol, state 3);
- ``cg(precond=)`` (+ projector) against JAX ``cg``: equal counts, x 1e-12.
"""

import itertools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import permon_tpu as jpt
import permon_tpu.core.linop as jlin
import permon_tpu.solvers.smalxe as jsx
from permon_tpu.core.convergence import Tolerances as JaxTolerances
from permon_tpu.core.detred import deterministic_mode as jax_det
from permon_tpu.pc.dual import PCDual as JaxPCDual
from permon_tpu.qp.projector import ProjOp as JaxProjOp, Projector as JaxProjector
from permon_tpu.solvers.cg import cg as jax_cg

import permon_tpu_torch as pt
import permon_tpu_torch.solvers.smalxe as tsx
from permon_tpu_torch.core.detred import deterministic_mode
from permon_tpu_torch.core.linop import Dense, OneRow, Penalized, Product, VStack
from permon_tpu_torch.interop import from_arrays
from permon_tpu_torch.pc.dual import PCDual
from permon_tpu_torch.qp.projector import ProjOp, Projector
from permon_tpu_torch.solvers.cg import cg

torch.set_num_threads(2)

COUNTS = ("iterations", "inner_iterations", "nmv", "ncg", "nexp", "nprop", "M1_updates",
          "rho_updates", "M1_hits", "eta_hits", "reason", "inner_reason")


def _problem(n=30, seed=0, with_box=True):
    """The QP of tests/test_smalxe.py::_problem."""
    rng = np.random.default_rng(seed)
    L = np.zeros((n, n))
    L[np.arange(n), np.arange(n)] = 2.0
    L[np.arange(n - 1), np.arange(1, n)] = -1.0
    L[np.arange(1, n), np.arange(n - 1)] = -1.0
    A = L + 0.5 * np.eye(n)
    b = rng.normal(size=n)
    BE = np.zeros((2, n))
    BE[0, :] = 1.0
    BE[1, : n // 2] = 1.0
    BE[1, n // 2:] = -1.0
    lb = np.full(n, -0.3) if with_box else None
    return A, b, BE, lb


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _assert_same_run(res, ref, atol=1e-10):
    assert {f: getattr(res, f) for f in COUNTS} == {f: int(getattr(ref, f)) for f in COUNTS}
    np.testing.assert_allclose(res.x.numpy(), np.asarray(ref.x), rtol=0, atol=atol)
    np.testing.assert_allclose(res.Bt_lambda.numpy(), np.asarray(ref.Bt_lambda), rtol=0,
                               atol=atol)
    # the final norms are differences of nearly equal numbers: absolute
    np.testing.assert_allclose([res.rnorm, res.normBu], [float(ref.rnorm), float(ref.normBu)],
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose([res.rho, res.M1], [float(ref.rho), float(ref.M1)], rtol=1e-12)


# -- operators ---------------------------------------------------------------


@pytest.fixture(scope="module")
def stacked():
    rng = np.random.RandomState(3)
    n = 17
    return dict(n=n, A=rng.standard_normal((n, n)), B0=rng.standard_normal((4, n)),
                B1=rng.standard_normal((3, n)), v=rng.standard_normal(n),
                x=rng.standard_normal(n), y=rng.standard_normal(7))


def test_vstack_matches_jax(stacked):
    s = stacked
    jop = jlin.VStack((jlin.Dense.create(jnp.asarray(s["B0"])),
                       jlin.Dense.create(jnp.asarray(s["B1"]))))
    op = from_arrays(jop, "cpu")
    assert isinstance(op, VStack) and op.shape == jop.shape == (7, s["n"])
    assert op.row_offsets == jop.row_offsets == [(0, 4), (4, 7)]
    np.testing.assert_allclose(op.mv(_t(s["x"])).numpy(), np.asarray(jop.mv(jnp.asarray(s["x"]))),
                               rtol=1e-14)
    np.testing.assert_allclose(op.rmv(_t(s["y"])).numpy(),
                               np.asarray(jop.rmv(jnp.asarray(s["y"]))), rtol=1e-14)
    np.testing.assert_array_equal(op.todense().numpy(), np.asarray(jop.todense()))


def test_penalized_matches_jax(stacked):
    s = stacked
    A = s["A"] + s["A"].T
    jop = jlin.Penalized(a=jlin.Dense.create(jnp.asarray(A)),
                         b=jlin.Dense.create(jnp.asarray(s["B0"])), rho=jnp.asarray(2.5))
    op = from_arrays(jop, "cpu")
    assert isinstance(op, Penalized) and op.shape == (s["n"], s["n"])
    ref = np.asarray(jop.mv(jnp.asarray(s["x"])))
    np.testing.assert_allclose(op.mv(_t(s["x"])).numpy(), ref, rtol=1e-14)
    np.testing.assert_allclose(op.rmv(_t(s["x"])).numpy(), ref, rtol=1e-14)
    y, bx = op.mv_parts(_t(s["x"]))
    jy, jbx = jop.mv_parts(jnp.asarray(s["x"]))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-14)
    np.testing.assert_allclose(bx.numpy(), np.asarray(jbx), rtol=1e-14)
    # a float rho (the port's SMALXE passes tensors; callers may pass floats)
    np.testing.assert_allclose(op.replace(rho=2.5).mv(_t(s["x"])).numpy(), ref, rtol=1e-14)


def test_onerow_matches_jax(stacked):
    s = stacked
    jop = jlin.OneRow(v=jnp.asarray(s["v"]))
    op = from_arrays(jop, "cpu")
    assert isinstance(op, OneRow) and op.shape == (1, s["n"])
    np.testing.assert_allclose(op.mv(_t(s["x"])).numpy(), np.asarray(jop.mv(jnp.asarray(s["x"]))),
                               rtol=1e-14)
    np.testing.assert_array_equal(op.rmv(_t([1.5])).numpy(),
                                  np.asarray(jop.rmv(jnp.asarray([1.5]))))
    np.testing.assert_array_equal(op.todense().numpy(), np.asarray(jop.todense()))


@pytest.mark.parametrize("pc_type", ["none", "lumped"])
def test_pcdual_matches_jax(stacked, pc_type):
    s = stacked
    K = s["A"] @ s["A"].T
    jop = JaxPCDual.create(jlin.Dense.create(jnp.asarray(s["B0"])),
                           jlin.Dense.create(jnp.asarray(K)), pc_type)
    op = from_arrays(jop, "cpu")
    assert isinstance(op, PCDual) and op.shape == (4, 4) and op.pc_type == pc_type
    assert (op.K is None) == (pc_type == "none")
    lam = _t(s["y"][:4])
    np.testing.assert_allclose(op.mv(lam).numpy(), np.asarray(jop.mv(jnp.asarray(s["y"][:4]))),
                               rtol=1e-14)
    jP = JaxProjector.create(jlin.Dense.create(jnp.asarray(s["B1"][:2, :4])))
    P = Projector.create(Dense.create(_t(s["B1"][:2, :4])))
    for symmetric in (False, True):
        got = op.projected(P.apply_p, symmetric=symmetric)(lam)
        ref = jop.projected(jP.apply_p, symmetric=symmetric)(jnp.asarray(s["y"][:4]))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12, atol=1e-14)


def test_pcdual_create_rejects_bad_input(stacked):
    B = Dense.create(_t(stacked["B0"]))
    with pytest.raises(ValueError, match="pc_type"):
        PCDual.create(B, None, "jacobi")
    with pytest.raises(ValueError, match="stiffness"):
        PCDual.create(B, None, "lumped")


# -- smalxe --------------------------------------------------------------------


@pytest.mark.parametrize("with_box", [True, False])
def test_smalxe_counts_equal_jax(with_box):
    A, b, BE, lb = _problem(with_box=with_box)
    ref = jsx.smalxe(jpt.QP.create(A, b, BE=BE, lb=lb), tol=JaxTolerances(rtol=1e-7))
    res = pt.smalxe(pt.QP.create(A, b, BE=BE, lb=lb, device="cpu"), tol=pt.Tolerances(rtol=1e-7))
    assert res.reason == 2 and res.iterations > 1 and res.M1_updates >= 1
    _assert_same_run(res, ref)


def test_smalxe_through_solve_dispatch():
    A, b, BE, lb = _problem()
    ref = jpt.solve(jpt.QP.create(A, b, BE=BE, lb=lb), tol=JaxTolerances(rtol=1e-6))
    qp = pt.QP.create(A, b, BE=BE, lb=lb, device="cpu")
    res = pt.solve(qp, tol=pt.Tolerances(rtol=1e-6))
    assert isinstance(res, tsx.SMALXEResult)
    _assert_same_run(res, ref)
    # make_solver closes over the same dispatch
    res2 = pt.make_solver(tol=pt.Tolerances(rtol=1e-6))(qp)
    assert torch.equal(res2.x, res.x) and res2.nmv == res.nmv


def test_smalxe_rho_update_late_and_options_interop():
    """A tight rtol_E drives state 1 -> 3 and the late rho updates (with
    their rescale of the inner maxeig and alpha); the options object
    crosses through interop field by field."""
    A, b, BE, lb = _problem()
    jopts = jsx.SMALXEOptions(rtol_E=0.01, rho=0.5, rho_update_late=4.0)
    opts = from_arrays(jopts)
    assert isinstance(opts, pt.SMALXEOptions) and opts.rho_update_late == 4.0
    assert isinstance(opts.inner, pt.MPRGPOptions)
    ref = jsx.smalxe(jpt.QP.create(A, b, BE=BE, lb=lb), opts=jopts, tol=JaxTolerances(rtol=1e-6))
    res = pt.smalxe(pt.QP.create(A, b, BE=BE, lb=lb, device="cpu"), opts=opts,
                    tol=pt.Tolerances(rtol=1e-6))
    assert res.rho_updates >= 1
    _assert_same_run(res, ref)


@pytest.mark.parametrize("kw", [
    dict(M1_direct=True, M1=50.0, rho_direct=True, rho=3.0, eta_direct=True, eta=0.5),
    dict(maxeig=4.4, maxeig_inner=130.0, M1_update=4.0, rho_update=1.5),
    dict(inject_maxeig=True, rtol_E=0.1, inner_no_gtol_stop=1),
    dict(inner_max_it=15),
    dict(rho=0.1, rho_update=2.0),
    dict(rho=1.0, rho_update_late=4.0),
])
def test_smalxe_option_variants_equal_jax(kw):
    A, b, BE, lb = _problem(seed=1)
    ref = jsx.smalxe(jpt.QP.create(A, b, BE=BE, lb=lb), opts=jsx.SMALXEOptions(**kw),
                     tol=JaxTolerances(rtol=1e-6))
    res = pt.smalxe(pt.QP.create(A, b, BE=BE, lb=lb, device="cpu"),
                    opts=pt.SMALXEOptions(**kw), tol=pt.Tolerances(rtol=1e-6))
    _assert_same_run(res, ref)


def test_smalxe_knoll_history_and_outer_max_it(capsys):
    A, b, BE, lb = _problem()
    jqp = jpt.QP.create(A, b, BE=BE, lb=lb)
    qp = pt.QP.create(A, b, BE=BE, lb=lb, device="cpu")
    jP = JaxProjector.create(jqp.BE)
    P = Projector.create(qp.BE)
    ref = jsx.smalxe(jqp, opts=jsx.SMALXEOptions(knoll=True), tol=JaxTolerances(rtol=1e-6),
                     projector_apply_P=jP.apply_p, history=64)
    res = pt.smalxe(qp, opts=pt.SMALXEOptions(knoll=True, monitor_outer=True),
                    tol=pt.Tolerances(rtol=1e-6), projector_apply_P=P.apply_p, history=64)
    _assert_same_run(res, ref)
    np.testing.assert_allclose(res.rnorm_history.numpy(), np.asarray(ref.rnorm_history),
                               rtol=1e-6, equal_nan=True)
    assert capsys.readouterr().out.count("END   outer") == res.iterations
    # the outer iteration cap: DIVERGED_ITS after 3 outer iterations in both
    ref = jsx.smalxe(jqp, tol=JaxTolerances(rtol=1e-12, max_it=3))
    res = pt.smalxe(qp, tol=pt.Tolerances(rtol=1e-12, max_it=3))
    assert res.reason == -3 and res.iterations == 3
    _assert_same_run(res, ref)


def test_smalxe_nonzero_ce_through_solve():
    A, b, BE, lb = _problem()
    cE = np.array([0.7, -0.2])
    ref = jpt.solve(jpt.QP.create(A, b, BE=BE, cE=cE, lb=lb), tol=JaxTolerances(rtol=1e-7))
    res = pt.solve(pt.QP.create(A, b, BE=BE, cE=cE, lb=lb, device="cpu"),
                   tol=pt.Tolerances(rtol=1e-7))
    _assert_same_run(res, ref)
    x = res.x.numpy()
    assert np.abs(BE @ x - cE).max() < 1e-5 and (x >= lb - 1e-12).all()


def test_mprgp_float_options_are_not_rounded_through_f32():
    """A float option (maxeig, a direct alpha) becomes a scalar of the
    vector dtype in one rounding: 0.3 through float32 is 0.30000001192."""
    from permon_tpu.solvers.mprgp import MPRGPOptions as JaxMPRGPOptions, mprgp as jax_mprgp
    from permon_tpu_torch.solvers.mprgp import mprgp

    A, b, _, lb = _problem()
    for kw in (dict(maxeig=4.4), dict(alpha_direct=True, alpha_user=0.3)):
        ref = jax_mprgp(jpt.QP.create(A, b, lb=lb), opts=JaxMPRGPOptions(**kw),
                        tol=JaxTolerances(rtol=1e-8))
        res = mprgp(pt.QP.create(A, b, lb=lb, device="cpu"), opts=pt.MPRGPOptions(**kw),
                    tol=pt.Tolerances(rtol=1e-8))
        assert float(res.alpha) == float(ref.alpha)
        assert (res.iterations, res.nmv, res.nexp) == (int(ref.iterations), int(ref.nmv),
                                                       int(ref.nexp))


def test_smalxe_requires_equalities():
    A, b, _, lb = _problem()
    with pytest.raises(ValueError, match="equality"):
        pt.smalxe(pt.QP.create(A, b, lb=lb, device="cpu"))
    for qps_type in ("tao", "pcpg"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            pt.solve(pt.QP.create(A, b, lb=lb, device="cpu"), qps_type=qps_type)


def _jax_aux(**kw):
    f64 = jnp.float64
    base = dict(M1=2.0, eta=0.5, gtol=1e-3, ttol_outer=1e-3, atol_outer=1e-50, divtol=1e4,
                norm_rhs_div=1.0, rtol_E=1.0, normBu=0.0, enorm=np.inf, MNormBu=np.inf,
                outer_rnorm=np.inf)
    ints = dict(outer_it=0, outer_max_it=100, budget=50, inner_iter_min=1,
                inner_no_gtol_stop=0, state=1, outer_reason=0)
    base.update({k: v for k, v in kw.items() if k in base})
    ints.update({k: v for k, v in kw.items() if k in ints})
    return jsx._InnerAux(**{k: jnp.asarray(v, f64) for k, v in base.items()},
                         **{k: jnp.int32(v) for k, v in ints.items()},
                         m1_hit=jnp.asarray(False), eta_hit=jnp.asarray(False))


def _torch_aux(**kw):
    f64 = torch.float64
    base = dict(M1=2.0, eta=0.5, rtol_E=1.0)
    base.update({k: v for k, v in kw.items() if k in base})
    host = dict(gtol=1e-3, ttol_outer=1e-3, atol_outer=1e-50, outer_it=0, outer_max_it=100,
                budget=50, inner_iter_min=1, inner_no_gtol_stop=0, state=1)
    host.update({k: v for k, v in kw.items() if k in host})
    return tsx._InnerAux(
        **{k: torch.tensor(v, dtype=f64) for k, v in base.items()}, eta_h=base["eta"],
        div_thresh=kw.get("divtol", 1e4) * kw.get("norm_rhs_div", 1.0),
        normBu=torch.tensor(0.0, dtype=f64), outer_rnorm=torch.tensor(np.inf, dtype=f64),
        **host)


LADDER = [dict(zip(("gnorm", "bu", "i", "state", "inner_no_gtol_stop", "outer_it"), c))
          for c in itertools.product(
              (1e-6, 5e-4, 0.3, 2e5, float("nan"), float("inf")),  # gnorm
              (0.0, 1e-5, 1e-2, 10.0),  # every entry of B u
              (0, 60), (1, 3), (0, 1, 2), (0, 101))]


def test_inner_test_reason_ladder_equals_jax():
    """The Python ``if`` ladder gives the integers of the ``jnp.where``
    ladder in every combination, NaN and Inf included."""
    B = np.eye(3)
    jtest = jsx._make_inner_test(jlin.Dense.create(jnp.asarray(B)), None, False)
    ttest = tsx._InnerTest(Dense.create(_t(B)), False, torch.linalg.vector_norm)
    g = np.zeros(3)
    for case in LADDER:
        kw = {k: case[k] for k in ("state", "inner_no_gtol_stop", "outer_it")}
        u = np.full(3, case["bu"])
        jr, ja = jtest(_jax_aux(**kw), jnp.int32(case["i"]), jnp.asarray(case["gnorm"]),
                       jnp.asarray(u), jnp.asarray(g))
        aux, scal = ttest.device_scalars(_torch_aux(**kw), torch.tensor(case["gnorm"],
                                                                        dtype=torch.float64),
                                         _t(u), _t(g))
        tr, ta = ttest(aux, case["i"], case["gnorm"], _t(u), _t(g),
                       torch.stack(scal).tolist())
        got = (tr, ta.state, ta.outer_reason, ta.m1_hit, ta.eta_hit)
        ref = (int(jr), int(ja.state), int(ja.outer_reason), bool(ja.m1_hit), bool(ja.eta_hit))
        assert got == ref, (case, got, ref)
        np.testing.assert_allclose(float(ta.normBu), float(ja.normBu), rtol=1e-15)


# -- preconditioned CG ---------------------------------------------------------


@pytest.mark.parametrize("projected", [False, True])
@pytest.mark.parametrize("deterministic", [False, True])
def test_cg_precond_counts_equal_jax(projected, deterministic):
    rng = np.random.RandomState(5)
    n = 40
    Q = rng.standard_normal((n, n))
    A = Q @ Q.T + n * np.eye(n)
    b = rng.standard_normal(n)
    M = np.diag(1.0 / np.diag(A))
    G = rng.standard_normal((3, n))
    jqp = jpt.QP.create(A, b)
    qp = pt.QP.create(A, b, device="cpu")
    jkw, kw = {}, {}
    if projected:
        jP, P = JaxProjector.create(jlin.Dense.create(jnp.asarray(G))), Projector.create(
            Dense.create(_t(G)))
        jkw, kw = dict(project=jP.apply_p), dict(project=P.apply_p)
        jqp = jqp.replace(A=jlin.Product((JaxProjOp(pf=jP), jqp.A)), b=jP.apply_p(jqp.b))
        qp = qp.replace(A=Product((ProjOp(pf=P), qp.A)), b=P.apply_p(qp.b))
    with jax_det(deterministic):
        ref = jax_cg(jqp, tol=JaxTolerances(rtol=1e-10), precond=lambda v: jnp.asarray(M) @ v,
                     **jkw)
    with deterministic_mode(deterministic):
        res = cg(qp, tol=pt.Tolerances(rtol=1e-10), precond=lambda v: _t(M) @ v, **kw)
        plain = cg(qp, tol=pt.Tolerances(rtol=1e-10), **kw)
    assert (res.iterations, res.nmv, res.reason) == (int(ref.iterations), int(ref.nmv),
                                                     int(ref.reason))
    assert res.reason == 2 and res.rnorm != plain.rnorm  # M changes the run
    np.testing.assert_allclose(res.x.numpy(), np.asarray(ref.x), rtol=0, atol=1e-12)
    np.testing.assert_allclose(res.rnorm, float(ref.rnorm), rtol=1e-6)

