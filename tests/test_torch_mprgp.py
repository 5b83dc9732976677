"""permon_tpu_torch MPRGP, box constraint, power method and ``solve`` entry
against the JAX package on the CPU: box operations equal on seeded numpy
inputs (f64 and f32), lambda_max to 1e-12 relative, the pinned MPRGP counts
of the tutorials held EXACTLY (tests/test_mprgp_ex1.py, tests/test_jbearing.py)
and the iterates against the JAX solve; the ex1, ex2 and jbearing2
examples' mains against the JAX package's (tests/torch_example_parity.py)."""

import contextlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import permon_tpu as jpt
import permon_tpu_torch as tpt
from permon_tpu.core.convergence import Tolerances as JaxTolerances
from permon_tpu.qpc.box import BoxConstraint as JaxBox
from permon_tpu_torch import resolve_device
from permon_tpu_torch.core.convergence import ConvergedReason, Tolerances
from permon_tpu_torch.core.eig import max_eigenvalue
from permon_tpu_torch.problems import build_ex1, build_ex2, build_jbearing
from permon_tpu_torch.qpc.box import BoxConstraint
from permon_tpu_torch.solvers.driver import default_solver_type
from permon_tpu_torch.solvers.mprgp import MPRGPOptions, mprgp

from torch_example_parity import check_example

torch.set_num_threads(2)

JB_TOL = dict(rtol=1e-6, atol=1e-8)


def _counts(res):
    return (int(res.iterations), int(res.nmv), int(res.ncg), int(res.nexp), int(res.nprop))


def _ex_qps(build, n=100):
    A, b, lb = build(n)
    return (jpt.QP.create(sp.csr_matrix(A), b, lb=lb),
            tpt.QP.create(sp.csr_matrix(A), b, lb=lb, device="cpu"))


def _jb_qps(nx, ny):
    A, rhs, lb, ub = build_jbearing(nx, ny)
    return (jpt.QP.create(A, rhs, lb=lb, ub=ub),
            tpt.QP.create(A, rhs, lb=lb, ub=ub, device="cpu"))


def test_default_device_is_the_card_and_raises_without_one():
    """``device=None`` means the card; this machine has none, so every
    entry point that is given no device raises instead of using the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this case shows the behaviour of a machine without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    A, b, lb = build_ex1(10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpt.QP.create(sp.csr_matrix(A), b, lb=lb)
    assert resolve_device("cpu") == torch.device("cpu")


# ------------------------------------------------------------------- the box


def _box_inputs(dtype, seed):
    rng = np.random.RandomState(seed)
    n = 257
    lb = rng.randn(n).astype(dtype) - 1.0
    ub = lb + rng.rand(n).astype(dtype) * 2.0
    lb[::7] = -np.inf
    ub[::5] = np.inf
    x = rng.randn(n).astype(dtype)
    x[::3] = lb[::3]  # active lower bounds (some of them -inf)
    x[1::3] = ub[1::3]  # active upper bounds
    x[::9] = np.where(np.isfinite(lb[::9]), lb[::9], x[::9])
    g = rng.randn(n).astype(dtype)
    g[::11] = 0.0
    return lb, ub, np.clip(np.nan_to_num(x, posinf=3.0, neginf=-3.0), lb, ub), g


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("bounds", ["both", "lb", "ub"])
def test_box_operations_equal_jax(dtype, bounds):
    lb, ub, x, g = _box_inputs(dtype, seed=3)
    kw = dict(lb=lb if bounds != "ub" else None, ub=ub if bounds != "lb" else None)
    jb = JaxBox.create(len(x), **kw)
    tb = BoxConstraint.create(len(x), device="cpu", **kw)
    assert tb.lb.dtype == tb.ub.dtype == getattr(torch, np.dtype(dtype).name)
    assert (tb.has_lb, tb.has_ub) == (jb.has_lb, jb.has_ub)
    np.testing.assert_array_equal(tb.lb.numpy(), np.asarray(jb.lb))
    np.testing.assert_array_equal(tb.ub.numpy(), np.asarray(jb.ub))
    xt, gt = torch.as_tensor(x), torch.as_tensor(g)
    xj, gj = jnp.asarray(x), jnp.asarray(g)
    far = torch.as_tensor(x * 3)
    np.testing.assert_array_equal(tb.project(far).numpy(), np.asarray(jb.project(jnp.asarray(x * 3))))
    gf_t, gc_t = tb.grads(xt, gt)
    gf_j, gc_j = jb.grads(xj, gj)
    np.testing.assert_array_equal(gf_t.numpy(), np.asarray(gf_j))
    np.testing.assert_array_equal(gc_t.numpy(), np.asarray(gc_j))
    alpha = np.asarray(0.37, dtype)
    np.testing.assert_array_equal(
        tb.grad_reduced(xt, gf_t, torch.as_tensor(alpha)).numpy(),
        np.asarray(jb.grad_reduced(xj, gf_j, jnp.asarray(alpha))))
    feas_t = tb.feas(xt, gt)
    assert feas_t.dtype == xt.dtype
    np.testing.assert_array_equal(feas_t.numpy(), np.asarray(jb.feas(xj, gj)))
    # a direction with zeros at active bounds: 0/0 only in unselected lanes
    d0 = np.where(np.isfinite(lb) & (x == lb), 0.0, g).astype(dtype)
    np.testing.assert_array_equal(tb.feas(xt, torch.as_tensor(d0)).numpy(),
                                  np.asarray(jb.feas(xj, jnp.asarray(d0))))
    ct, cj = tb.chop_bounds(0.5), jb.chop_bounds(0.5)
    np.testing.assert_array_equal(ct.lb.numpy(), np.asarray(cj.lb))
    np.testing.assert_array_equal(ct.ub.numpy(), np.asarray(cj.ub))
    assert tb.chop_bounds(0.0) is tb
    llb_t, lub_t = tb.multipliers_from_lagrangian(gt)
    llb_j, lub_j = jb.multipliers_from_lagrangian(gj)
    for a, b in ((llb_t, llb_j), (lub_t, lub_j)):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    kt, kj = tb.kkt_terms(xt, llb_t, lub_t), jb.kkt_terms(xj, llb_j, lub_j)
    assert [label for label, _ in kt] == [label for label, _ in kj]
    np.testing.assert_allclose([float(v) for _, v in kt], [float(v) for _, v in kj],
                               rtol=1e-5 if dtype == np.float32 else 1e-13)


def test_box_create_infers_dtype_and_fills():
    box = BoxConstraint.create(4, lb=np.zeros(4, np.float32), device="cpu")
    assert box.ub.dtype == torch.float32 and bool(torch.isinf(box.ub).all())
    box = BoxConstraint.create(3, ub=[1, 2, 3], device="cpu")  # ints -> float64
    assert box.lb.dtype == box.ub.dtype == torch.float64 and not box.has_lb
    box = BoxConstraint.create(3, lb=np.zeros(3), dtype="float32", device="cpu")
    assert box.lb.dtype == torch.float32


# ------------------------------------------------------------ the power method


@pytest.mark.parametrize("case", ["ex1", "jbearing_8x12", "jbearing_30x30"])
def test_max_eigenvalue_matches_jax(case):
    if case == "ex1":
        jqp, tqp = _ex_qps(build_ex1)
    else:
        jqp, tqp = _jb_qps(*map(int, case.split("_")[1].split("x")))
    lam_j = float(jpt.max_eigenvalue(jqp.A))
    lam_t = float(max_eigenvalue(tqp.A, device="cpu"))
    np.testing.assert_allclose(lam_t, lam_j, rtol=1e-12)
    if case == "jbearing_8x12":
        # the reference monitor prints alpha=2.0061100039e-01
        np.testing.assert_allclose(2.0 / lam_t, 2.0061100039e-01, rtol=1e-9)


def test_max_eigenvalue_restarts_from_the_nullspace_and_caps_products():
    from permon_tpu_torch.core.linop import Dense

    class Counting(Dense):
        calls = 0

        def mv(self, x):
            type(self).calls += 1
            return super().mv(x)

    # ones is in the nullspace of the graph Laplacian of a path
    L = np.diag([1.0, 2, 2, 2, 1]) - np.diag(np.ones(4), 1) - np.diag(np.ones(4), -1)
    op = Counting.create(torch.as_tensor(L))
    lam = max_eigenvalue(op, tol=1e-10, maxits=500, device="cpu",
                         generator=torch.Generator().manual_seed(1))
    np.testing.assert_allclose(float(lam), np.linalg.eigvalsh(L).max(), rtol=1e-6)
    Counting.calls = 0
    max_eigenvalue(op, tol=0.0, maxits=7, device="cpu")
    assert Counting.calls == 7


# ------------------------------------------------------------- pinned counts

PINNED = {
    "ex1": (181, 200, 156, 18, 7),
    "ex2": (197, 209, 179, 11, 7),
    "jbearing_8x12": (23, 24, 21, 0, 2),
    "jbearing_10x16": (34, 35, 31, 0, 3),
    "jbearing_30x30": (119, 120, 111, 0, 8),
}


@pytest.mark.parametrize("case", list(PINNED))
def test_pinned_counts_and_iterate_against_jax(case):
    """Counts equal the reference oracles exactly; x and g against the JAX
    solve to 1e-10 absolute (same algorithm, same decisions; only the
    order of the f64 sums inside dots and products differs)."""
    if case.startswith("ex"):
        jqp, tqp = _ex_qps(build_ex1 if case == "ex1" else build_ex2)
        jtol, ttol = JaxTolerances(), Tolerances()
    else:
        jqp, tqp = _jb_qps(*map(int, case.split("_")[1].split("x")))
        jtol, ttol = JaxTolerances(**JB_TOL), Tolerances(**JB_TOL)
    rj = jpt.solve(jqp, tol=jtol)
    rt = tpt.solve(tqp, tol=ttol)
    assert rt.reason == ConvergedReason.CONVERGED_RTOL == int(rj.reason)
    assert _counts(rt) == PINNED[case] == _counts(rj)
    assert (rt.nfinc, rt.nfall) == (0, 0)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=0, atol=1e-10)
    np.testing.assert_allclose(rt.g.numpy(), np.asarray(rj.g), rtol=0, atol=1e-10)
    np.testing.assert_allclose(rt.rnorm, float(rj.rnorm), rtol=1e-6)
    np.testing.assert_allclose(float(rt.alpha), float(rj.alpha), rtol=1e-12)
    # the returned iterate is inside the box exactly
    assert bool((rt.x >= tqp.box.lb).all()) and bool((rt.x <= tqp.box.ub).all())
    if case == "jbearing_8x12":
        np.testing.assert_allclose(float(rt.alpha), 2.0061100039e-01, rtol=1e-9)


@pytest.mark.parametrize(
    "kw,ref",
    [
        (dict(expansion_type="gf", explength_type="opt"), (184, 217, 161, 16, 7)),
        (dict(expansion_type="g", explength_type="optapprox"), (161, 189, 134, 27, 0)),
        (dict(expansion_type="gfgr", explength_type="bb"), (200, 215, 174, 14, 12)),
        (dict(expansion_type="projcg"), (160, 175, 134, 14, 12)),
    ],
    ids=["opt", "optapprox", "bb", "projcg"],
)
def test_ex1_variant_counts(kw, ref):
    """The expansion-variant oracles ex1_{opt,optapprox,bb,projcg}.out
    (tests/test_mprgp_ex1.py:130-150)."""
    _, tqp = _ex_qps(build_ex1)
    res = tpt.solve(tqp, **kw)
    assert res.reason == ConvergedReason.CONVERGED_RTOL
    assert _counts(res) == ref
    assert bool((res.x >= tqp.box.lb).all())


@pytest.mark.parametrize(
    "kw",
    [
        dict(expansion_type="ggr", explength_type="opt", fallback=True),
        dict(expansion_type="gf", explength_type="bb", fallback2=True, resetalpha=True),
        dict(expansion_type="gfgr", explength_type="optapprox", gamma=0.5),
        dict(bchop_tol=1.6, alpha_user=1.5),
        dict(alpha_direct=True, alpha_user=0.4, explength_type="bb", fallback=True),
        dict(maxeig=4.2, maxeig_tol=1e-2),
    ],
    ids=["ggr-opt-fallback", "gf-bb-fallback2-reset", "gfgr-optapprox-gamma", "bchop-alpha",
         "alpha-direct-bb-fallback", "maxeig-given"],
)
def test_ex1_option_counts_equal_jax(kw):
    """Options without a pinned oracle: every counter equals the JAX solve."""
    jqp, tqp = _ex_qps(build_ex1)
    rj, rt = jpt.solve(jqp, **kw), tpt.solve(tqp, **kw)
    assert rt.reason == int(rj.reason)
    assert _counts(rt) == _counts(rj)
    assert (rt.nfinc, rt.nfall) == (int(rj.nfinc), int(rj.nfall))
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=0, atol=1e-9)


def test_mixed_precision_within_one_of_181_with_f64_scalars():
    """'mixed': f32 operator and iterates, every dot promoted to f64 through
    the fixed tree (tests/test_precision.py:37-58)."""
    _, tqp = _ex_qps(build_ex1)
    r64 = mprgp(tqp, tol=Tolerances(max_it=10000))
    qmx = tqp.with_precision("mixed")
    assert qmx.dots_dtype == "float64" and qmx.A.data.dtype == torch.float32
    assert qmx.box.lb.dtype == torch.float32
    rmx = mprgp(qmx, tol=Tolerances(max_it=10000), history=256)
    assert r64.iterations == 181
    assert abs(rmx.iterations - 181) <= 1
    assert rmx.reason == r64.reason
    assert rmx.x.dtype == torch.float32 and rmx.rnorm_history.dtype == torch.float64
    np.testing.assert_allclose(rmx.x.numpy(), r64.x.numpy(), atol=1e-5)
    hist = rmx.rnorm_history.numpy()
    assert np.isfinite(hist[: rmx.iterations + 1]).all() and hist[rmx.iterations] == rmx.rnorm


def test_f32_policy_converges():
    _, tqp = _ex_qps(build_ex1)
    res = tpt.solve(tqp.with_precision("f32"), tol=Tolerances(rtol=1e-4))
    assert res.reason == 2 and res.x.dtype == torch.float32 and res.alpha.dtype == torch.float32


def test_make_solver_scopes_deterministic_mode():
    """The fixed-tree dots change no count on ex1 and are scoped to the call."""
    from permon_tpu_torch.core import detred

    jqp, tqp = _ex_qps(build_ex1)
    run = tpt.make_solver(deterministic=True, expansion_type="gfgr", explength_type="bb")
    res = run(tqp)
    assert not detred.enabled()
    rj = jpt.make_solver(deterministic=True, expansion_type="gfgr", explength_type="bb")(jqp)
    assert _counts(res) == _counts(rj) == (200, 215, 174, 14, 12)
    # the same tree on both sides: the iterate agrees to the last bits
    np.testing.assert_allclose(res.x.numpy(), np.asarray(rj.x), rtol=0, atol=1e-13)


def test_hooks_history_and_monitor():
    _, tqp = _ex_qps(build_ex1, n=30)
    base = mprgp(tqp, history=8)
    assert base.rnorm_history.shape == (8,) and base.rnorm_history.dtype == torch.float64
    seen = []

    def conv_test(aux, it, rnorm, x, g):
        seen.append((it, rnorm))
        return (4 if it >= 5 else 0), aux + 1

    res = mprgp(tqp, conv_test=conv_test, conv_aux=0, alpha0=base.alpha, maxeig=torch.tensor(4.0))
    assert (res.reason, res.iterations, res.aux) == (4, 5, 6)
    assert [it for it, _ in seen] == list(range(6))
    assert float(res.alpha) == float(base.alpha)
    np.testing.assert_allclose([r for _, r in seen[:6]], base.rnorm_history.numpy()[:6], rtol=1e-12)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        mprgp(tqp, MPRGPOptions(monitor=True, monitor_cost=True), tol=Tolerances(max_it=3))
    lines = out.getvalue().splitlines()
    assert lines[0].startswith("  0 MPGP [0] ||gp||=") and "alpha=" in lines[0]
    assert lines[1].startswith("  0 MPGP f(x)=")
    with pytest.raises(ValueError):
        MPRGPOptions(expansion_type="nope")


def test_unbounded_qp_runs_as_cg_and_solver_selection_rules():
    A, b, _ = build_ex1(40)
    qp = tpt.QP.create(sp.csr_matrix(A), b, device="cpu")
    assert default_solver_type(qp) == "cg"
    x_ref = np.linalg.solve(A, b)
    np.testing.assert_allclose(tpt.solve(qp, tol=Tolerances(rtol=1e-12)).x.numpy(), x_ref,
                               atol=1e-9)
    res = tpt.solve(qp, qps_type="mprgp", tol=Tolerances(rtol=1e-12))  # no box: plain CG
    assert res.nexp == res.nprop == 0
    np.testing.assert_allclose(res.x.numpy(), x_ref, atol=1e-9)
    boxed = tpt.QP.create(sp.csr_matrix(A), b, lb=np.zeros(40) - 9, device="cpu")
    assert default_solver_type(boxed) == "mprgp"
    assert default_solver_type(boxed.replace(BE=qp.A)) == "smalxe"
    with pytest.raises(ValueError, match="dualize"):
        default_solver_type(boxed.replace(BI=qp.A))
    res_tao = tpt.solve(boxed, qps_type="tao", tol=Tolerances(rtol=1e-10))  # GPCG
    assert res_tao.reason == 2
    np.testing.assert_allclose(res_tao.x.numpy(), tpt.solve(boxed, tol=Tolerances(
        rtol=1e-10)).x.numpy(), atol=1e-8)
    with pytest.raises(ValueError, match="equality"):  # PCPG is ported and needs BE
        tpt.solve(boxed, qps_type="pcpg")
    with pytest.raises(ValueError, match="equality"):  # SMALXE is ported and needs BE
        tpt.solve(boxed, qps_type="smalxe")
    with pytest.raises(ValueError, match="unknown solver"):
        tpt.solve(boxed, qps_type="nope")


# -- the command-line example of this path --------------------------------------


@pytest.mark.parametrize("name", ["ex1", "ex2", "jbearing2"])
def test_example_matches_jax_example(name):
    """The example's main against the JAX package's, in-process: every
    printed line with the numbers masked, and the solution
    (tests/torch_example_parity.py)."""
    check_example(name)
