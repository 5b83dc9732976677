"""permon_tpu_torch on the card: the CUDA kernels (gather_apply, sell_mv)
against their plain PyTorch versions, and small solves through each kernel
against the same solve through the plain version.  This file imports no JAX (the machine
with the card has none); every test is marked ``cuda`` and skips without
a card.  Run there with:  python -m pytest tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from permon_tpu_torch.core.convergence import Tolerances
from permon_tpu_torch.core.extension import GatherTable, SubdomainExtension
from permon_tpu_torch.core import sell
from permon_tpu_torch.core.sell import (SEll, gather_apply, gather_apply_plain,
                                        kernel_launchers, sell_mv)
from permon_tpu_torch.feti.assembly import build_gluing
from permon_tpu_torch.feti.large import FetiSolverSparse, feti_solve_sparse
from permon_tpu_torch.feti.solve import FetiOptions
from permon_tpu_torch.problems import (build_contact, build_jbearing, build_obstacle,
                                       build_sparse, rcm_permuted)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the gather kernel has no CPU mode")
    return torch.device("cuda")


def _gluing_ext(device, cells=(10, 10, 10), grid=(2, 2, 2)):
    prob = build_sparse(cells, grid)
    r, c, v, m = build_gluing(prob.l2g, "nonred", True)
    return SubdomainExtension.from_coo(r, c, v, m=m, ns=prob.ns,
                                       nl=prob.nl).with_gather_apply(device)


def _plain(tab, x):
    out = gather_apply_plain(tab.idx, tab.vals, x)
    if tab.ov_tgt is not None:
        gather_apply_plain(tab.ov_idx, tab.ov_vals, x, out=out, tgt=tab.ov_tgt)
    return out


@pytest.mark.parametrize("vdt", [torch.float64, torch.float32])
@pytest.mark.parametrize("xdt", [torch.float64, torch.float32])
def test_kernel_equals_plain_bitwise(cuda_device, vdt, xdt):
    B = _gluing_ext(cuda_device)
    assert B.gBt.ov_tgt is not None  # overflow planes exercised
    rng = np.random.RandomState(0)
    for tab, n in ((B.gB, B.ns * B.nl), (B.gBt, B.m_dual)):
        tab = tab.cast(vdt)
        x = torch.as_tensor(rng.standard_normal(n), dtype=xdt, device=cuda_device)
        n0 = gather_apply.launches
        got = tab.apply(x)
        assert gather_apply.launches == n0 + 1  # the overflow rides in the same launch
        ref = _plain(tab, x)
        torch.cuda.synchronize()
        assert got.dtype == torch.promote_types(vdt, xdt)
        assert torch.equal(got, ref)


@pytest.mark.parametrize("vdt", [torch.float64, torch.float32])
@pytest.mark.parametrize("xdt", [torch.float64, torch.float32])
def test_replaced_gather_kernel_equals_new_bitwise(cuda_device, vdt, xdt):
    """The kernel of the first port (two launches for a table with
    overflow) against the single launch, on padded and on compact planes."""
    B = _gluing_ext(cuda_device)
    rng = np.random.RandomState(1)
    for tab, n in ((B.gB, B.ns * B.nl), (B.gBt, B.m_dual)):
        x = torch.as_tensor(rng.standard_normal(n), dtype=xdt, device=cuda_device)
        padded = tab.cast(vdt)
        compact = padded.replace(idx=padded.idx.contiguous(), vals=padded.vals.contiguous())
        ref = _plain(padded, x)
        for t in (padded, compact):
            new, out_new = kernel_launchers(t, x)
            old, out_old = kernel_launchers(t, x, version="v1")
            assert len(new) == 1 and len(old) == (2 if t.ov_tgt is not None else 1)
            n0 = gather_apply.launches
            for fn in new + old:
                fn()
            torch.cuda.synchronize()
            assert gather_apply.launches == n0  # the timing helper counts nothing
            assert torch.equal(out_new, ref) and torch.equal(out_old, ref)


def test_wrapper_raises_on_noncontiguous(cuda_device):
    idx = torch.zeros((4, 2), dtype=torch.int32, device=cuda_device).T
    vals = torch.ones((2, 4), dtype=torch.float64, device=cuda_device)
    x = torch.ones(3, dtype=torch.float64, device=cuda_device)
    with pytest.raises(ValueError):
        gather_apply(GatherTable(idx=idx, vals=vals, n_src=3), x)


def test_gather_plan_checks_x_on_every_call(cuda_device):
    """After a plan exists a wrong x still raises, and nothing launches."""
    tab = _gluing_ext(cuda_device).gBt
    x = torch.ones(tab.n_src, dtype=torch.float64, device=cuda_device)
    tab.apply(x)
    n0 = gather_apply.launches
    for bad, exc in ((x[:-1], ValueError), (x.half(), TypeError), (x.cpu(), ValueError),
                     (torch.ones(2 * tab.n_src, dtype=torch.float64,
                                 device=cuda_device)[::2], ValueError)):
        with pytest.raises(exc):
            tab.apply(bad)
    assert gather_apply.launches == n0
    assert tab.replace(kernel=False).__dict__.get("_plan") is None  # a new object, a new plan


def test_kernel_solve_equals_plain_solve(cuda_device):
    """gather_kernel=None (the kernel) and False (the plain version) give
    the same deterministic solve bit for bit."""
    prob = build_sparse((12,) * 3, (2,) * 3)
    tol = Tolerances(rtol=1e-6)
    runs = []
    for gk in (None, False):
        gather_apply.launches = 0
        res = feti_solve_sparse(prob, FetiOptions(gluing="nonred", deterministic=True,
                                                  gather_kernel=gk),
                                tol=tol, device=cuda_device)
        runs.append((res, gather_apply.launches))
    (rk, nk), (rp, np_) = runs
    assert nk > 0 and np_ == 0
    assert rk.result.iterations == rp.result.iterations
    np.testing.assert_array_equal(rk.x_global, rp.x_global)


def test_fast_path_reuse_on_card(cuda_device):
    prob = build_sparse((12,) * 3, (2,) * 3)
    solver = FetiSolverSparse(prob, FetiOptions(gluing="nonred", coarse="sparse",
                                                deterministic=True),
                              kplus_dtype=torch.float32, kplus_refine=2,
                              primal_refine=1, device=cuda_device)
    r1 = solver.solve(tol=Tolerances(rtol=1e-6))
    r2 = solver.solve(b_loc=prob.b_loc * 1.5, tol=Tolerances(rtol=1e-6))
    assert r1.result.reason == 2 and r2.result.reason == 2
    np.testing.assert_allclose(r2.x_global, 1.5 * r1.x_global, atol=1e-6)


@pytest.mark.parametrize("project", [True, False])
def test_contact_kernel_solve_equals_plain_solve(cuda_device, project):
    """Contact through the gather kernel (BE and BI tables) and through the
    plain version: equal counts, bitwise equal x_global; projected (one
    outer iteration) and unprojected SMALBE."""
    from permon_tpu_torch.solvers.smalxe import SMALXEOptions

    prob, BI, cI, cap = build_obstacle((10,) * 3, (2,) * 3)
    kw = {} if project else dict(project=False, smalxe=SMALXEOptions(rtol_E=0.1))
    runs = []
    for gk in (None, False):
        gather_apply.launches = 0
        res = feti_solve_sparse(prob, FetiOptions(gluing="nonred", deterministic=True,
                                                  gather_kernel=gk, **kw),
                                BI=BI, cI=cI, tol=Tolerances(rtol=1e-7), device=cuda_device)
        runs.append((res, gather_apply.launches))
    (rk, nk), (rp, np_) = runs
    assert nk > 0 and np_ == 0
    # every F apply launches the kernel four times: B' and B of BE and of BI
    assert nk >= 4 * rk.result.nmv
    assert rk.result.reason == 2 and (rk.result.iterations == 1) == project
    for f in ("iterations", "inner_iterations", "nmv", "M1_updates", "rho_updates"):
        assert getattr(rk.result, f) == getattr(rp.result, f)
    np.testing.assert_array_equal(rk.x_global, rp.x_global)
    far = np.arange(prob.n_global) % 11 == 10
    assert (rk.x_global[far] <= cap + 5e-4).all() and (rk.x_global[far] >= cap - 5e-4).any()


def test_contact_with_dirichlet_rows_on_card_equals_cpu(cuda_device):
    """Dirichlet rows with values (a nonzero cE) and contact rows: the card
    and the CPU run of the port agree in counts and solution at f64."""
    prob, BI, cI, lb = build_contact(4, 25)
    prob.dirichlet_values = np.array([-0.2, 0.1])
    runs = [feti_solve_sparse(prob, FetiOptions(gluing="nonred", deterministic=True), BI=BI,
                              cI=cI, tol=Tolerances(rtol=1e-6), device=dev)
            for dev in (cuda_device, "cpu")]
    assert runs[0].result.reason == 2
    assert runs[0].result.iterations == runs[1].result.iterations
    assert abs(runs[0].result.inner_iterations - runs[1].result.inner_iterations) <= 2
    np.testing.assert_allclose(runs[0].x_global, runs[1].x_global, rtol=0, atol=1e-6)


@pytest.mark.parametrize("with_box", [True, False])
def test_smalxe_counts_on_card_equal_cpu(cuda_device, with_box):
    """SMALXE at f64 on the card and on the CPU: the same outer / inner /
    product / update counts (the decisions are made on the host from values
    read back exactly; the operands differ by the GEMV's rounding only)."""
    import permon_tpu_torch as pt

    rng = np.random.default_rng(0)
    n = 30
    A = 2.5 * np.eye(n) - np.eye(n, k=1) - np.eye(n, k=-1)
    b = rng.normal(size=n)
    BE = np.ones((2, n))
    BE[1, n // 2:] = -1.0
    lb = np.full(n, -0.3) if with_box else None
    runs = [pt.smalxe(pt.QP.create(A, b, BE=BE, lb=lb, device=dev),
                      tol=Tolerances(rtol=1e-7)) for dev in (cuda_device, "cpu")]
    for f in ("iterations", "inner_iterations", "nmv", "M1_updates", "rho_updates", "reason"):
        assert getattr(runs[0], f) == getattr(runs[1], f), f
    assert runs[0].reason == 2 and runs[0].x.device.type == "cuda"
    np.testing.assert_allclose(runs[0].x.cpu().numpy(), runs[1].x.numpy(), rtol=0, atol=1e-10)


def test_lumped_fast_path_on_card(cuda_device):
    prob = build_sparse((12,) * 3, (2,) * 3)
    solver = FetiSolverSparse(prob, FetiOptions(gluing="nonred", pc_dual="lumped",
                                                coarse="sparse", deterministic=True),
                              device=cuda_device)
    r1 = solver.solve(tol=Tolerances(rtol=1e-6))
    r2 = solver.solve(b_loc=prob.b_loc * 2.0, tol=Tolerances(rtol=1e-6))
    assert r1.result.reason == 2 and r1.result.iterations == r2.result.iterations
    np.testing.assert_allclose(r2.x_global, 2.0 * r1.x_global, atol=1e-6)


# ------------------------------------------------------------------- sell_mv


def _skewed(n=3000, seed=0):
    """Unstructured, with a dense row, a dense column and empty rows."""
    import scipy.sparse as sp

    a = sp.random(n, n, density=0.002, random_state=np.random.RandomState(seed)).tolil()
    a[17, :] = np.random.RandomState(seed + 1).randn(n)
    a[:, 5] = np.random.RandomState(seed + 2).randn(n)[:, None]
    a[100:164, :] = 0.0
    return a.tocsr()


@pytest.mark.parametrize("vdt", [torch.float64, torch.float32])
@pytest.mark.parametrize("xdt", [torch.float64, torch.float32])
def test_sell_mv_kernel_equals_plain_bitwise(cuda_device, vdt, xdt):
    a = _skewed()
    op = SEll.from_scipy(a, with_transpose=True, device=cuda_device)
    op = op.replace(vals=op.vals.to(vdt), t_plan=op.t_plan.replace(vals=op.t_plan.vals.to(vdt)))
    plain = op.replace(kernel=False, t_plan=op.t_plan.replace(kernel=False))
    x = torch.as_tensor(np.random.RandomState(3).standard_normal(a.shape[1]), dtype=xdt,
                        device=cuda_device)
    n0 = sell_mv.launches
    got, got_t = op.mv(x), op.rmv(x)
    assert sell_mv.launches == n0 + 2
    ref, ref_t = plain.mv(x), plain.rmv(x)
    torch.cuda.synchronize()
    assert sell_mv.launches == n0 + 2  # kernel=False launches nothing
    assert got.dtype == xdt and torch.equal(got, ref) and torch.equal(got_t, ref_t)
    assert bool((got[100:164] == 0).all())  # rows without nonzeros write 0
    if vdt == xdt == torch.float64:
        y = a @ x.cpu().numpy()
        np.testing.assert_allclose(got.cpu().numpy(), y, rtol=0, atol=1e-12 * np.abs(y).max())


@pytest.mark.parametrize("vdt", [torch.float64, torch.float32])
@pytest.mark.parametrize("xdt", [torch.float64, torch.float32])
def test_replaced_sell_mv_kernel_equals_new_bitwise(cuda_device, vdt, xdt):
    a = _skewed()
    op = SEll.from_scipy(a, device=cuda_device)
    op = op.replace(vals=op.vals.to(vdt))
    x = torch.as_tensor(np.random.RandomState(4).standard_normal(a.shape[1]), dtype=xdt,
                        device=cuda_device)
    ref = op.replace(kernel=False).mv(x)
    (new,), out_new = kernel_launchers(op, x)
    (old,), out_old = kernel_launchers(op, x, version="v1")
    n0 = sell_mv.launches
    new(), old()
    torch.cuda.synchronize()
    assert sell_mv.launches == n0
    assert torch.equal(out_new, ref) and torch.equal(out_old, ref)


def test_sell_mv_cuda_tensor_never_reaches_plain(cuda_device, monkeypatch):
    def boom(*args, **kwargs):
        raise AssertionError("the plain version was called for a CUDA tensor")

    op = SEll.from_scipy(_skewed(500), device=cuda_device)
    x = torch.ones(500, dtype=torch.float64, device=cuda_device)
    monkeypatch.setattr(sell, "sell_mv_plain", boom)
    op.mv(x)  # launches the kernel
    with pytest.raises(AssertionError, match="plain version"):
        op.replace(kernel=False).mv(x)


def test_sell_mv_raises_on_noncontiguous(cuda_device):
    op = SEll.from_scipy(_skewed(500), device=cuda_device)
    x = torch.ones(1000, dtype=torch.float64, device=cuda_device)[::2]
    with pytest.raises(ValueError, match="contiguous"):
        op.mv(x)
    with pytest.raises(ValueError, match="one device"):
        op.mv(torch.ones(500, dtype=torch.float64))
    op.mv(torch.ones(500, dtype=torch.float64, device=cuda_device))  # the plan exists now
    n0 = sell_mv.launches
    with pytest.raises(ValueError, match="contiguous"):
        op.mv(x)
    with pytest.raises(ValueError, match="length 500"):
        op.mv(torch.ones(499, dtype=torch.float64, device=cuda_device))
    with pytest.raises(TypeError):
        op.mv(torch.ones(500, dtype=torch.float16, device=cuda_device))
    assert sell_mv.launches == n0


def test_qp_kernel_solve_equals_plain_solve(cuda_device):
    """QP.create -> SEll -> MPRGP with the default device: the kernel and
    kernel=False give the same counts and a bitwise equal iterate."""
    import permon_tpu_torch as pt

    Ap, bp, lbp, ubp, _ = rcm_permuted(*build_jbearing(64, 64))
    qp = pt.QP.create(Ap, bp, lb=lbp, ub=ubp)
    assert isinstance(qp.A, SEll) and qp.b.device.type == "cuda"
    tol = Tolerances(rtol=1e-6, atol=1e-8)
    sell_mv.launches = 0
    rk = pt.solve(qp, tol=tol)
    nk = sell_mv.launches
    plain_A = qp.A.replace(kernel=False, t_plan=None if qp.A.t_plan is None
                           else qp.A.t_plan.replace(kernel=False))
    rp = pt.solve(qp.replace(A=plain_A), tol=tol)
    assert rk.reason == 2 and nk > rk.nmv and sell_mv.launches == nk
    assert (rk.iterations, rk.nmv, rk.ncg, rk.nexp, rk.nprop) == (
        rp.iterations, rp.nmv, rp.ncg, rp.nexp, rp.nprop)
    assert torch.equal(rk.x, rp.x)


# -- the band coarse projector and BlockCoarse on the card ----------------------


def test_band_projector_on_card_equals_cpu(cuda_device):
    """A 3000-subdomain chain (more than 2048 coarse rows: the band GG' by
    default) on the card against the CPU: 1e-12, and two coarse solves on
    the card bitwise equal."""
    from permon_tpu_torch.qp.projector import Projector

    ns, nl = 3000, 4
    l2g = np.arange(ns)[:, None] * (nl - 1) + np.arange(nl)[None, :]
    r, c, v, m = build_gluing(l2g, "nonred", True)
    ext = SubdomainExtension.from_coo(r, c, v, m=m, ns=ns, nl=nl)
    pf_c = Projector.create(ext.with_gather_apply("cpu"), orthonormal_rows=False)
    pf_g = Projector.create(ext.with_gather_apply(cuda_device), orthonormal_rows=False)
    assert pf_g.ggt_band is not None and pf_g.ggt_band.Dinv.device.type == "cuda"
    rng = np.random.RandomState(11)
    x, w = rng.standard_normal(ext.shape[1]), rng.standard_normal(m)
    for name, arg in (("apply_cp", w), ("apply_p", x), ("apply_half_q", x)):
        got = getattr(pf_g, name)(torch.as_tensor(arg, device=cuda_device))
        ref = getattr(pf_c, name)(torch.as_tensor(arg))
        assert float((got.cpu() - ref).abs().max()) <= 1e-12 * float(ref.abs().max())
    wg = torch.as_tensor(w, device=cuda_device)
    assert torch.equal(pf_g.apply_cp(wg), pf_g.apply_cp(wg))


def test_block_coarse_on_card_equals_cpu_and_is_deterministic(cuda_device):
    from permon_tpu_torch.core.linop import VStack
    from permon_tpu_torch.feti.large import (BlockCoarse, assemble_qp_sparse,
                                             block_coarse_from_R)
    from permon_tpu_torch.problems import build_obstacle_elasticity

    prob, BI, cI, _ = build_obstacle_elasticity((6, 6, 6), (2, 2, 1))
    opts = FetiOptions(gluing="nonred", nullspace="rbm", dirichlet_by_B=False)
    qp_g, *_ = assemble_qp_sparse(prob, opts, BI=BI, cI=cI, device=cuda_device)
    qp_c, *_ = assemble_qp_sparse(prob, opts, BI=BI, cI=cI, device="cpu")
    G_g = block_coarse_from_R(qp_g.R, VStack((qp_g.BE, qp_g.BI)))
    G_c = block_coarse_from_R(qp_c.R, VStack((qp_c.BE, qp_c.BI)))
    assert isinstance(G_g, BlockCoarse) and G_g.Rb.device.type == "cuda"
    rng = np.random.RandomState(12)
    v, w = rng.standard_normal(G_c.shape[1]), rng.standard_normal(G_c.shape[0])
    vg, wg = torch.as_tensor(v, device=cuda_device), torch.as_tensor(w, device=cuda_device)
    n0 = gather_apply.launches
    got_v, got_w = G_g.mv(vg), G_g.rmv(wg)
    assert gather_apply.launches == n0 + 4  # B' and B of BE and of BI, on the kernel
    for got, ref in ((got_v, G_c.mv(torch.as_tensor(v))), (got_w, G_c.rmv(torch.as_tensor(w)))):
        assert float((got.cpu() - ref).abs().max()) <= 1e-12 * float(ref.abs().max())
    assert torch.equal(G_g.mv(vg), got_v) and torch.equal(G_g.rmv(wg), got_w)


def test_elastic_contact_on_card(cuda_device):
    """Elastic contact through the kernel and through the plain version:
    equal counts, bitwise equal x_global."""
    from permon_tpu_torch.problems import build_obstacle_elasticity

    prob, BI, cI, gap = build_obstacle_elasticity((8, 8, 8), (2, 2, 1))
    base = dict(gluing="nonred", nullspace="rbm", deterministic=True, dirichlet_by_B=False)
    res = {}
    for kernel in (None, False):
        n0 = gather_apply.launches
        r = feti_solve_sparse(prob, FetiOptions(**base, gather_kernel=kernel), BI=BI, cI=cI,
                              tol=Tolerances(rtol=1e-7), device=cuda_device)
        assert (gather_apply.launches > n0) == (kernel is None)
        res[kernel] = r
    a, b = res[None], res[False]
    assert a.result.reason == 2
    assert (a.result.iterations, a.result.inner_iterations) == (b.result.iterations,
                                                                b.result.inner_iterations)
    assert np.array_equal(a.x_global, b.x_global)
    Mx = 9
    ids = np.arange(len(a.x_global))
    face = (ids % 3 == 0) & ((ids // 3) % Mx == Mx - 1)
    assert (a.x_global[face] <= gap + 1e-4).all() and (a.x_global[face] > gap - 1e-6).any()


# -- the bf16 pairs of sell_mv ('bf16_mixed') -----------------------------------


def _bf16_sell(a, device):
    from permon_tpu_torch.core.precision import cast_floats

    return cast_floats(SEll.from_scipy(a, with_transpose=True, device=device), torch.bfloat16)


@pytest.mark.parametrize("xdt", [torch.float32, torch.float64, torch.bfloat16])
@pytest.mark.parametrize("which", ["skewed", "jbearing"])
def test_sell_mv_bf16_pairs_equal_plain_bitwise(cuda_device, which, xdt):
    """(bf16, f32) -> f32, (bf16, f64) -> f64 and (bf16, bf16) -> bf16:
    the kernel equals sell_mv_plain bit for bit (values widened exactly;
    with a bf16 x each product and add in f32, rounded to bf16 at once)."""
    a = _skewed() if which == "skewed" else rcm_permuted(*build_jbearing(40, 40))[0]
    op = _bf16_sell(a, cuda_device)
    plain = op.replace(kernel=False, t_plan=op.t_plan.replace(kernel=False))
    x = torch.as_tensor(np.random.RandomState(5).standard_normal(a.shape[1]),
                        device=cuda_device).to(xdt)
    n0 = sell_mv.launches
    got, got_t = op.mv(x), op.rmv(x)
    assert sell_mv.launches == n0 + 2
    ref, ref_t = plain.mv(x), plain.rmv(x)
    torch.cuda.synchronize()
    assert got.dtype == xdt and torch.equal(got, ref) and torch.equal(got_t, ref_t)
    if which == "skewed":
        assert bool((got[100:164] == 0).all())
    (fn,), out = kernel_launchers(op, x)
    fn()
    torch.cuda.synchronize()
    assert torch.equal(out, ref) and sell_mv.launches == n0 + 2
    with pytest.raises(RuntimeError, match="v1 kernel launch failed"):
        (old,), _ = kernel_launchers(op, x, version="v1")
        old()  # the replaced kernel has no bf16 pair


@pytest.mark.parametrize("vdt", [torch.float32, torch.float64])
def test_sell_mv_refuses_bf16_x_beside_wider_values(cuda_device, vdt):
    op = SEll.from_scipy(_skewed(500), device=cuda_device)
    op = op.replace(vals=op.vals.to(vdt))
    n0 = sell_mv.launches
    with pytest.raises(TypeError, match="bfloat16"):
        op.mv(torch.ones(500, dtype=torch.bfloat16, device=cuda_device))
    assert sell_mv.launches == n0


def test_gather_refuses_bf16(cuda_device):
    B = _gluing_ext(cuda_device, cells=(4, 4, 4), grid=(2, 1, 1))
    n0 = gather_apply.launches
    with pytest.raises(TypeError):
        B.gB.apply(torch.ones(B.ns * B.nl, dtype=torch.bfloat16, device=cuda_device))
    with pytest.raises(TypeError):
        B.gB.cast(torch.bfloat16).apply(torch.ones(B.ns * B.nl, device=cuda_device))
    assert gather_apply.launches == n0


def test_bf16_mixed_kernel_solve_equals_plain_solve(cuda_device):
    """qp.with_precision('bf16_mixed') on the card runs SEll with bf16
    values on the kernel; through kernel=False the counts are equal and x
    is bitwise equal."""
    import permon_tpu_torch as pt

    Ap, bp, lbp, ubp, _ = rcm_permuted(*build_jbearing(48, 48))
    qp = pt.QP.create(Ap, bp, lb=lbp, ub=ubp).with_precision("bf16_mixed")
    assert isinstance(qp.A.inner, SEll) and qp.A.inner.vals.dtype == torch.bfloat16
    tol = Tolerances(rtol=1e-5, atol=1e-8)
    sell_mv.launches = 0
    rk = pt.solve(qp, tol=tol)
    nk = sell_mv.launches
    plain = qp.replace(A=qp.A.replace(inner=qp.A.inner.replace(kernel=False)))
    rp = pt.solve(plain, tol=tol)
    assert rk.reason == 2 and nk > rk.nmv and sell_mv.launches == nk
    assert (rk.iterations, rk.nmv, rk.ncg, rk.nexp, rk.nprop) == (
        rp.iterations, rp.nmv, rp.ncg, rp.nexp, rp.nprop)
    assert rk.x.dtype == torch.float32 and torch.equal(rk.x, rp.x)


# -- the two accumulating writes of the band K+ (fixing-dof corrections) --------


def test_fixing_dof_corrections_on_card_are_deterministic(cuda_device):
    """RegularizedBlockDia._corr (scatter_add_) and the factor loop's
    injection (index_put_ with accumulate) on the north-star twin: applied
    twice on the card they agree bitwise, and they agree with the CPU."""
    from permon_tpu_torch.core.band import factor_from_dia_sm
    from permon_tpu_torch.feti.large import assemble_qp_sparse

    prob = build_sparse((20,) * 3, (4,) * 3)
    opts = FetiOptions(gluing="nonred")
    _, kp_g, NB, _ = assemble_qp_sparse(prob, opts, kplus_refine=1, device=cuda_device)
    _, kp_c, _, _ = assemble_qp_sparse(prob, opts, kplus_refine=1, device="cpu")
    reg_g, reg_c = kp_g.op, kp_c.op
    assert int((reg_c.q != 0).any(dim=(1, 2)).sum()) > 0  # floating blocks corrected
    x = np.random.RandomState(21).standard_normal(reg_c.shape[0])
    xg = torch.as_tensor(x, device=cuda_device)
    c1, c2 = reg_g._corr(xg), reg_g._corr(xg)
    assert torch.equal(c1, c2)
    ref = reg_c._corr(torch.as_tensor(x))
    assert float((c1.cpu() - ref).abs().max()) <= 1e-14 * float(ref.abs().max())

    def factors(reg):
        return factor_from_dia_sm(reg.base.data, reg.base.offsets, NB,
                                  upd_bi=reg.bi, upd_idx=reg.idx, upd_q=reg.q)

    (D1, F1), (D2, F2) = factors(reg_g), factors(reg_g)
    assert torch.equal(D1, D2) and torch.equal(F1, F2)
    Dc, Fc = factors(reg_c)
    for got, want in ((D1, Dc), (F1, Fc)):
        assert float((got.cpu() - want).abs().max()) <= 1e-10 * float(want.abs().max())


def test_regularized_diagonal_on_card_equals_cpu_bitwise(cuda_device):
    """RegularizedBlockDia.diagonal (the fixing-dof correction added by
    indexed adds over unique indices, no atomics) on the north-star twin:
    bitwise equal to the CPU result and across two calls on the card."""
    from permon_tpu_torch.feti.large import assemble_qp_sparse

    prob = build_sparse((20,) * 3, (4,) * 3)
    opts = FetiOptions(gluing="nonred")
    _, kp_g, _, _ = assemble_qp_sparse(prob, opts, kplus_refine=1, device=cuda_device)
    _, kp_c, _, _ = assemble_qp_sparse(prob, opts, kplus_refine=1, device="cpu")
    d1, d2 = kp_g.op.diagonal(), kp_g.op.diagonal()
    dc = kp_c.op.diagonal()
    assert torch.equal(d1, d2) and torch.equal(d1.cpu(), dc)
    assert not torch.equal(dc, kp_c.op.base.diagonal())  # the correction is in it


def test_cg_monitor_on_card_keeps_the_iterate(cuda_device, capsys):
    """cg(monitor=True) on the card: one line per convergence test and the
    iterate bitwise equal to that of monitor=False."""
    from permon_tpu_torch.core.linop import Dense
    from permon_tpu_torch.qp.qp import QP
    from permon_tpu_torch.solvers.cg import cg

    rng = np.random.RandomState(11)
    M = rng.standard_normal((30, 30))
    A = torch.as_tensor(M @ M.T + 30 * np.eye(30), device=cuda_device)
    qp = QP(A=Dense.create(A), b=torch.as_tensor(rng.standard_normal(30), device=cuda_device))
    loud = cg(qp, tol=Tolerances(rtol=1e-10), monitor=True)
    lines = [ln for ln in capsys.readouterr().out.splitlines() if " CG ||Pr||=" in ln]
    quiet = cg(qp, tol=Tolerances(rtol=1e-10))
    assert len(lines) == loud.iterations + 1 and capsys.readouterr().out == ""
    assert loud.iterations == quiet.iterations and torch.equal(loud.x, quiet.x)


def test_detect_nullspace_of_an_array_runs_on_the_card(cuda_device):
    """detect_nullspace_dense places an array on the card when no device
    is named, and finds the free-free Laplacian's constant mode as the CPU
    does (up to sign)."""
    from permon_tpu_torch.core.factor import detect_nullspace_dense

    n = 12
    L = 2 * np.eye(n) - np.eye(n, k=1) - np.eye(n, k=-1)
    L[0, 0] = L[-1, -1] = 1.0
    R, defect = detect_nullspace_dense(L)
    Rc, defect_c = detect_nullspace_dense(L, device="cpu")
    assert R.device.type == "cuda" and defect == defect_c == 1
    np.testing.assert_allclose(np.abs(R.cpu().numpy()), np.abs(Rc.numpy()), atol=1e-12)


# -- the dense TFETI path --------------------------------------------------------


def test_gluing_and_matis_copy_sum_on_kernel_equal_plain_bitwise(cuda_device):
    """The Gluing tables (B u, B'lambda with overflow) and the MatIS copy
    sum on the gather kernel: one launch each, bitwise equal to the plain
    version and to the CPU run (MatIS.mv also takes the blocks' product,
    cuBLAS against the CPU's BLAS: 1e-13 there)."""
    from permon_tpu_torch.core.gluing import Gluing
    from permon_tpu_torch.feti.matis import MatIS
    from permon_tpu_torch.problems import build_ex71

    prob = build_ex71((7, 7, 7), (2, 2, 2))
    r, c, v, m = build_gluing(prob.l2g, "full")
    n = prob.n_decomposed
    B = Gluing.from_coo(r, c, v, m, n, device=cuda_device)
    Bc = Gluing.from_coo(r, c, v, m, n, device="cpu")
    A = MatIS.create(prob.K_blocks, prob.l2g, device=cuda_device)
    Ac = MatIS.create(prob.K_blocks, prob.l2g, device="cpu")
    assert B.gBt.ov_tgt is not None and A.copies.ov_tgt is not None
    rng = np.random.RandomState(0)
    u, lam, xg = rng.standard_normal(n), rng.standard_normal(m), rng.standard_normal(
        prob.n_global)
    yl = rng.standard_normal(prob.n_decomposed)
    for op, cpu_op, fn, x in ((B, Bc, "mv", u), (B, Bc, "rmv", lam),
                              (A, Ac, "_assemble", yl), (A, Ac, "mv", xg)):
        xt = torch.as_tensor(x, device=cuda_device)
        n0 = gather_apply.launches
        got = getattr(op, fn)(xt)
        assert gather_apply.launches == n0 + 1
        plain = getattr(op.with_kernel(False), fn)(xt)
        torch.cuda.synchronize()
        assert gather_apply.launches == n0 + 1
        assert torch.equal(got, plain)
        want = getattr(cpu_op, fn)(torch.as_tensor(x)).numpy()
        if fn == "mv" and op is A:
            np.testing.assert_allclose(got.cpu().numpy(), want, rtol=0,
                                       atol=1e-13 * np.abs(want).max())
        else:
            np.testing.assert_array_equal(got.cpu().numpy(), want)


def test_floating_mask_on_card_equals_cpu(cuda_device):
    from permon_tpu_torch.problems import build_ex71

    for kw in (dict(cells=(8, 8, 8), grid=(2, 2, 2)), dict(dirichlet_diag="owner"),
               dict(cells=(6, 4, 4), grid=(2, 2, 1), pde="elasticity")):
        prob = build_ex71(**kw)
        np.testing.assert_array_equal(prob.floating_mask(device=cuda_device),
                                      prob.floating_mask(device="cpu"))


@pytest.mark.parametrize("gluing,its", [("nonred", 16), ("full", 9), ("orth", 9)])
def test_ex71_reference_counts_on_card(cuda_device, gluing, its):
    """ex71's oracles on the card, every B / B' on the gather kernel; the
    plain version gives the same count and a bitwise equal x_global."""
    from permon_tpu_torch.feti.solve import feti_solve
    from permon_tpu_torch.problems import build_ex71

    prob = build_ex71()
    runs = []
    for gk in (None, False):
        gather_apply.launches = 0
        res = feti_solve(prob, FetiOptions(gluing=gluing, gather_kernel=gk), device=cuda_device)
        runs.append((res, gather_apply.launches))
    (rk, nk), (rp, np_) = runs
    assert rk.result.reason == 2 and rk.result.iterations == its
    assert nk > 0 and np_ == 0
    assert rp.result.iterations == its
    np.testing.assert_array_equal(rk.x_global, rp.x_global)


def test_ex1_and_contact_on_card(cuda_device):
    from permon_tpu_torch.feti.solve import feti_solve
    from permon_tpu_torch.problems import build_feti_contact, build_feti_ex1

    for by_B in (True, False):
        res = feti_solve(build_feti_ex1(4, 7), FetiOptions(dirichlet_by_B=by_B),
                         device=cuda_device)
        assert res.result.reason == 2 and res.result.iterations == 1
    prob, BI, cI, lb = build_feti_contact(4, 25)
    res = feti_solve(prob, FetiOptions(gluing="nonred"), tol=Tolerances(rtol=1e-8),
                     BI=BI, cI=cI, device=cuda_device)
    ref = feti_solve(prob, FetiOptions(gluing="nonred"), tol=Tolerances(rtol=1e-8),
                     BI=BI, cI=cI, device="cpu")
    assert res.result.reason == 2
    assert (res.result.iterations, res.result.inner_iterations) == (
        ref.result.iterations, ref.result.inner_iterations)
    np.testing.assert_allclose(res.x_global, ref.x_global, rtol=0, atol=1e-9)


# -- the leaf path (throughput=True) and the checkpoint -------------------------


def _leaf_space(device):
    from permon_tpu_torch.feti.leaf import LeafDualSpace
    from permon_tpu_torch.problems import build_ex71

    prob = build_ex71((6, 6, 6), (2, 2, 2))
    r, c, v, m = build_gluing(prob.l2g, "full", True)
    B = SubdomainExtension.from_coo(r, c, v, m=m, ns=prob.ns, nl=prob.nl)
    return B, LeafDualSpace.build(B.with_gather_apply(device))


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
def test_leaf_tables_on_kernel_equal_plain_bitwise(cuda_device, dt):
    """The combine, restrict and lift tables through the kernel, one launch
    each, bitwise equal to the plain version (in f32 through the casts of
    table_as, as the 'mixed' leaf state runs them)."""
    _, sp = _leaf_space(cuda_device)
    assert sp.comb.idx.shape[0] >= 2  # the identity plane and the partners
    rng = np.random.RandomState(8)
    X = torch.as_tensor(rng.standard_normal(sp.rows.shape), dtype=dt, device=cuda_device)
    lam = torch.as_tensor(rng.standard_normal(sp.m_dual), dtype=dt, device=cuda_device)
    plain = sp.with_kernel(False)
    for f, arg in (("combine", X), ("restrict", X), ("lift", lam)):
        n0 = gather_apply.launches
        got = getattr(sp, f)(arg)
        assert gather_apply.launches == n0 + 1, f
        ref = getattr(plain, f)(arg)
        assert gather_apply.launches == n0 + 1, f
        torch.cuda.synchronize()
        assert got.dtype == dt and torch.equal(got, ref), f


def test_leaf_apply_on_card_equals_cpu(cuda_device):
    """One leaf F apply on the card against the CPU on the same blocks,
    inverses and partner map, to 1e-13 relative (the batched products sum
    in another order); under TF32 the card refuses it."""
    from permon_tpu_torch.feti.leaf import LeafDualOperator, LeafDualSpace
    from permon_tpu_torch.feti.solve import assemble_qp, make_blockdiag_kplus
    from permon_tpu_torch.problems import build_ex71

    prob = build_ex71((6, 6, 6), (2, 2, 2))
    qp, K, fixed, nb = assemble_qp(prob, FetiOptions(throughput=True), device="cpu")
    cpu = LeafDualOperator.create(qp.BE, make_blockdiag_kplus(K, fixed, prob, nb, explicit=True))
    sp = cpu.space
    card = LeafDualOperator(
        blk=cpu.blk.to(cuda_device), invs=cpu.invs.to(cuda_device),
        space=LeafDualSpace.from_partners(sp.rows, sp.partners, sp.weights.numpy(), sp.m_dual,
                                          cuda_device))
    Lam = sp.lift(torch.as_tensor(np.random.RandomState(9).standard_normal(sp.m_dual)))
    ref = cpu.apply(Lam)
    n0 = gather_apply.launches
    got = card.apply(Lam.to(cuda_device)).cpu()
    assert gather_apply.launches == n0 + 1  # the partner combine
    scale = float(ref.abs().max())
    assert float((got - ref).abs().max()) <= 1e-13 * scale
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="full-precision"):
            card.apply(Lam.to(cuda_device))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def test_leaf_solve_on_card(cuda_device):
    """feti_solve(throughput=True) on the card: the count of the row path
    and of the CPU within one (the explicit-inverse GEMV and the card's sums
    round otherwise), the CPU's x_global to 1e-8 of max |x| at rtol 1e-10,
    and the same solve through the plain gather version with an equal count
    and a bitwise equal x_global."""
    from permon_tpu_torch.feti.solve import feti_solve
    from permon_tpu_torch.problems import build_ex71

    prob = build_ex71((6, 6, 6), (2, 2, 2))
    tol = Tolerances(rtol=1e-10)
    row = feti_solve(prob, FetiOptions(gluing="nonred"), tol=tol, device=cuda_device)
    n0 = gather_apply.launches
    leaf = feti_solve(prob, FetiOptions(gluing="nonred", throughput=True), tol=tol,
                      device=cuda_device)
    assert gather_apply.launches > n0
    cpu = feti_solve(prob, FetiOptions(gluing="nonred", throughput=True), tol=tol, device="cpu")
    plain = feti_solve(prob, FetiOptions(gluing="nonred", throughput=True, gather_kernel=False),
                       tol=tol, device=cuda_device)
    assert leaf.result.reason == 2
    assert abs(leaf.result.iterations - row.result.iterations) <= 1
    assert abs(leaf.result.iterations - cpu.result.iterations) <= 1
    np.testing.assert_allclose(leaf.x_global, cpu.x_global, rtol=0,
                               atol=1e-8 * np.abs(cpu.x_global).max())
    assert plain.result.iterations == leaf.result.iterations
    np.testing.assert_array_equal(plain.x_global, leaf.x_global)


def test_checkpoint_round_trip_on_card(cuda_device, tmp_path):
    """FetiSolver.save / load on the card: the gather tables come back with
    padded planes and run on the kernel; a re-solve is bitwise equal."""
    from permon_tpu_torch.feti.solve import FetiSolver
    from permon_tpu_torch.problems import build_ex71
    from permon_tpu_torch.utils import checkpoint

    prob = build_ex71((6, 6, 6), (2, 2, 2))
    opts = FetiOptions(gluing="nonred")
    solver = FetiSolver(prob, opts, device=cuda_device)
    solver.solve()
    p = str(tmp_path / "solver.npz")
    solver.save(p)
    loaded = FetiSolver.load(p, prob, opts, device=cuda_device)
    assert loaded.qp.BE.gBt.idx.stride(0) == solver.qp.BE.gBt.idx.stride(0)
    b_new = 0.5 * prob.b_loc + 0.1
    live = solver.solve(b_loc=b_new)
    n0 = gather_apply.launches
    again = loaded.solve(b_loc=b_new)
    assert gather_apply.launches > n0
    assert again.result.iterations == live.result.iterations
    np.testing.assert_array_equal(again.x_global, live.x_global)
    state = checkpoint.load(p, device=cuda_device)
    assert state["kplus"].chols.device.type == "cuda"


def test_examples_on_card(cuda_device):
    """The command-line examples with no device given: on the card, the FETI
    examples through the gather kernel; counts and solutions as the same
    examples give them on the CPU."""
    import contextlib
    import io

    from permon_tpu_torch.examples import ex1, feti_contact, feti_ex1

    with contextlib.redirect_stdout(io.StringIO()):
        _, res = ex1.main()
        assert res.x.is_cuda
        assert (res.iterations, res.nmv, res.ncg, res.nexp, res.nprop) == (181, 200, 156, 18, 7)
        n0 = gather_apply.launches
        _, r = feti_ex1.main()
        assert r.result.iterations == 1 and gather_apply.launches > n0
        n0 = gather_apply.launches
        x, res, _ = feti_contact.main()
        assert gather_apply.launches > n0
        x_cpu, res_cpu, _ = feti_contact.main(device="cpu")
    assert (res.iterations, res.inner_iterations, res.nmv) == (
        res_cpu.iterations, res_cpu.inner_iterations, res_cpu.nmv)
    np.testing.assert_allclose(x, x_cpu, rtol=0, atol=1e-9)


# -- K+ as one CUDA graph replay a pass ------------------------------------------


def _kplus_pair(device, which):
    """(K+, refined K+) of a FetiSolverSparse on f32 factors with 2 refinement
    steps: a Poisson box of 12^3 cells on 2x2x2 subdomains (NB 128), or an
    elasticity box of 16 x 16 x 8 cells on 2x2x1 (NB 384)."""
    from permon_tpu_torch.problems import build_sparse_elasticity

    if which == "poisson":
        prob, opts = build_sparse((12,) * 3, (2,) * 3), FetiOptions(gluing="nonred",
                                                                     deterministic=True)
    else:
        prob = build_sparse_elasticity((16, 16, 8), (2, 2, 1))
        opts = FetiOptions(gluing="nonred", nullspace="rbm", deterministic=True)
    s = FetiSolverSparse(prob, opts, kplus_dtype=torch.float32, kplus_refine=2, device=device)
    assert s.NB == (128 if which == "poisson" else 384)
    return s.kplus, s.kplus_post


def _eager_mv(kp, x):
    """``kp.mv(x)`` with every pass launched op by op."""
    y = kp._eager(x).to(x.dtype)
    for _ in range(kp.refine if kp.op is not None else 0):
        y = y + kp._eager(x - kp.op.mv(y)).to(x.dtype)
    return y


def _inputs(kp, device, k, seed=17):
    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(kp.shape[0], generator=g, dtype=torch.float64, device=device)
            for _ in range(k)]


@pytest.mark.parametrize("which", ["poisson", "elasticity"])
def test_kplus_replay_equals_eager_bitwise(cuda_device, which):
    """Five inputs in a row through one captured graph: each result bitwise
    the eager pass's, one capture, a replay a pass."""
    from permon_tpu_torch.sys import tracing

    kp, _ = _kplus_pair(cuda_device, which)
    xs = _inputs(kp, cuda_device, 5)
    tracing.reset()
    ys = [kp.mv(x) for x in xs]
    assert tracing.events["kplus.solve"][0] == tracing.events["kplus.replay"][0] == 5
    assert len(kp.__dict__["_graphs"]) == 1
    for x, y in zip(xs, ys):
        assert y.dtype == torch.float64 and torch.equal(y, _eager_mv(kp, x))


def test_kplus_replay_results_never_alias(cuda_device):
    """Two results held at once are two tensors, each the eager pass's, and
    neither is the graph's static output."""
    kp, _ = _kplus_pair(cuda_device, "poisson")
    x1, x2 = _inputs(kp, cuda_device, 2, seed=3)
    y1 = kp.mv(x1)
    y2 = kp.mv(x2)
    (rep,) = kp.__dict__["_graphs"].values()
    assert len({y1.data_ptr(), y2.data_ptr(), rep.y.data_ptr()}) == 3
    assert torch.equal(y1, _eager_mv(kp, x1)) and torch.equal(y2, _eager_mv(kp, x2))


@pytest.mark.parametrize("which", ["poisson", "elasticity"])
def test_refined_kplus_replay_equals_eager_bitwise(cuda_device, which):
    """The refined apply (2 steps: three passes, each a replay of the one
    graph, around the refinement operator's applies) is bitwise eager."""
    from permon_tpu_torch.sys import tracing

    _, kpost = _kplus_pair(cuda_device, which)
    assert kpost.refine == 2 and kpost.op is not None
    for x in _inputs(kpost, cuda_device, 2, seed=5):
        tracing.reset()
        y = kpost.mv(x)
        assert tracing.events["kplus.replay"][0] == 3
        assert torch.equal(y, _eager_mv(kpost, x))


def test_kplus_graph_follows_the_factors(cuda_device):
    """An operator with other factors of the same shape never replays the
    first one's graph: not a replaced copy, not the same object given other
    tensors, not a shallow copy that shares the cache."""
    import copy

    kp, _ = _kplus_pair(cuda_device, "poisson")
    (x,) = _inputs(kp, cuda_device, 1, seed=9)
    y = kp.mv(x)
    other = kp.replace(Dinv=0.5 * kp.Dinv, F=kp.F.flip(1).contiguous())
    y_other = other._eager(x).to(x.dtype)
    assert not torch.equal(y_other, y)
    assert torch.equal(other.mv(x), y_other)
    twin = copy.copy(kp)
    kp.Dinv, kp.F = other.Dinv, other.F
    assert torch.equal(kp.mv(x), y_other)
    assert torch.equal(twin.mv(x), y) and torch.equal(kp.mv(x), y_other)


def test_solve_with_replays_equals_solve_with_eager_passes(cuda_device, monkeypatch):
    """A FetiSolverSparse solve (f32 factors, 2 refinement steps, one defect
    pass) gives the same iterations and a bitwise equal x_global whether K+
    replays its graph or runs each pass op by op (patched in)."""
    from permon_tpu_torch.core.band import BandCholInv
    from permon_tpu_torch.sys import tracing

    prob = build_sparse((12,) * 3, (2,) * 3)

    def run():
        s = FetiSolverSparse(prob, FetiOptions(gluing="nonred", deterministic=True),
                             kplus_dtype=torch.float32, kplus_refine=2, primal_refine=1,
                             device=cuda_device)
        tracing.reset()
        r = s.solve(b_loc=1.5 * prob.b_loc, tol=Tolerances(rtol=1e-6))
        return r, tracing.events.get("kplus.replay", [0])[0], tracing.events["kplus.solve"][0]

    r_graph, n_graph, passes = run()
    monkeypatch.setattr(BandCholInv, "_replay", lambda self, x: self._eager(x).to(x.dtype))
    r_eager, n_eager, passes_eager = run()
    assert n_graph == passes == passes_eager and n_eager == 0
    assert ([c.iterations for c in r_graph.results]
            == [c.iterations for c in r_eager.results])
    assert all(c.reason == 2 for c in r_graph.results)
    np.testing.assert_array_equal(r_graph.x_global, r_eager.x_global)


def test_profiler_attributes_replayed_kernels_to_kplus_solve(cuda_device, monkeypatch):
    """The benchmark's reader of device time per ``kplus.solve`` range
    (h100bench/program_spans.py) finds the replayed kernels, for a graph
    captured before the profiler started: above 0 and within 10% of the
    eager passes' (north-star blocks, NB 768, 16 subdomains)."""
    from torch.profiler import ProfilerActivity, profile

    from h100bench.program_spans import range_device_seconds
    from permon_tpu_torch.core.band import BandCholInv

    nb, ns, NB = 8, 16, 768
    g = torch.Generator(device=cuda_device).manual_seed(2)
    Dinv = torch.randn(nb, ns, NB, NB, generator=g, device=cuda_device) * (0.5 / NB ** 0.5)
    F = torch.randn(nb, ns, NB, NB, generator=g, device=cuda_device) * (0.5 / NB ** 0.5)
    F[0] = 0.0
    kp = BandCholInv(Dinv=Dinv, F=F, shape=(nb * ns * NB,) * 2)
    (x,) = _inputs(kp, cuda_device, 1, seed=4)
    kp.mv(x)

    def device_seconds(passes=3):
        kp.mv(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(passes):
                kp.mv(x)
            torch.cuda.synchronize()
        n, sec = range_device_seconds(prof, "kplus.solve")
        assert n == passes
        return sec / passes

    replay = device_seconds()
    monkeypatch.setattr(BandCholInv, "_replay", lambda self, x: self._eager(x).to(x.dtype))
    eager = device_seconds()
    assert replay > 0 and eager > 0
    assert abs(replay - eager) <= 0.1 * eager, (replay, eager)


# -- the fixed-tree reduction (csrc/det_sum.cu) ----------------------------------

TREE_LENGTHS = [1, 2, 3, 5, 64, 1000, 13440, 94563, 245850]


def _wide(rng, shape, dtype, device):
    """Values over many binades, so that another pairing rounds otherwise."""
    v = rng.standard_normal(shape) * 10.0 ** rng.uniform(-6, 6, shape)
    return torch.as_tensor(v, dtype=dtype, device=device)


def _launches_of(x, axis=-1, y=None):
    from permon_tpu_torch.core.detred import tree_layout

    return len(tree_layout(x, axis, y).passes)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", TREE_LENGTHS)
def test_det_sum_kernel_equals_plain_tree_bitwise(cuda_device, n, dtype):
    """Along the last axis (2 rows) and along axis 0 (3 columns), alone and
    times a broadcast second factor: torch.equal to the plain tree on the
    card and on the CPU, one launch a tree (two for a few long rows)."""
    from permon_tpu_torch.core.detred import det_sum, det_sum_plain

    rng = np.random.RandomState(n)
    x, xt = _wide(rng, (2, n), dtype, cuda_device), _wide(rng, (n, 3), dtype, cuda_device)
    w = _wide(rng, n, dtype, cuda_device)
    for args in ((x, -1, None), (x, -1, w[None, :]), (xt, 0, None), (xt, 0, w[:, None])):
        n0 = det_sum.launches
        got = det_sum(*args)
        assert det_sum.launches == n0 + _launches_of(*args) <= n0 + 2
        ref = det_sum_plain(*args)
        cpu = det_sum_plain(*(a.cpu() if isinstance(a, torch.Tensor) else a for a in args))
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == ref.shape
        assert torch.equal(got, ref) and torch.equal(got.cpu(), cpu)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("npairs", [1, 2, 3])
def test_det_dots_kernel_rows_are_each_pairs_det_dot(cuda_device, npairs, dtype):
    from permon_tpu_torch.core.detred import det_dot, det_dots, det_sum, det_sum_plain

    rng = np.random.RandomState(10 + npairs)
    vecs = [_wide(rng, 245850, dtype, cuda_device) for _ in range(npairs + 1)]
    pairs = [(vecs[k], vecs[k + 1]) for k in range(npairs)]
    n0 = det_sum.launches
    got = det_dots(pairs)
    assert det_sum.launches == n0 + 2  # one partial pass and one final pass for all pairs
    for (x, y), g in zip(pairs, got):
        assert torch.equal(g, det_dot(x, y)) and torch.equal(g, det_sum_plain(x * y))


def test_det_dots_kernel_takes_strided_pairs_and_refuses_mixed_lengths(cuda_device):
    """Strided or 2-D vectors are read as contiguous copies, in one launch set
    with the contiguous pairs; pairs of two lengths or dtypes raise."""
    from permon_tpu_torch.core.detred import det_dot, det_dots, det_sum

    rng = np.random.RandomState(31)
    a = _wide(rng, (3, 94563), torch.float64, cuda_device)
    b = _wide(rng, (94563, 2), torch.float64, cuda_device)
    pairs = [(a[0], a[1]), (b[:, 0], a[2]), (a[1].reshape(3, 31521), b[:, 1])]
    n0 = det_sum.launches
    got = det_dots(pairs)
    assert det_sum.launches == n0 + 2
    for (x, y), g in zip(pairs, got):
        assert torch.equal(g, det_dot(x.contiguous(), y.contiguous()))
    with pytest.raises(ValueError):
        det_dots([(a[0], a[1]), (a[0, :100], a[1, :100])])
    with pytest.raises(ValueError):
        det_dots([(a[0], a[1]), (a[0].float(), a[1].float())])


@pytest.mark.parametrize("bad", ["int32", "float16", "bfloat16", "complex64", "mixed"])
def test_det_sum_kernel_raises_on_other_dtypes(cuda_device, bad):
    from permon_tpu_torch.core.detred import det_dot, det_sum

    x = torch.ones(4, 100, device=cuda_device)
    if bad == "mixed":
        with pytest.raises(TypeError):
            det_sum(x, -1, x.double())
        return
    dt = getattr(torch, bad)
    with pytest.raises(TypeError):
        det_sum(x.to(dt))
    with pytest.raises(TypeError):
        det_dot(x.to(dt)[0], x.to(dt)[1])


def _plain_trees(monkeypatch):
    """Every det_sum call site on the plain tree (the kernel's arithmetic,
    op by op)."""
    from permon_tpu_torch.core import detred
    from permon_tpu_torch.feti import large

    def plain(x, axis=-1, y=None):
        return detred.det_sum_plain(x, axis, y)

    def plain_dots(pairs):
        return tuple(detred.det_sum_plain(torch.stack([(x * y).reshape(-1) for x, y in pairs])))

    monkeypatch.setattr(detred, "det_sum", plain)
    monkeypatch.setattr(detred, "det_dots", plain_dots)
    monkeypatch.setattr(large, "det_sum", plain)


def test_block_coarse_dense_tree_and_coarse_inverse_on_kernel_equal_plain(cuda_device,
                                                                         monkeypatch):
    """BlockCoarse.mv, DenseTree.mv / .rmv and apply_cp's explicit-inverse
    tree on the card, bitwise their results on the plain tree; one launch a
    tree, two for long rows (DenseTree.mv's 48 rows of 94,563)."""
    from permon_tpu_torch.core.detred import det_sum
    from permon_tpu_torch.core.linop import DenseTree, VStack
    from permon_tpu_torch.feti.large import assemble_qp_sparse, block_coarse_from_R
    from permon_tpu_torch.problems import build_obstacle_elasticity
    from permon_tpu_torch.qp.projector import EXPLICIT_INV_MIN_K, Projector

    prob, BI, cI, _ = build_obstacle_elasticity((6, 6, 6), (2, 2, 1))
    opts = FetiOptions(gluing="nonred", nullspace="rbm", dirichlet_by_B=False)
    qp_g, *_ = assemble_qp_sparse(prob, opts, BI=BI, cI=cI, device=cuda_device)
    G = block_coarse_from_R(qp_g.R, VStack((qp_g.BE, qp_g.BI)))
    rng = np.random.RandomState(21)
    k = max(540, EXPLICIT_INV_MIN_K)
    tree = DenseTree.create(_wide(rng, (48, 94563), torch.float64, cuda_device))
    inv = _wide(rng, (k, k), torch.float64, cuda_device)
    pf = Projector(G=tree, ggt_chol=None, ggt_inv=inv)
    w = torch.zeros(G.Rb.shape[:2], dtype=torch.float64, device=cuda_device)
    calls = [
        (lambda v: G.mv(v), _wide(rng, G.shape[1], torch.float64, cuda_device),
         _launches_of(G.Rb, 1, w[:, :, None])),
        (tree.mv, _wide(rng, 94563, torch.float64, cuda_device), 2),
        (tree.rmv, _wide(rng, 48, torch.float64, cuda_device), 1),
        (pf.apply_cp, _wide(rng, k, torch.float64, cuda_device), 1),
    ]
    got = []
    for fn, v, launches in calls:
        n0 = det_sum.launches
        got.append(fn(v))
        assert det_sum.launches == n0 + launches
    _plain_trees(monkeypatch)
    for (fn, v, _), g in zip(calls, got):
        assert torch.equal(g, fn(v))


@pytest.mark.parametrize("which", ["poisson", "elastic"])
def test_deterministic_solve_on_kernel_trees_equals_plain_trees(cuda_device, monkeypatch,
                                                                which):
    """A deterministic FetiSolverSparse solve (f32 factors, 2 refinement
    steps, one defect pass) takes the same iterations and a bitwise equal
    x_global with every tree on the kernel or on the plain tree; on the
    kernel every ``detred.sum`` span holds one ``detred.kernel``.  Poisson
    (G a DenseTree) and elasticity (G a BlockCoarse: the dense-G cutoff
    lowered, as the 1.18M-dof box passes it)."""
    from permon_tpu_torch.feti.large import BlockCoarse
    from permon_tpu_torch.problems import build_sparse_elasticity
    from permon_tpu_torch.qp import transforms
    from permon_tpu_torch.sys import tracing

    if which == "poisson":
        prob, extra = build_sparse((12,) * 3, (2,) * 3), {}
    else:
        monkeypatch.setattr(transforms, "DENSE_G_ELEMENTS", 16)
        prob = build_sparse_elasticity((8, 8, 8), (2, 2, 2))
        extra = dict(nullspace="rbm", coarse="sparse", dirichlet_by_B=False)

    def run():
        s = FetiSolverSparse(prob, FetiOptions(gluing="nonred", deterministic=True, **extra),
                             kplus_dtype=torch.float32, kplus_refine=2, primal_refine=1,
                             device=cuda_device)
        tracing.reset()
        r = s.solve(b_loc=1.5 * prob.b_loc, tol=Tolerances(rtol=1e-6))
        assert which == "poisson" or isinstance(s._pf.G, BlockCoarse)
        return r, dict(tracing.events)

    r_kernel, ev = run()
    assert ev["detred.sum"][0] > 0 and ev["detred.kernel"][0] == ev["detred.sum"][0]
    _plain_trees(monkeypatch)
    r_plain, ev_plain = run()
    assert "detred.kernel" not in ev_plain
    assert ([c.iterations for c in r_kernel.results]
            == [c.iterations for c in r_plain.results])
    assert all(c.reason == 2 for c in r_kernel.results)
    np.testing.assert_array_equal(r_kernel.x_global, r_plain.x_global)
