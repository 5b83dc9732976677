"""permon_tpu_torch band module (core/band.py) and coarse projector
(qp/projector.py) against the JAX package on the same seeded inputs, on the
CPU.  Tolerances, per check:

- host setup functions (rcm_order, csr_to_block_tridiag, regularize_block_tridiag,
  regularize_csr, gershgorin_max_eig): np.array_equal;
- BlockTridiag.mv / diagonal against scipy: 1e-13 relative (f64);
  expand_block_tridiag_dia against csr_to_block_tridiag: bitwise;
- factor_block_tridiag_sm against factor_from_dia_sm on the same matrix:
  bitwise in f64 (one factor loop serves both); against the JAX factors:
  f64 rtol 1e-12, f32 rtol 1e-4 (LAPACK Cholesky and triangular inverse of
  two libraries; the port's f32 factors come from an f64 recurrence);
- half solves and applies on the SAME factor arrays: 1e-13 relative;
  make_band_kplus: K K+ K = K to 1e-10 and equal to the JAX apply to 1e-10;
- band projector against the dense one and against the JAX package's
  apply_cp / apply_p: 1e-10.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse as sp
import torch

import permon_tpu.core.band as jband
import permon_tpu.core.extension as jext
import permon_tpu.qp.projector as jproj
from permon_tpu.feti.assembly import build_gluing as jax_build_gluing

import permon_tpu_torch.core.band as tband
import permon_tpu_torch.qp.projector as tproj
from permon_tpu_torch.core.dia import BlockDia
from permon_tpu_torch.core.extension import SubdomainExtension
from permon_tpu_torch.core.linop import Dense
from permon_tpu_torch.interop import from_arrays
from permon_tpu_torch.problems import _kron3

torch.set_num_threads(2)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _close(got, ref, rtol):
    ref = np.asarray(ref, dtype=np.float64)
    got = got.double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * max(np.abs(ref).max(), 1e-300))


def _spd(n, seed, density=0.02):
    """A seeded sparse SPD matrix with an unstructured pattern."""
    rng = np.random.RandomState(seed)
    a = sp.random(n, n, density, random_state=rng, data_rvs=rng.standard_normal)
    a = a + a.T
    return (a + sp.diags(np.asarray(abs(a).sum(axis=1)).ravel() + 1.0)).tocsr()


#: (K, NB): a 3-D Q1 Poisson box plus a mass-like shift that makes it
#: definite (nl = 150, bandwidth 31) and an RCM-ordered unstructured SPD
#: matrix whose size (333) is not a multiple of NB
def _case(name):
    if name == "box":
        return (_kron3(5, 5, 6) + 0.05 * sp.identity(150)).tocsr(), 128
    a = _spd(333, 1)
    p = tband.rcm_order(a)
    a = a[p][:, p].tocsr()
    return a, tband._default_nb(tband.bandwidth(a))


CASES = ["box", "unstructured"]


def _nullspace(K, k, seed):
    """A seeded (nl, k) block standing for a nullspace basis, its last rows
    zero (a padded subdomain)."""
    R = np.random.RandomState(seed).standard_normal((K.shape[0], k))
    R[-7:] = 0.0
    return R


# -- host setup ----------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_rcm_order_equal(seed):
    a = _spd(200 + 31 * seed, seed)
    np.testing.assert_array_equal(tband.rcm_order(a), jband.rcm_order(a))


@pytest.mark.parametrize("name", CASES)
def test_csr_to_block_tridiag_equal(name):
    K, NB = _case(name)
    for got, ref in zip(tband.csr_to_block_tridiag(K, NB), jband.csr_to_block_tridiag(K, NB)):
        np.testing.assert_array_equal(got, ref)
    with pytest.raises(ValueError, match="bandwidth"):
        tband.csr_to_block_tridiag(K, 8)


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("k", [1, 6])
def test_regularize_and_gershgorin_equal(name, k):
    K, NB = _case(name)
    R = _nullspace(K, k, 3)
    Ad, Asub = jband.csr_to_block_tridiag(K, NB)
    rho = tband.gershgorin_max_eig(Ad.copy(), Asub.copy())
    assert rho == jband.gershgorin_max_eig(Ad.copy(), Asub.copy())
    assert abs(rho - tband.gershgorin_max_eig_csr(K)) <= 1e-14 * rho  # another summation order
    for got, ref in zip(tband.regularize_block_tridiag(Ad, Asub, R, rho, NB),
                        jband.regularize_block_tridiag(Ad, Asub, R, rho, NB)):
        np.testing.assert_array_equal(got, ref)
    got, ref = tband.regularize_csr(K, R, rho, NB), jband.regularize_csr(K, R, rho, NB)
    assert (got != ref).nnz == 0
    # no columns: the inputs come back untouched
    assert tband.regularize_block_tridiag(Ad, Asub, R[:, :0], rho, NB)[0] is Ad
    assert (tband.regularize_csr(K, R[:, :0], rho, NB) != K).nnz == 0


# -- BlockTridiag, expansion ---------------------------------------------------


def _batch(name, ns=3):
    """ns scaled copies of a case's matrix as batch-major blocks."""
    K, NB = _case(name)
    mats = [(1.0 + 0.25 * s) * K for s in range(ns)]
    blocks = [tband.csr_to_block_tridiag(M, NB) for M in mats]
    return mats, np.stack([b[0] for b in blocks]), np.stack([b[1] for b in blocks]), NB


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("dtype,rtol", [("float64", 1e-13), ("float32", 1e-5)])
def test_blocktridiag_mv_diagonal_vs_scipy(name, dtype, rtol):
    mats, Ad, Asub, NB = _batch(name)
    nl, nlp = mats[0].shape[0], Ad.shape[1] * NB
    op = tband.BlockTridiag.from_blocks(_t(Ad).to(getattr(torch, dtype)),
                                        _t(Asub).to(getattr(torch, dtype)))
    assert op.shape == (3 * nlp, 3 * nlp)
    x = np.random.RandomState(4).standard_normal((3, nlp))
    ref = x.copy()  # unit diagonal on the padding rows
    for s, M in enumerate(mats):
        ref[s, :nl] = M @ x[s, :nl]
    y = op.mv(_t(x.reshape(-1)))
    assert y.dtype == torch.float64  # computed in the storage dtype, cast back
    _close(y, ref.reshape(-1), rtol)
    assert torch.equal(op.rmv(_t(x.reshape(-1))), y)
    dref = np.ones((3, nlp))
    for s, M in enumerate(mats):
        dref[s, :nl] = M.diagonal()
    _close(op.diagonal(), dref.reshape(-1), rtol)
    _close(y, jband.BlockTridiag.from_blocks(Ad, Asub).mv(jnp.asarray(x.reshape(-1))), rtol)


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_expand_block_tridiag_dia_bitwise(name, dtype):
    mats, Ad, Asub, NB = _batch(name)
    dia = BlockDia.from_scipy_blocks(mats, nlp=Ad.shape[1] * NB, device="cpu")
    Ad_sm, Asub_sm = tband.expand_block_tridiag_dia(dia.data, dia.offsets, NB,
                                                    dtype=getattr(torch, dtype))
    assert Ad_sm.shape == (Ad.shape[1], 3, NB, NB)
    np.testing.assert_array_equal(Ad_sm.numpy(), np.moveaxis(Ad, 0, 1).astype(dtype))
    np.testing.assert_array_equal(Asub_sm.numpy(), np.moveaxis(Asub, 0, 1).astype(dtype))
    jAd, jAsub = jband.expand_block_tridiag_dia(jnp.asarray(dia.data.numpy()), dia.offsets, NB,
                                                dtype=getattr(jnp, dtype))
    np.testing.assert_array_equal(Ad_sm.numpy(), np.asarray(jAd))
    np.testing.assert_array_equal(Asub_sm.numpy(), np.asarray(jAsub))


# -- factorization -------------------------------------------------------------


@pytest.mark.parametrize("name", CASES)
def test_factor_block_tridiag_sm_equals_factor_from_dia_sm_bitwise(name):
    mats, Ad, Asub, NB = _batch(name)
    dia = BlockDia.from_scipy_blocks(mats, nlp=Ad.shape[1] * NB, device="cpu")
    D1, F1 = tband.factor_from_dia_sm(dia.data, dia.offsets, NB)
    D2, F2 = tband.factor_block_tridiag_sm(_t(np.moveaxis(Ad, 0, 1)), _t(np.moveaxis(Asub, 0, 1)))
    assert torch.equal(D1, D2) and torch.equal(F1, F2)
    # batch-major wrapper: the same factors, transposed
    D3, F3 = tband.factor_block_tridiag(Ad, Asub, device="cpu")
    assert torch.equal(D3.transpose(0, 1), D2) and torch.equal(F3.transpose(0, 1), F2)


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("dtype,rtol", [("float64", 1e-12), ("float32", 1e-4)])
def test_factor_block_tridiag_sm_matches_jax(name, dtype, rtol):
    _, Ad, Asub, NB = _batch(name)
    Ad_sm, Asub_sm = np.moveaxis(Ad, 0, 1), np.moveaxis(Asub, 0, 1)
    Dj, Fj = jband.factor_block_tridiag_sm(jnp.asarray(Ad_sm, dtype=dtype),
                                           jnp.asarray(Asub_sm, dtype=dtype))
    Dt, Ft = tband.factor_block_tridiag_sm(_t(Ad_sm), _t(Asub_sm), dtype=getattr(torch, dtype))
    assert Dt.dtype == getattr(torch, dtype) and Dt.shape == Dj.shape
    _close(Dt, Dj, rtol)
    _close(Ft, Fj, rtol)


def test_factor_raises_on_indefinite_block():
    _, Ad, Asub, NB = _batch("box")
    Ad[1, 0, 3, 3] = -1.0
    with pytest.raises(ValueError, match="not positive definite.*block row 0, subdomain 1"):
        tband.factor_block_tridiag(Ad, Asub, device="cpu")


@pytest.mark.parametrize("kw", [
    dict(), dict(dtype="float32"), dict(dtype="float32", refine=2),
    dict(dtype="float32", refine=2, op_dtype="float32"), dict(keep_operator=True),
    dict(refine=1, op="external"), dict(scan_major=True), dict(dtype="float32", scan_major=True),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()) or "defaults")
def test_from_block_tridiag_every_argument(kw):
    """Each argument of from_block_tridiag against the JAX package's: the
    same fields set, applies equal to the factors' precision."""
    mats, Ad, Asub, NB = _batch("box")
    kw = dict(kw)
    jkw, tkw = dict(kw), dict(kw)
    for k in ("dtype", "op_dtype"):
        if k in kw:
            jkw[k], tkw[k] = getattr(jnp, kw[k]), getattr(torch, kw[k])
    if kw.get("op") == "external":
        dia = BlockDia.from_scipy_blocks(mats, nlp=Ad.shape[1] * NB, device="cpu")
        tkw["op"] = dia
        jkw["op"] = jband.BlockTridiag.from_blocks(Ad, Asub)
    a, b = (np.moveaxis(Ad, 0, 1), np.moveaxis(Asub, 0, 1)) if kw.get("scan_major") \
        else (Ad, Asub)
    kj = jband.BandCholInv.from_block_tridiag(np.ascontiguousarray(a),
                                              np.ascontiguousarray(b), **jkw)
    kt = tband.BandCholInv.from_block_tridiag(a, b, device="cpu", **tkw)
    assert kt.shape == tuple(kj.shape) and kt.refine == kj.refine
    assert kt.Dinv.shape == kj.Dinv.shape and str(kt.Dinv.dtype)[6:] == str(kj.Dinv.dtype)
    assert (kt.op is None) == (kj.op is None)
    if kw.get("op") == "external":
        assert kt.op is tkw["op"]
    elif kt.op is not None:
        assert isinstance(kt.op, tband.BlockTridiag)
        assert str(kt.op.Ad.dtype)[6:] == str(kj.op.Ad.dtype)
        np.testing.assert_array_equal(kt.op.Ad.numpy(), np.asarray(kj.op.Ad))
    x = np.random.RandomState(5).standard_normal(kt.shape[1])
    f32 = kw.get("dtype") == "float32"
    # f32 factors unrefined: both sides carry f32 round-off of their own
    # (JAX factorizes in f32, the port rounds an f64 recurrence); refined
    # against an f64 operator both reach the direct solve
    rtol = 1e-10
    if f32:
        rtol = 1e-5 if kw.get("op_dtype") != "float32" and kw.get("refine") else 2e-3
    _close(kt.mv(_t(x)), kj.mv(jnp.asarray(x)), rtol)
    if kt.op is not None and kw.get("op") != "external":
        # interop carries the JAX operator across, its refinement operator
        # included: the SAME factors, so the applies agree to round-off
        ki = from_arrays(kj, "cpu")
        assert isinstance(ki.op, tband.BlockTridiag) and ki.refine == kj.refine
        _close(ki.mv(_t(x)), kj.mv(jnp.asarray(x)), 1e-6 if f32 else 1e-13)
    if not f32:  # and the inverse itself, against scipy
        nl = mats[0].shape[0]
        y = kt.mv(_t(x)).numpy().reshape(3, -1)
        for s, M in enumerate(mats):
            _close(M @ y[s, :nl], x.reshape(3, -1)[s, :nl], 1e-10)


def test_from_block_tridiag_rejects_a_second_device():
    _, Ad, Asub, _ = _batch("box")
    with pytest.raises(ValueError, match="device"):
        tband.BandCholInv.from_block_tridiag(_t(Ad), _t(Asub), device="cuda")


@pytest.mark.parametrize("name", CASES)
def test_half_solves_compose_and_match_jax(name):
    _, Ad, Asub, _ = _batch(name)
    kj = jband.BandCholInv.from_block_tridiag(Ad, Asub)
    kt = from_arrays(kj, "cpu")  # the SAME factor arrays
    x = np.random.RandomState(6).standard_normal(kt.shape[1])
    lo, up = kt.half_solve_lower(_t(x)), kt.half_solve_upper(_t(x))
    _close(lo, kj.half_solve_lower(jnp.asarray(x)), 1e-13)
    _close(up, kj.half_solve_upper(jnp.asarray(x)), 1e-13)
    assert torch.equal(kt.half_solve_upper(lo), kt.mv(_t(x)))
    # L^{-T} L^{-1} = A^{-1}: <L^{-1}x, L^{-1}x> = x' A^{-1} x
    _close(torch.dot(lo, lo), torch.dot(_t(x), kt.mv(_t(x))), 1e-12)


@pytest.mark.parametrize("dtype,refine,tol", [(None, 0, 1e-10), ("float32", 3, 1e-8)])
def test_make_band_kplus_generalized_inverse(dtype, refine, tol):
    """Mixed floating (free-free boxes, constant nullspace) and fixed
    (one face eliminated) blocks: K K+ K = K, and the JAX apply."""
    Kf = _kron3(5, 5, 6)
    keep = np.ones(150)
    keep[:25] = 0.0
    Kx = (sp.diags(keep) @ Kf @ sp.diags(keep) + sp.diags(1.0 - keep)).tocsr()
    blocks = [Kf, Kx, (2.0 * Kf).tocsr(), Kx]
    const = np.full((150, 1), 1.0 / np.sqrt(150))
    bases = [const, np.zeros((150, 0)), const, np.zeros((150, 0))]
    tkw = {} if dtype is None else dict(dtype=getattr(torch, dtype))
    jkw = {} if dtype is None else dict(dtype=getattr(jnp, dtype))
    kt, NB = tband.make_band_kplus(blocks, bases, refine=refine, device="cpu", **tkw)
    kj, NBj = jband.make_band_kplus(blocks, bases, refine=refine, **jkw)
    assert NB == NBj == 128 and kt.Dinv.shape == kj.Dinv.shape
    rng = np.random.RandomState(7)
    nlp = kt.shape[0] // 4
    pad = nlp - 150
    for _ in range(2):
        x = rng.standard_normal((4, 150))
        Kx_ = np.stack([B @ x[s] for s, B in enumerate(blocks)])
        rhs = np.pad(Kx_, ((0, 0), (0, pad))).reshape(-1)
        y = kt.mv(_t(rhs)).numpy().reshape(4, nlp)[:, :150]
        KKK = np.stack([B @ y[s] for s, B in enumerate(blocks)])
        assert np.abs(KKK - Kx_).max() <= tol * np.abs(Kx_).max()
        if dtype is None:
            _close(kt.mv(_t(rhs)), kj.mv(jnp.asarray(rhs)), 1e-10)
    # an explicit NB below the bandwidth is refused
    with pytest.raises(ValueError, match="bandwidth"):
        tband.make_band_kplus(blocks, bases, NB=16, device="cpu")


@pytest.mark.parametrize("refine", [0, 2])
def test_cpu_apply_builds_no_graph(monkeypatch, refine):
    """On the CPU every K+ pass is launched op by op: nothing of
    torch.cuda is touched, no ``kplus.replay`` span opens, and ``mv`` is
    the eager passes' composition bitwise."""
    from permon_tpu_torch.sys import tracing

    def refuse(*args, **kwargs):
        raise AssertionError("a CPU apply reached torch.cuda")

    for name in ("CUDAGraph", "graph", "Stream", "is_current_stream_capturing"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    K, NB = _case("box")
    kp, _ = tband.make_band_kplus([K, (2.0 * K).tocsr()], NB=NB, dtype=torch.float32,
                                  refine=refine, device="cpu")
    x = _t(np.random.RandomState(5).standard_normal(kp.shape[0]))
    tracing.reset()
    y = kp.mv(x)
    assert tracing.events["kplus.solve"][0] == 1 + refine
    assert "kplus.replay" not in tracing.events and "_graphs" not in kp.__dict__
    want = kp._eager(x).to(x.dtype)
    for _ in range(refine):
        want = want + kp._eager(x - kp.op.mv(want)).to(x.dtype)
    assert y.dtype == x.dtype and torch.equal(y, want)


@pytest.mark.parametrize("reorder", [True, False])
@pytest.mark.parametrize("NB", [None, 384])
def test_band_chol_single(reorder, NB):
    S = _spd(500, 8, density=0.004)
    if not reorder:  # unordered it has a wide band: order it first
        p = tband.rcm_order(S)
        S = S[p][:, p].tocsr()
    inv, perm = tband.band_chol_single(S, NB=NB, reorder=reorder, device="cpu")
    jinv, jperm = jband.band_chol_single(S, NB=NB, reorder=reorder)
    np.testing.assert_array_equal(perm, jperm)
    assert inv.Dinv.shape == jinv.Dinv.shape and inv.Dinv.shape[1] == 1
    if not reorder:
        np.testing.assert_array_equal(perm, np.arange(500))
    if NB is not None:
        assert inv.Dinv.shape[-1] == NB
    x = np.random.RandomState(9).standard_normal(500)
    xp = np.zeros(inv.shape[0])
    xp[:500] = x[perm]
    y = np.empty(500)
    y[perm] = inv.mv(_t(xp)).numpy()[:500]
    _close(S @ y, x, 1e-11)
    _close(inv.mv(_t(xp)), jinv.mv(jnp.asarray(xp)), 1e-11)


# -- the coarse projector ------------------------------------------------------


def _chain_be(ns, nl, dirichlet=True):
    """Gluing rows of a 1-D chain of ns subdomains sharing one node with the
    next (plus one Dirichlet row), on both packages from the same COO."""
    l2g = np.arange(ns)[:, None] * (nl - 1) + np.arange(nl)[None, :]
    gr, gc, gv, m = jax_build_gluing(l2g, "nonred")
    if dirichlet:
        gr, gc, gv = np.append(gr, m), np.append(gc, 0), np.append(gv, 1.0)
        m += 1
    Bt = SubdomainExtension.from_coo(gr, gc, gv, m=m, ns=ns, nl=nl).with_gather_apply("cpu")
    Bj = jext.SubdomainExtension.from_coo(gr, gc, gv, m=m, ns=ns, nl=nl)
    return Bt, Bj


@pytest.fixture(scope="module")
def chain40():
    return _chain_be(40, 5)


@pytest.mark.parametrize("how", ["to_scipy", "gram"])
def test_band_projector_matches_dense_and_jax(chain40, how):
    from permon_tpu.qp.sparse_rows import to_scipy as jax_to_scipy

    Bt, Bj = chain40
    kw = {}
    if how == "gram":
        Gs = jax_to_scipy(Bj)
        kw = dict(gram=(Gs @ Gs.T).tocsr())
    pf_s = tproj.Projector.create(Bt, orthonormal_rows=False, sparse=True, **kw)
    pf_d = tproj.Projector.create(Bt, orthonormal_rows=False, sparse=False, **kw)
    pj = jproj.Projector.create(Bj, orthonormal_rows=False, sparse=True, **kw)
    assert pf_s.ggt_band is not None and pf_s.ggt_chol is None and pf_d.ggt_band is None
    np.testing.assert_array_equal(pf_s.cp_perm.numpy(), np.asarray(pj.cp_perm))
    rng = np.random.default_rng(2)
    x, v = rng.normal(size=Bt.shape[1]), rng.normal(size=Bt.shape[0])
    for name, arg in (("apply_p", x), ("apply_q", x), ("apply_cp", v), ("apply_half_q", x),
                      ("apply_half_q_t", v)):
        got = getattr(pf_s, name)(_t(arg)).numpy()
        np.testing.assert_allclose(got, getattr(pf_d, name)(_t(arg)).numpy(), rtol=0, atol=1e-10)
        np.testing.assert_allclose(got, np.asarray(getattr(pj, name)(jnp.asarray(arg))),
                                   rtol=0, atol=1e-10)
    # two applies of the band coarse solve are bitwise equal (no accumulation)
    assert torch.equal(pf_s.apply_cp(_t(v)), pf_s.apply_cp(_t(v)))


def test_band_projector_is_the_default_past_2048_rows():
    Bt, Bj = _chain_be(3000, 4, dirichlet=False)
    assert Bt.shape[0] > tproj.SPARSE_GGT_THRESHOLD == jproj.SPARSE_GGT_THRESHOLD
    pf = tproj.Projector.create(Bt, orthonormal_rows=False)
    assert pf.ggt_band is not None
    v = np.random.default_rng(3).normal(size=Bt.shape[0])
    y = pf.apply_cp(_t(v))
    # (GG') y = v
    np.testing.assert_allclose(Bt.mv(Bt.rmv(y)).numpy(), v, rtol=0, atol=1e-10)
    x = _t(np.random.default_rng(4).normal(size=Bt.shape[1]))
    assert float(Bt.mv(pf.apply_p(x)).abs().max()) < 1e-10
    # a small G stays dense by default
    assert tproj.Projector.create(_chain_be(6, 4)[0], orthonormal_rows=False).ggt_band is None


def test_band_projector_interop(chain40):
    Bt, Bj = chain40
    pj = jproj.Projector.create(Bj, orthonormal_rows=False, sparse=True)
    pt = from_arrays(pj.replace(G=Bj.with_gather_apply()), "cpu")
    assert pt.ggt_band is not None and pt.cp_perm.dtype == torch.int64
    v = np.random.default_rng(5).normal(size=Bt.shape[0])
    _close(pt.apply_cp(_t(v)), pj.apply_cp(jnp.asarray(v)), 1e-13)


def test_projection_operators(chain40):
    Bt, Bj = chain40
    pf = tproj.Projector.create(Bt, orthonormal_rows=False, sparse=True)
    pj = jproj.Projector.create(Bj, orthonormal_rows=False, sparse=True)
    rng = np.random.default_rng(6)
    x, v = rng.normal(size=Bt.shape[1]), rng.normal(size=Bt.shape[0])
    n, m = Bt.shape[1], Bt.shape[0]
    for T, J, shape in ((tproj.QOp, jproj.QOp, (n, n)), (tproj.GtGOp, jproj.GtGOp, (n, n)),
                        (tproj.ProjOp, jproj.ProjOp, (n, n)),
                        (tproj.HalfQOp, jproj.HalfQOp, (m, n))):
        top, jop = T(pf=pf), J(pf=pj)
        assert top.shape == shape == tuple(jop.shape)
        _close(top.mv(_t(x)), jop.mv(jnp.asarray(x)), 1e-10)
        _close(top.rmv(_t(x if shape[0] == n else v)),
               jop.rmv(jnp.asarray(x if shape[0] == n else v)), 1e-10)
    _close(pf.apply_gtg(_t(x)), Bt.rmv(Bt.mv(_t(x))), 0)
    # Q is a projector, P its complement
    q = tproj.QOp(pf=pf)
    _close(q.mv(q.mv(_t(x))), q.mv(_t(x)), 1e-10)
    _close(q.mv(_t(x)) + tproj.ProjOp(pf=pf).mv(_t(x)), x, 1e-13)


def test_cached_projector_counts(chain40):
    Bt, Bj = chain40
    ct = tproj.CachedProjector(tproj.Projector.create(Bt, orthonormal_rows=False))
    cj = jproj.CachedProjector(jproj.Projector.create(Bj, orthonormal_rows=False))
    x = np.random.default_rng(7).normal(size=Bt.shape[1])
    xt, xj = _t(x), jnp.asarray(x)
    for c, a in ((ct, xt), (cj, xj)):
        q1 = c.apply_q(a)
        assert c.apply_q(a) is q1  # the same vector object: a hit
        c.apply_p(a)  # a second hit
        c.apply_q(a + 0)  # an equal but new vector: recomputed
        c.apply_half_q(a)
        c.apply_half_q_t(c.pf.G.mv(a))
    assert (ct.hits, ct.cp_applications) == (cj.hits, cj.cp_applications) == (2, 4)


def test_dense_rows_of_a_sparse_row_operator(chain40):
    Bt, Bj = chain40
    rows = tproj.dense_rows(Bt)
    _close(rows, jproj.dense_rows(Bj), 0)
    assert tproj.dense_rows(Dense.create(rows)) is rows
    assert tproj.dense_rows(Dense.create(rows), dtype=torch.float32).dtype == torch.float32
    # without sparse rows the forced band path falls to the dense factor,
    # as the JAX package's does
    pf = tproj.Projector.create(Dense.create(rows), orthonormal_rows=False, sparse=True)
    assert pf.ggt_band is None and pf.ggt_chol is not None
