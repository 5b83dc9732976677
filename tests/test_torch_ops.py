"""permon_tpu_torch operators and host setup functions against the JAX package on
the same inputs (numpy seeds), with the tolerance stated per check:

- fixed-tree reductions, DenseTree, BlockDia, RegularizedBlockDia: bitwise
  in f64 (same elementwise adds in the same order);
- factor_from_dia_sm: f64 rtol 1e-12, f32 rtol 1e-4 (LAPACK Cholesky and
  triangular inverse of two libraries); BandCholInv.mv fed the SAME factor
  arrays: rtol 1e-13; K Kreg^-1 K = K to 1e-10;
- Projector.apply_p: 1e-13; PCPG: same count and reason, x to 1e-12;
- host setup (build_sparse, build_gluing, constant_nullspace_columns,
  assemble_qp_sparse tables): np.array_equal.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse as sp
import torch

import examples.feti_large as jfl
import permon_tpu.core.band as jband
import permon_tpu.core.convergence as jconv
import permon_tpu.core.detred as jdet
import permon_tpu.core.linop as jlin
import permon_tpu.feti.assembly as jasm
import permon_tpu.feti.large as jlarge
import permon_tpu.qp.projector as jproj
from permon_tpu.feti.solve import FetiOptions as JaxFetiOptions

import permon_tpu_torch.core.band as tband
import permon_tpu_torch.core.convergence as tconv
import permon_tpu_torch.core.detred as tdet
import permon_tpu_torch.core.linop as tlin
import permon_tpu_torch.feti.assembly as tasm
import permon_tpu_torch.feti.large as tlarge
import permon_tpu_torch.problems as tprob
import permon_tpu_torch.qp.projector as tproj
from permon_tpu_torch.feti.solve import FetiOptions
from permon_tpu_torch.interop import from_arrays

torch.set_num_threads(2)

CELLS, GRID = (6, 6, 6), (2, 2, 2)


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.fixture(scope="module")
def jax_assembled():
    """The JAX package's assembled small problem, f64 factors, refine=1
    (so kplus.op is the RegularizedBlockDia)."""
    prob = jfl.build_sparse(CELLS, GRID)
    qp, kplus, NB, _ = jlarge.assemble_qp_sparse(
        prob, JaxFetiOptions(gluing="nonred"), kplus_refine=1)
    return prob, qp, kplus, NB


# -- fixed-tree reductions ---------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 7, 64, 1001])
def test_det_sum_and_dots_bitwise(n):
    rng = np.random.RandomState(n)
    x, y, z = (rng.standard_normal(n) for _ in range(3))
    assert float(tdet.det_sum(_t(x))) == float(jdet.det_sum(jnp.asarray(x)))
    got = tdet.det_dots([(_t(x), _t(y)), (_t(y), _t(z))])
    ref = jdet.det_dots([(jnp.asarray(x), jnp.asarray(y)), (jnp.asarray(y), jnp.asarray(z))])
    assert [float(g) for g in got] == [float(r) for r in ref]
    M = rng.standard_normal((5, n))
    np.testing.assert_array_equal(tdet.det_sum(_t(M), dim=0).numpy(),
                                  np.asarray(jdet.det_sum(jnp.asarray(M), axis=0)))
    np.testing.assert_array_equal(tdet.det_gram(_t(M)).numpy(),
                                  np.asarray(jdet.det_gram(jnp.asarray(M))))


@pytest.mark.parametrize("chunked", [False, True])
def test_densetree_bitwise(monkeypatch, chunked):
    if chunked:
        monkeypatch.setattr(tlin.DenseTree, "CHUNK_ELEMS", 50)
        monkeypatch.setattr(jlin.DenseTree, "CHUNK_ELEMS", 50)
    rng = np.random.RandomState(3)
    a = rng.standard_normal((6, 37))
    x, y = rng.standard_normal(37), rng.standard_normal(6)
    T = tlin.DenseTree.create(_t(a))
    J = jlin.DenseTree.create(jnp.asarray(a))
    np.testing.assert_array_equal(T.mv(_t(x)).numpy(), np.asarray(J.mv(jnp.asarray(x))))
    np.testing.assert_array_equal(T.rmv(_t(y)).numpy(), np.asarray(J.rmv(jnp.asarray(y))))


@pytest.mark.parametrize("case", [
    (5, 1.0), (10001, 1.0), (3, float("nan")), (3, 1e-60), (3, 1e-6), (3, 1e9), (3, 0.5),
])
def test_converged_default_reason_codes(case):
    it, rnorm = case
    kw = dict(ttol=1e-5, atol=1e-50, divtol=1e4, norm_rhs_div=1.0, max_it=10000)
    assert tconv.converged_default(it, rnorm, **kw) == int(
        jconv.converged_default(it, rnorm, **kw))


# -- stencil operators and band factors ----------------------------------------


def test_blockdia_and_regularized_mv_bitwise(jax_assembled):
    _, qp, kplus, _ = jax_assembled
    x = np.random.RandomState(4).standard_normal(qp.A.shape[1])
    A = from_arrays(qp.A, "cpu")
    Areg = from_arrays(kplus.op, "cpu")
    np.testing.assert_array_equal(A.mv(_t(x)).numpy(), np.asarray(qp.A.mv(jnp.asarray(x))))
    np.testing.assert_array_equal(Areg.mv(_t(x)).numpy(),
                                  np.asarray(kplus.op.mv(jnp.asarray(x))))


@pytest.mark.parametrize("dtype,rtol", [("float64", 1e-12), ("float32", 1e-4)])
def test_factor_from_dia_sm_matches_jax(jax_assembled, dtype, rtol):
    _, _, kplus, NB = jax_assembled
    op = kplus.op
    Dj, Fj = jband.factor_from_dia_sm(op.base.data, op.base.offsets, NB,
                                      dtype=getattr(jnp, dtype), upd_bi=op.bi,
                                      upd_idx=op.idx, upd_q=op.q)
    top = from_arrays(op, "cpu")
    Dt, Ft = tband.factor_from_dia_sm(top.base.data, top.base.offsets, NB,
                                      dtype=getattr(torch, dtype), upd_bi=top.bi,
                                      upd_idx=top.idx, upd_q=top.q)
    assert Dt.dtype == getattr(torch, dtype) and Dt.shape == Dj.shape
    for t, j in ((Dt, Dj), (Ft, Fj)):
        j = np.asarray(j, dtype=np.float64)
        np.testing.assert_allclose(t.double().numpy(), j, rtol=rtol,
                                   atol=rtol * np.abs(j).max())


@pytest.mark.parametrize("refine", [0, 2])
def test_bandcholinv_mv_same_factors(jax_assembled, refine):
    _, _, kplus, _ = jax_assembled
    kj = kplus.replace(refine=refine)
    kt = from_arrays(kj, "cpu")
    x = np.random.RandomState(5).standard_normal(kj.shape[1])
    ref = np.asarray(kj.mv(jnp.asarray(x)))
    np.testing.assert_allclose(kt.mv(_t(x)).numpy(), ref, rtol=1e-13,
                               atol=1e-13 * np.abs(ref).max())


def test_kreg_inverse_is_generalized_inverse():
    """K Kreg^-1 K = K on the port's own assembly (floating blocks
    included): an exact generalized inverse, to 1e-10."""
    prob = tprob.build_sparse(CELLS, GRID)
    qp, kplus, _, _ = tlarge.assemble_qp_sparse(prob, FetiOptions(gluing="nonred"),
                                                device="cpu")
    assert prob.floating.any()
    rng = np.random.RandomState(6)
    for _ in range(2):
        x = torch.as_tensor(rng.standard_normal(qp.A.shape[1]))
        Kx = qp.A.mv(x)
        KKK = qp.A.mv(kplus.mv(Kx))
        assert float((KKK - Kx).abs().max()) <= 1e-10 * float(Kx.abs().max())


# -- coarse projector ----------------------------------------------------------


@pytest.mark.parametrize("k,m,path", [(5, 60, "dense"), (7, 90, "gram"), (260, 700, "gram")])
def test_projector_apply_p(k, m, path):
    rng = np.random.RandomState(k)
    G = rng.standard_normal((k, m))
    x = rng.standard_normal(m)
    if path == "dense":
        J = jproj.Projector.create(jlin.Dense.create(jnp.asarray(G)))
        T = tproj.Projector.create(tlin.Dense.create(_t(G)))
    else:
        gram = sp.csr_matrix(G @ G.T)
        J = jproj.Projector.create(jlin.DenseTree.create(jnp.asarray(G)), gram=gram)
        T = tproj.Projector.create(tlin.DenseTree.create(_t(G)), gram=gram)
        assert (T.ggt_inv is not None) == (k >= 256)
    ref = np.asarray(J.apply_p(jnp.asarray(x)))
    np.testing.assert_allclose(T.apply_p(_t(x)).numpy(), ref, atol=1e-13 * np.abs(x).max())
    # the same factors handed over: still 1e-13
    np.testing.assert_allclose(from_arrays(J, "cpu").apply_p(_t(x)).numpy(), ref,
                               atol=1e-13 * np.abs(x).max())


def test_has_orthonormal_rows_agrees():
    from permon_tpu.core.matutils import has_orthonormal_rows as jhas

    rng = np.random.RandomState(8)
    Q, _ = np.linalg.qr(rng.standard_normal((30, 4)))
    for M in (Q.T, rng.standard_normal((4, 30))):
        assert tproj.has_orthonormal_rows(tlin.Dense.create(_t(M))) == jhas(
            jlin.Dense.create(jnp.asarray(M)))


# -- host setup ---------------------------------------------------------------


@pytest.mark.parametrize("cells,grid", [((6, 6, 6), (2, 2, 2)), ((7, 5, 6), (2, 3, 1))])
def test_build_sparse_equal(cells, grid):
    pj, pt = jfl.build_sparse(cells, grid), tprob.build_sparse(cells, grid)
    for f in ("b_loc", "l2g", "floating"):
        np.testing.assert_array_equal(getattr(pt, f), getattr(pj, f))
    assert len(pt.K_blocks) == len(pj.K_blocks)
    for Kt, Kj in zip(pt.K_blocks, pj.K_blocks):
        np.testing.assert_array_equal(Kt.toarray(), Kj.toarray())
    At, bt = tprob.assembled_system(cells)
    Aj, bj = jfl.assembled_system(cells)
    assert (At != Aj).nnz == 0
    np.testing.assert_array_equal(bt, bj)


@pytest.mark.parametrize("gluing", ["nonred", "full"])
@pytest.mark.parametrize("scale", [True, False])
def test_build_gluing_equal(gluing, scale):
    l2g = jfl.build_sparse((7, 5, 6), (2, 3, 1)).l2g
    got = tasm.build_gluing(l2g, gluing, scale)
    ref = jasm.build_gluing(l2g, gluing, scale)
    for g, r in zip(got[:3], ref[:3]):
        np.testing.assert_array_equal(g, r)
    assert got[3] == ref[3]


def test_constant_nullspace_and_assembly_tables_equal(jax_assembled):
    prob, qp, kplus, NB = jax_assembled
    fixed = ~np.asarray(prob.floating)
    got = tasm.constant_nullspace_columns(prob, fixed)
    ref = jasm.constant_nullspace_columns(prob, fixed)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)

    qt, kt, NBt, _ = tlarge.assemble_qp_sparse(tprob.build_sparse(CELLS, GRID),
                                               FetiOptions(gluing="nonred"),
                                               kplus_refine=1, device="cpu")
    assert NBt == NB
    for f in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(qt.BE, f), np.asarray(getattr(qp.BE, f)))
    np.testing.assert_array_equal(qt.BE.gB.idx.numpy(), np.asarray(qp.BE.gB_cols))
    np.testing.assert_array_equal(qt.BE.gBt.idx.numpy(), np.asarray(qp.BE.gBt_rows))
    np.testing.assert_array_equal(qt.BE.gBt.vals.numpy(), np.asarray(qp.BE.gBt_vals))
    np.testing.assert_array_equal(qt.R.cols.numpy(), np.asarray(qp.R.cols))
    np.testing.assert_array_equal(qt.R.vals.numpy(), np.asarray(qp.R.vals))
    np.testing.assert_array_equal(qt.A.data.numpy(), np.asarray(qp.A.data))
    assert qt.A.offsets == tuple(qp.A.offsets)
    for f in ("idx", "q", "bi"):
        np.testing.assert_array_equal(getattr(kt.op, f).numpy(), np.asarray(getattr(kplus.op, f)))
    np.testing.assert_array_equal(qt.b.numpy(), np.asarray(qp.b))


# -- PCPG ----------------------------------------------------------------------


@pytest.mark.parametrize("case", ["spd_projected", "breakdown"])
def test_cg_matches_jax(case):
    """Same iteration count and reason as the JAX cg on a small dense QP
    (deterministic reductions); x within 1e-12, the residual history within
    1e-9 relative / 1e-12 of ||P r0||."""
    from permon_tpu.core.detred import deterministic_mode as jdm
    from permon_tpu.qp.qp import QP as JQP
    from permon_tpu.solvers.cg import cg as jcg

    from permon_tpu_torch.core.detred import deterministic_mode as tdm
    from permon_tpu_torch.qp.qp import QP as TQP
    from permon_tpu_torch.solvers.cg import cg as tcg

    rng = np.random.RandomState(11)
    n = 30
    if case == "breakdown":
        A = -np.eye(n)  # negative curvature: stops with reason 3 at once
        G = None
    else:
        M = rng.standard_normal((n, n))
        A = M @ M.T + n * np.eye(n)
        G = rng.standard_normal((3, n))
    b = rng.standard_normal(n)
    tol = tconv.Tolerances(rtol=1e-10)
    jp = tp = None
    if G is not None:
        jp = jproj.Projector.create(jlin.Dense.create(jnp.asarray(G))).apply_p
        tp = tproj.Projector.create(tlin.Dense.create(_t(G))).apply_p
    with jdm(True):
        rj = jcg(JQP(A=jlin.Dense.create(jnp.asarray(A)), b=jnp.asarray(b)),
                 tol=jconv.Tolerances(rtol=1e-10), project=jp, history=50)
    with tdm(True):
        rt = tcg(TQP(A=tlin.Dense.create(_t(A)), b=_t(b)), tol=tol, project=tp, history=50)
    assert (rt.iterations, rt.reason) == (int(rj.iterations), int(rj.reason))
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=0, atol=1e-12)
    hj = np.asarray(rj.rnorm_history)
    np.testing.assert_allclose(rt.rnorm_history.numpy(), hj, rtol=1e-9,
                               atol=1e-12 * hj[0], equal_nan=True)
