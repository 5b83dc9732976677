"""The factorized inverses of permon_tpu_torch (``core/factor.py``) and
``dualize`` without a supplied K+, against the JAX package on the CPU:
the same numpy-seeded factors through both packages, the generalized
inverse identities, the ``kplus_mode`` compositions, and the tutorial ex3
(the obstacle as an inequality, dualized with a dense K+) at its pinned
counts, with and without the empty nullspace; the ex3 example's main
against the JAX package's (tests/torch_example_parity.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import permon_tpu as jpt
import permon_tpu_torch as tpt
from examples import ex3 as jax_ex3
from permon_tpu.core import factor as jfactor
from permon_tpu.qp.transforms import dualize as jax_dualize
from permon_tpu_torch.core import factor
from permon_tpu_torch.core.linop import Dense
from permon_tpu_torch.interop import from_arrays
from permon_tpu_torch.problems import build_ex1, build_ex3
from permon_tpu_torch.qp.transforms import (Solution, compose, dualize,
                                            enforce_eq_by_projector, homogenize_eq)

from torch_example_parity import check_example

torch.set_num_threads(2)

CLOSE = dict(rtol=1e-12, atol=1e-12)


def _spd_blocks(nb, bs, seed):
    rng = np.random.RandomState(seed)
    blocks = rng.rand(nb, bs, bs)
    return blocks @ blocks.transpose(0, 2, 1) + bs * np.eye(bs), rng


def _free_laplacian(n):
    L = 2 * np.eye(n) - np.eye(n, k=1) - np.eye(n, k=-1)
    L[0, 0] = L[-1, -1] = 1.0
    return L


def test_cholinv_matches_jax():
    (A,), rng = _spd_blocks(1, 10, 0)
    x = rng.rand(10)
    t = factor.CholInv.from_dense(torch.as_tensor(A))
    j = jfactor.CholInv.from_dense(jnp.asarray(A))
    np.testing.assert_allclose(t.chol.numpy(), np.asarray(j.chol), **CLOSE)
    np.testing.assert_allclose(t.mv(torch.as_tensor(x)).numpy(), np.asarray(j.mv(jnp.asarray(x))),
                               **CLOSE)
    np.testing.assert_allclose(t.rmv(torch.as_tensor(x)).numpy(), np.linalg.solve(A, x), **CLOSE)
    moved = from_arrays(j, "cpu")
    assert isinstance(moved, factor.CholInv) and moved.shape == (10, 10)
    np.testing.assert_array_equal(moved.chol.numpy(), np.asarray(j.chol))


@pytest.mark.parametrize("explicit", [False, True])
def test_blockdiag_cholinv_both_modes(explicit):
    """The oracle of tests/test_linop.py:97-107: the explicit inverse GEMV
    equals the triangular solves to 1e-10; both equal the JAX package's."""
    blocks, rng = _spd_blocks(3, 7, 5)
    x = rng.rand(21)
    t = factor.BlockDiagCholInv.from_blocks(torch.as_tensor(blocks), explicit=explicit)
    j = jfactor.BlockDiagCholInv.from_blocks(jnp.asarray(blocks), explicit=explicit)
    assert (t.invs is not None) == explicit and t.shape == (21, 21)
    y_t = t.mv(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(y_t, np.asarray(j.mv(jnp.asarray(x))), rtol=1e-12)
    y_exp = t.explicitly().mv(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(y_exp, y_t, rtol=1e-10)
    assert t.explicitly().explicitly().invs is t.explicitly().invs or explicit is False
    ref = np.concatenate([np.linalg.solve(blocks[s], x[7 * s: 7 * s + 7]) for s in range(3)])
    np.testing.assert_allclose(y_t, ref, rtol=1e-10)
    moved = from_arrays(j, "cpu")
    np.testing.assert_allclose(moved.mv(torch.as_tensor(x)).numpy(), y_t, rtol=1e-12)


@pytest.mark.parametrize("explicit", [False, True])
def test_ragged_blockdiag_cholinv(explicit):
    """Blocks of true sizes 5, 9, 12, 3 padded to 12 with unit diagonals:
    buckets by ``round_to`` 4, padding passed through, the JAX package's
    result, and ``explicitly`` equal to the bucketed applies."""
    sizes = [5, 9, 12, 3]
    nl = 12
    blocks = np.tile(np.eye(nl), (4, 1, 1))
    rng = np.random.RandomState(9)
    for s, n in enumerate(sizes):
        M = rng.rand(n, n)
        blocks[s, :n, :n] = M @ M.T + n * np.eye(n)
    x = rng.rand(4 * nl)
    t = factor.RaggedBlockDiagCholInv.from_blocks(torch.as_tensor(blocks), sizes, round_to=4,
                                                  explicit=explicit)
    j = jfactor.RaggedBlockDiagCholInv.from_blocks(jnp.asarray(blocks), sizes, round_to=4,
                                                   explicit=explicit)
    assert [int(b[1].shape[1]) for b in t.buckets] == [4, 8, 12]
    y = t.mv(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(y, np.asarray(j.mv(jnp.asarray(x))), rtol=1e-12)
    ref = np.concatenate([np.linalg.solve(blocks[s], x[nl * s: nl * (s + 1)]) for s in range(4)])
    np.testing.assert_allclose(y, ref, rtol=1e-10)
    np.testing.assert_array_equal(y.reshape(4, nl)[3, 4:], x.reshape(4, nl)[3, 4:])  # padding
    dense = t.explicitly()
    assert isinstance(dense, factor.BlockDiagCholInv) and dense.invs.shape == (4, nl, nl)
    np.testing.assert_allclose(dense.mv(torch.as_tensor(x)).numpy(), y, rtol=1e-10)
    np.testing.assert_allclose(dense.invs.numpy(), np.asarray(j.explicitly().invs), atol=1e-13)
    moved = from_arrays(j, "cpu")
    np.testing.assert_allclose(moved.mv(torch.as_tensor(x)).numpy(), y, rtol=1e-12)


def test_iterative_inverse_matches_direct_and_jax():
    """The oracle of tests/test_linop.py:147-158."""
    (A,), rng = _spd_blocks(1, 12, 8)
    x = rng.rand(12)
    t = factor.IterativeInv(a=Dense.create(torch.as_tensor(A)), rtol=1e-12)
    y = t.mv(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(y, factor.CholInv.from_dense(torch.as_tensor(A)).mv(
        torch.as_tensor(x)).numpy(), atol=1e-9)
    j = jfactor.IterativeInv(a=jpt.Dense.create(jnp.asarray(A)), rtol=1e-12)
    np.testing.assert_allclose(y, np.asarray(j.mv(jnp.asarray(x))), atol=1e-12)
    moved = from_arrays(j, "cpu")
    assert moved.rtol == 1e-12 and moved.max_it == 1000
    np.testing.assert_allclose(moved.mv(torch.as_tensor(x)).numpy(), y, atol=1e-14)


def test_iterative_inverse_as_kplus_of_dualize():
    """An IterativeInv in dualize, solved through homogenize, the projector
    and CG: the KKT solution (the oracle of tests/test_linop.py:160-175 on
    the port's chain)."""
    rng = np.random.default_rng(13)
    n = 14
    M = rng.standard_normal((n, n))
    A = M @ M.T + n * np.eye(n)
    b = rng.standard_normal(n)
    BE = rng.standard_normal((2, n))
    qp = tpt.QP.create(A, b, BE=BE, cE=np.zeros(2), device="cpu")
    kplus = factor.IterativeInv(a=Dense.create(torch.as_tensor(A)), rtol=1e-12)
    steps = [dualize(qp, kplus=kplus)]
    steps.append(homogenize_eq(steps[-1][0]))
    steps.append(enforce_eq_by_projector(steps[-1][0]))
    res = tpt.solve(steps[-1][0], qps_type="cg", tol=tpt.Tolerances(rtol=1e-12))
    x = compose(steps)(Solution(x=res.x)).x.numpy()
    kkt = np.block([[A, BE.T], [BE, np.zeros((2, 2))]])
    np.testing.assert_allclose(x, np.linalg.solve(kkt, np.concatenate([b, np.zeros(2)]))[:n],
                               atol=1e-5)


def test_kplus_on_singular():
    """K K+ K = K for the regularized inverse of a free-free Laplacian
    (tests/test_transforms.py:82-97); the nullspace, the projector and the
    regularized matrix equal the JAX package's."""
    L = _free_laplacian(12)
    R, defect = factor.detect_nullspace_dense(L, device="cpu")
    Rj, defect_j = jfactor.detect_nullspace_dense(jnp.asarray(L))
    assert defect == defect_j == 1
    assert R.device.type == "cpu"
    # a tensor or an operator is read where it lies
    Rt, _ = factor.detect_nullspace_dense(torch.as_tensor(L))
    Ro, _ = factor.detect_nullspace_dense(Dense.create(torch.as_tensor(L)))
    np.testing.assert_array_equal(Rt.numpy(), R.numpy())
    np.testing.assert_array_equal(Ro.numpy(), R.numpy())
    Rn = R.numpy()
    np.testing.assert_allclose(np.abs(Rn), np.abs(np.asarray(Rj)), atol=1e-12)  # up to sign
    Q = factor.nullspace_projector_dense(R)
    np.testing.assert_allclose(Q.numpy(), np.asarray(jfactor.nullspace_projector_dense(Rj)),
                               atol=1e-13)
    # rho = ||K|| by the power method: the all-ones start lies in ker K, so
    # both packages restart from their own pseudo-random vectors and stop at
    # the method's relative tolerance 1e-4; with a given rho they agree
    Kreg = factor.regularize_dense(torch.as_tensor(L), R)
    jKreg = np.asarray(jfactor.regularize_dense(jnp.asarray(L), Rj))
    np.testing.assert_allclose(Kreg.numpy(), jKreg, rtol=1e-4)
    np.testing.assert_allclose(factor.regularize_dense(torch.as_tensor(L), R, rho=4.0).numpy(),
                               np.asarray(jfactor.regularize_dense(jnp.asarray(L), Rj, rho=4.0)),
                               atol=1e-13)
    Kplus = factor.make_inv(Dense.create(torch.as_tensor(L)), R=Dense.create(R))
    X = Kplus.todense().numpy()
    np.testing.assert_allclose(L @ X @ L, L, atol=1e-9)
    jX = np.asarray(jfactor.make_inv(jpt.Dense.create(L), R=jpt.Dense.create(Rj)).todense())
    np.testing.assert_allclose(X, jX, rtol=1e-3, atol=1e-8)
    # no regularization without R or with regularize=False: the plain Cholesky
    A = L + np.eye(12)
    for kp in (factor.make_inv(A, device="cpu"),
               factor.make_inv(A, R=R, regularize=False, device="cpu")):
        np.testing.assert_allclose(kp.todense().numpy(), np.linalg.inv(A), atol=1e-12)


# ---------------------------------------------------------------- dualize


def test_build_ex3_equals_the_example_inputs():
    A, b, BI, cI = build_ex3(100)
    Aj, bj, obst = jax_ex3.build(100)
    np.testing.assert_array_equal(A, Aj)
    np.testing.assert_array_equal(b, bj)
    np.testing.assert_array_equal(BI, -np.eye(100))
    np.testing.assert_array_equal(cI, -obst)
    np.testing.assert_array_equal(build_ex1(7)[2], -build_ex3(7)[3])


def _ex3_port(n=100):
    A, b, BI, cI = build_ex3(n)
    qp = tpt.QP.create(A, b, BI=BI, cI=cI, device="cpu")
    dual, post = dualize(qp)
    return A, b, cI, qp, dual, post


def test_ex3_through_dualize_at_the_pinned_counts():
    """The oracle of tests/test_transforms.py:24-44 (src/tutorials/output/
    ex3_1.out): K+ by make_inv, the dual MPRGP at 44 iterations, 71
    products, 17 / 26 / 1; the primal stationary to 1e-10 and equal to
    the JAX package's and to ex1's."""
    A, b, cI, qp, dual, post = _ex3_port()
    assert isinstance(dual.A.ops[1], factor.CholInv)
    res = tpt.solve(dual)
    sol = post(Solution(x=res.x, g=res.g))
    assert res.reason == 2
    counts = (res.iterations, res.nmv, res.ncg, res.nexp, res.nprop)
    assert counts == (44, 71, 17, 26, 1)
    _, _, jres, jsol = jax_ex3.main(100, view=False)
    assert counts == (int(jres.iterations), int(jres.nmv), int(jres.ncg), int(jres.nexp),
                      int(jres.nprop))
    x, lamI = sol.x.numpy(), sol.lambda_I.numpy()
    np.testing.assert_allclose(x, np.asarray(jsol.x), atol=1e-10)
    assert np.linalg.norm(A @ x - b - lamI) / np.linalg.norm(b) < 1e-10
    res1 = tpt.solve(tpt.QP.create(A, b, lb=-cI, device="cpu"))
    np.testing.assert_allclose(x, res1.x.numpy(), atol=1e-4)


def test_ex3_empty_nullspace_through_smalxe():
    """The -empty_nullsp oracle (tests/test_transforms.py:186-202): SMALXE
    over a 0-row equality block, 1 outer / 46 inner iterations, 74
    products, 18 / 27 / 1."""
    from permon_tpu_torch.solvers.smalxe import SMALXEOptions, smalxe

    _, _, _, _, dual, post = _ex3_port()
    m = dual.b.shape[0]
    dual0 = dual.replace(BE=Dense.create(torch.zeros((0, m), dtype=torch.float64)),
                         cE=torch.zeros(0, dtype=torch.float64), pf=None)
    res = smalxe(dual0, opts=SMALXEOptions(inject_maxeig=True))
    assert res.reason > 0
    assert (res.iterations, res.inner_iterations) == (1, 46)
    assert (res.nmv, res.ncg, res.nexp, res.nprop) == (74, 18, 27, 1)
    assert post(Solution(x=res.x)).x.shape == (m,)


def test_dualize_with_nullspace():
    """A singular Hessian with equality rows: the TFETI algebra, K+ by
    make_inv over R (tests/test_transforms.py:158-183); the dual equals the
    JAX package's."""
    n = 16
    L = _free_laplacian(n)
    rng = np.random.default_rng(4)
    BE = rng.normal(size=(4, n))
    b = rng.normal(size=n)
    b = b - np.mean(b)
    R = np.full((n, 1), 1.0 / np.sqrt(n))
    qp = tpt.QP.create(L, b, BE=BE, cE=np.zeros(4), R=R, device="cpu")
    dual, post = dualize(qp)
    assert dual.BE is not None
    jdual, _ = jax_dualize(jpt.QP.create(L, b, BE=BE, cE=np.zeros(4), R=R))
    # F holds B Q B' / rho, rho from the power method's random restart in
    # each package (see test_kplus_on_singular): equal to its tolerance
    np.testing.assert_allclose(dual.A.todense().numpy(), np.asarray(jdual.A.todense()),
                               rtol=1e-3)
    np.testing.assert_allclose(dual.b.numpy(), np.asarray(jdual.b), atol=1e-12)
    steps = [(dual, post)]
    steps.append(homogenize_eq(dual))
    steps.append(enforce_eq_by_projector(steps[-1][0]))
    res = tpt.solve(steps[-1][0], qps_type="cg", tol=tpt.Tolerances(rtol=1e-12))
    sol = compose(steps)(Solution(x=res.x))
    x, lamE = sol.x.numpy(), sol.lambda_E.numpy()
    np.testing.assert_allclose(BE @ x, 0, atol=1e-8)
    assert np.linalg.norm(L @ x - b + BE.T @ lamE) / np.linalg.norm(b) < 1e-8


def _block_singular_qp(ns=3, nl=6, seed=0):
    """A block-diagonal singular K (free-free Laplacian blocks, one
    constant nullspace column each), R, and gluing rows BE tying block s's
    last dof to block s+1's first, plus one Dirichlet row: the shape of
    the FETI QP that tests/test_transforms.py:205-239 assembles."""
    n = ns * nl
    K = np.zeros((n, n))
    R = np.zeros((n, ns))
    for s in range(ns):
        K[s * nl:(s + 1) * nl, s * nl:(s + 1) * nl] = _free_laplacian(nl) * (1.0 + s)
        R[s * nl:(s + 1) * nl, s] = 1.0 / np.sqrt(nl)
    rows = []
    for s in range(ns - 1):
        r = np.zeros(n)
        r[(s + 1) * nl - 1], r[(s + 1) * nl] = 1.0, -1.0
        rows.append(r)
    d = np.zeros(n)
    d[0] = 1.0
    rows.append(d)
    b = np.random.RandomState(seed).standard_normal(n)
    return K, R, np.array(rows), b


@pytest.mark.parametrize("mode", ["left", "mp"])
def test_dualize_kplus_modes(mode):
    """-qpt_dualize_Kplus_left / _mp: the composed K+ is a left
    generalized inverse (K K+ K = K), for 'mp' also K+ K K+ = K+ (the
    identities of tests/test_transforms.py:205-239), and equals the JAX
    package's composition."""
    K, R, BE, b = _block_singular_qp()
    qp = tpt.QP.create(K, b, BE=BE, cE=np.zeros(BE.shape[0]), R=R, device="cpu")
    dual, _ = dualize(qp, kplus_mode=mode)
    Kp = dual.A.ops[1]
    assert len(Kp.ops) == (3 if mode == "mp" else 2)
    Kt = qp.A
    v = torch.as_tensor(np.random.default_rng(0).standard_normal(b.shape[0]))
    np.testing.assert_allclose(Kt.mv(Kp.mv(Kt.mv(v))).numpy(), Kt.mv(v).numpy(), atol=1e-8)
    if mode == "mp":
        np.testing.assert_allclose(Kp.mv(Kt.mv(Kp.mv(v))).numpy(), Kp.mv(v).numpy(), atol=1e-8)
    jdual, _ = jax_dualize(jpt.QP.create(K, b, BE=BE, cE=np.zeros(BE.shape[0]), R=R),
                           kplus_mode=mode)
    jKp_v = np.asarray(jdual.A.ops[1].mv(jnp.asarray(v.numpy())))
    np.testing.assert_allclose(Kp.mv(v).numpy(), jKp_v, atol=1e-10)
    with pytest.raises(ValueError, match="kplus_mode"):
        dualize(qp, kplus_mode="right")


# -- the command-line example of this path --------------------------------------


@pytest.mark.parametrize("name", ["ex3"])
def test_example_matches_jax_example(name):
    """The example's main against the JAX package's, in-process: every
    printed line with the numbers masked, and the solution
    (tests/torch_example_parity.py)."""
    check_example(name)
