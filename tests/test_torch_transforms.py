"""The QP transforms and the orthonormalization of permon_tpu_torch
(``qp/transforms.py``, ``qp/orth.py``) against the JAX package and the
oracles of tests/test_transforms.py, on the CPU.

Tolerances, per check:

- orth_rows (every method): Q = T B and Q Q' = I to 1e-12, Q and T equal
  to the JAX package's to 1e-12; BandOrthT: T B B' T' = I to 1e-10, its
  applies equal to the JAX package's (its factor handed over) to 1e-12;
- the chain oracles (homogenize + projector + CG, penalty, the
  orthonormalize_eq chain, dualize with a nullspace, feti_prepare and the
  reuse-cp cache): the JAX tests' own limits against the KKT solution
  (1e-7 / 1e-6, penalty 1e-5, feti_prepare 1e-5);
- the row transforms (split_be, remove_gluing_of_dirichlet_dofs, scale,
  freeze_ineq, normalize): the rows, right-hand sides and post-solved
  multipliers equal to the JAX package's to 1e-14.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import examples.feti_ex1 as jex1
import permon_tpu as jpt
import permon_tpu.feti.solve as jsolve
import permon_tpu.qp.orth as jorth
import permon_tpu.qp.transforms as jtr
from permon_tpu.qp.sparse_rows import to_coo as jax_to_coo

import permon_tpu_torch as tpt
import permon_tpu_torch.feti.solve as tsolve
import permon_tpu_torch.problems as tprob
import permon_tpu_torch.qp.orth as torth
import permon_tpu_torch.qp.transforms as ttr
from permon_tpu_torch.core.convergence import Tolerances
from permon_tpu_torch.core.linop import Dense
from permon_tpu_torch.interop import from_arrays
from permon_tpu_torch.qp.sparse_rows import to_coo
from permon_tpu_torch.qp.transforms import Solution, compose

torch.set_num_threads(2)

CLOSE = dict(rtol=0, atol=1e-12)


def _t(a):
    return torch.as_tensor(np.asarray(a))


# -- orthonormalization -----------------------------------------------------------


@pytest.mark.parametrize("method", ["gs", "gs_lingen", "cholesky", "implicit", "inexact"])
def test_orth_rows_methods(method):
    B = np.random.default_rng(9).normal(size=(5, 30))
    Q, T = torth.orth_rows(_t(B), method)
    jQ, jT = jorth.orth_rows(jnp.asarray(B), method)
    np.testing.assert_allclose((T @ _t(B)).numpy(), Q.numpy(), **CLOSE)
    if method not in ("implicit", "inexact"):
        np.testing.assert_allclose((Q @ Q.T).numpy(), np.eye(5), **CLOSE)
    np.testing.assert_allclose(Q.numpy(), np.asarray(jQ), **CLOSE)
    np.testing.assert_allclose(T.numpy(), np.asarray(jT), **CLOSE)


def test_orth_columns_and_unknown_method():
    A = np.random.default_rng(10).normal(size=(20, 4))
    Q, T = torth.orth_columns(_t(A), "gs")
    np.testing.assert_allclose((Q.T @ Q).numpy(), np.eye(4), **CLOSE)
    np.testing.assert_allclose((_t(A) @ T.T).numpy(), Q.numpy(), **CLOSE)
    with pytest.raises(ValueError, match="unknown"):
        torth.orth_rows(_t(A), "householder")


@pytest.fixture(scope="module")
def wide_gluing():
    """ex1 on 2100 one-element subdomains: BE has 2101 rows (past the
    2048-row switch of orthonormalize_eq to the band path)."""
    prob = tprob.build_feti_ex1(2100, 1)
    qp, *_ = tsolve.assemble_qp(prob, tsolve.FetiOptions(gluing="nonred"), device="cpu")
    jqp, *_ = jsolve.assemble_qp(jex1.build(2100, 1), jsolve.FetiOptions(gluing="nonred"))
    return qp, jqp


def test_band_orth_t_against_dense_cholesky_and_jax(wide_gluing):
    qp, jqp = wide_gluing
    Qop, T = torth.orth_rows_implicit_band(qp.BE)
    Bd = qp.BE.todense()
    m = Bd.shape[0]
    TB = torch.stack([Qop.rmv(e) for e in torch.eye(m, dtype=torch.float64)[:64]])
    np.testing.assert_allclose((TB @ TB.T).numpy(), np.eye(64), rtol=0, atol=1e-10)
    # T'T = (BB')^{-1}, as the dense Cholesky gives it
    x = torch.as_tensor(np.random.default_rng(2).normal(size=m))
    np.testing.assert_allclose(T.rmv(T.mv(x)).numpy(),
                               torch.linalg.solve(Bd @ Bd.T, x).numpy(), rtol=0, atol=1e-10)
    _, jT = jorth.orth_rows_implicit_band(jqp.BE)
    moved = from_arrays(jT, "cpu")
    np.testing.assert_array_equal(moved.perm.numpy(), T.perm.numpy())
    for fn in ("mv", "rmv"):
        np.testing.assert_allclose(getattr(T, fn)(x).numpy(),
                                   np.asarray(getattr(jT, fn)(jnp.asarray(x.numpy()))), **CLOSE)
        np.testing.assert_allclose(getattr(moved, fn)(x).numpy(), getattr(T, fn)(x).numpy(),
                                   **CLOSE)


def test_orthonormalize_eq_band_branch(wide_gluing):
    qp, _ = wide_gluing
    child, post = ttr.orthonormalize_eq(qp, "implicit")
    assert isinstance(child.BE.ops[0], torth.BandOrthT) and child.pf.orthonormal_rows
    lam = torch.as_tensor(np.random.default_rng(3).normal(size=qp.BE.shape[0]))
    back = post(Solution(x=qp.b, lambda_E=lam)).lambda_E
    # B' (T' lam) = (T B)' lam
    np.testing.assert_allclose(qp.BE.rmv(back).numpy(), child.BE.rmv(lam).numpy(),
                               rtol=0, atol=1e-10)


# -- the chain oracles of tests/test_transforms.py --------------------------------


def _eq_qp(n=24, seed=3, cE_nonzero=True):
    rng = np.random.default_rng(seed)
    A = (np.diag(np.full(n, 2.0)) + np.diag(np.full(n - 1, -1.0), 1)
         + np.diag(np.full(n - 1, -1.0), -1) + 0.3 * np.eye(n))
    b = rng.normal(size=n)
    BE = rng.normal(size=(3, n))
    cE = rng.normal(size=3) * (1.0 if cE_nonzero else 0.0)
    return tpt.QP.create(A, b, BE=BE, cE=cE, device="cpu"), (A, b, BE, cE)


def _kkt(A, b, BE, cE):
    n, m = A.shape[0], BE.shape[0]
    sol = np.linalg.solve(np.block([[A, BE.T], [BE, np.zeros((m, m))]]),
                          np.concatenate([b, cE]))
    return sol[:n], sol[n:]


def _cg(qp, rtol):
    return tpt.solve(qp, qps_type="cg", tol=Tolerances(rtol=rtol))


def test_homogenize_projector_cg():
    qp, arrays = _eq_qp()
    xref, lamref = _kkt(*arrays)
    c1, p1 = ttr.homogenize_eq(qp)
    c2, p2 = ttr.enforce_eq_by_projector(c1)
    sol = compose([(c1, p1), (c2, p2)])(Solution(x=_cg(c2, 1e-10).x))
    np.testing.assert_allclose(sol.x.numpy(), xref, atol=1e-7)
    np.testing.assert_allclose(sol.lambda_E.numpy(), lamref, atol=1e-6)


def test_penalty_matches():
    qp, arrays = _eq_qp(cE_nonzero=False)
    xref, _ = _kkt(*arrays)
    child, post = ttr.enforce_eq_by_penalty(qp, rho=1e8)
    sol = post(Solution(x=_cg(child, 1e-12).x))
    np.testing.assert_allclose(sol.x.numpy(), xref, atol=1e-5)


@pytest.mark.parametrize("method", ["gs", "cholesky", "implicit", "gs_lingen"])
def test_orthonormalize_eq_chain(method):
    qp, arrays = _eq_qp()
    xref, lamref = _kkt(*arrays)
    steps = []
    cur = qp
    for fn in (lambda q: ttr.orthonormalize_eq(q, method), ttr.homogenize_eq,
               ttr.enforce_eq_by_projector):
        cur, ps = fn(cur)
        steps.append((cur, ps))
    sol = compose(steps)(Solution(x=_cg(cur, 1e-10).x))
    np.testing.assert_allclose(sol.x.numpy(), xref, atol=1e-7)
    np.testing.assert_allclose(sol.lambda_E.numpy(), lamref, atol=1e-6)


def test_dualize_with_nullspace():
    n = 16
    L = 2 * np.eye(n) - np.eye(n, k=1) - np.eye(n, k=-1)
    L[0, 0] = L[-1, -1] = 1.0
    rng = np.random.default_rng(4)
    BE, b = rng.normal(size=(4, n)), rng.normal(size=n)
    b = b - b.mean()
    qp = tpt.QP.create(L, b, BE=BE, cE=np.zeros(4), R=np.full((n, 1), 1 / np.sqrt(n)),
                       device="cpu")
    child, post = ttr.feti_prepare(qp)
    sol = post(Solution(x=_cg(child, 1e-12).x))
    x = sol.x.numpy()
    np.testing.assert_allclose(BE @ x, 0, atol=1e-8)
    r = L @ x - b + BE.T @ sol.lambda_E.numpy()
    assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-8


def _singular_eq_qp():
    """A singular Hessian with a 2-D nullspace (tests/test_transforms.py::
    TestFetiPrepare)."""
    rng = np.random.default_rng(11)
    n = 20
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    R = Q[:, :2]
    A = Q[:, 2:] @ np.diag(1.0 + rng.random(n - 2)) @ Q[:, 2:].T
    b, BE = rng.standard_normal(n), rng.standard_normal((3, n))
    qp = tpt.QP.create(A, b, BE=BE, cE=np.zeros(3), R=R, device="cpu")
    kkt = np.block([[A, BE.T], [BE, np.zeros((3, 3))]])
    return qp, lambda rhs: np.linalg.solve(kkt, np.concatenate([rhs, np.zeros(3)]))[:n], b


def test_feti_prepare_matches_kkt():
    qp, kkt, b = _singular_eq_qp()
    child, post = ttr.feti_prepare(qp)
    x = post(Solution(x=tpt.solve(child).x)).x.numpy()
    np.testing.assert_allclose(x, kkt(b), atol=1e-5)


def test_reuse_cp_caches_projector_and_resets():
    qp, kkt, b = _singular_eq_qp()
    ttr.feti_prepare_reuse_cp_reset()
    c1, _ = ttr.feti_prepare_reuse_cp(qp)
    c2, post2 = ttr.feti_prepare_reuse_cp(qp.replace(b=qp.b * 2.0))
    assert c1.pf is not None and c1.pf is c2.pf  # the same coarse factor
    assert len(ttr._REUSE_CP_CACHE) == 1
    x2 = post2(Solution(x=tpt.solve(c2).x)).x.numpy()
    np.testing.assert_allclose(x2, kkt(2.0 * b), atol=1e-5)
    # a new constraint operator is a new key; the cache stays bounded
    for _ in range(ttr._REUSE_CP_CACHE_MAX + 2):
        ttr.feti_prepare_reuse_cp(qp.replace(BE=Dense.create(qp.BE.a.clone())))
    assert len(ttr._REUSE_CP_CACHE) == ttr._REUSE_CP_CACHE_MAX
    ttr.feti_prepare_reuse_cp_reset()
    assert len(ttr._REUSE_CP_CACHE) == 0


# -- the row transforms on the FETI ex1 QP, against the JAX package --------------


@pytest.fixture(scope="module")
def ex1_qp():
    """The decomposed ex1 QP: 2 Dirichlet rows and 3 gluing rows."""
    opts = dict(gluing="nonred")
    qp, *_ = tsolve.assemble_qp(tprob.build_feti_ex1(4, 7), tsolve.FetiOptions(**opts),
                                device="cpu")
    jqp, *_ = jsolve.assemble_qp(jex1.build(4, 7), jsolve.FetiOptions(**opts))
    return qp, jqp


def _same_rows(op, jop):
    a, b = to_coo(op), jax_to_coo(jop)
    for x, y in zip(a[:3], b[:3]):
        np.testing.assert_allclose(x, y, rtol=0, atol=1e-14)
    assert a[3] == tuple(b[3])


def test_split_be(ex1_qp):
    qp, jqp = ex1_qp
    (child, post), (jchild, jpost) = ttr.split_be(qp), jtr.split_be(jqp)
    _same_rows(child.BE, jchild.BE)
    np.testing.assert_array_equal(child.cE.numpy(), np.asarray(jchild.cE))
    lam = np.arange(5.0)
    jsol = jpost(jtr.Solution(x=jqp.b, lambda_E=jnp.asarray(lam)))
    np.testing.assert_array_equal(post(Solution(x=qp.b, lambda_E=_t(lam))).lambda_E.numpy(),
                                  np.asarray(jsol.lambda_E))
    moved = from_arrays(jsol, "cpu")  # interop of a Solution
    assert moved.lambda_I is None
    np.testing.assert_array_equal(moved.lambda_E.numpy(), np.asarray(jsol.lambda_E))


def test_remove_gluing_of_dirichlet_dofs(ex1_qp):
    qp, jqp = ex1_qp
    dofs = [0, 1, 7, 8]  # the first subdomain's two ends and their copies
    (child, post), (jchild, jpost) = (ttr.remove_gluing_of_dirichlet_dofs(qp, dofs),
                                      jtr.remove_gluing_of_dirichlet_dofs(jqp, dofs))
    _same_rows(child.BE, jchild.BE)
    lam = np.arange(1.0, child.BE.shape[0] + 1)
    got = post(Solution(x=qp.b, lambda_E=_t(lam))).lambda_E.numpy()
    want = np.asarray(jpost(jtr.Solution(x=jqp.b, lambda_E=jnp.asarray(lam))).lambda_E)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (qp.BE.shape[0],) and (got == 0).sum() == qp.BE.shape[0] - len(lam)


@pytest.mark.parametrize("scale_E", ["rows_norm_2", "ddm_multiplicity"])
def test_scale(ex1_qp, scale_E):
    qp, jqp = ex1_qp
    (child, post), (jchild, jpost) = ttr.scale(qp, scale_E=scale_E), jtr.scale(jqp, scale_E=scale_E)
    _same_rows(child.BE, jchild.BE)
    np.testing.assert_allclose(child.cE.numpy(), np.asarray(jchild.cE), rtol=0, atol=1e-14)
    lam = np.linspace(-1, 1, 5)
    np.testing.assert_allclose(post(Solution(x=qp.b, lambda_E=_t(lam))).lambda_E.numpy(),
                               np.asarray(jpost(jtr.Solution(x=jqp.b, lambda_E=jnp.asarray(lam)))
                                          .lambda_E), rtol=0, atol=1e-14)
    with pytest.raises(ValueError):
        ttr.scale(qp, scale_E="max")


def test_freeze_ineq_and_normalize():
    rng = np.random.default_rng(5)
    n = 12
    A = 2 * np.eye(n) - np.eye(n, k=1) - np.eye(n, k=-1)
    b, BE, BI = rng.normal(size=n), rng.normal(size=(2, n)), rng.normal(size=(3, n))
    kw = dict(BE=BE, cE=np.ones(2), BI=BI, cI=np.full(3, 0.5), lb=-np.ones(n))
    qp = tpt.QP.create(A, b, device="cpu", **kw)
    jqp = jpt.QP.create(A, b, **kw)
    child, post = ttr.freeze_ineq(qp)
    assert child.BE.shape == (5, n) and child.BI is None
    np.testing.assert_array_equal(child.cE.numpy(), [1, 1, 0.5, 0.5, 0.5])
    sol = post(Solution(x=qp.b, lambda_E=_t(np.arange(5.0))))
    np.testing.assert_array_equal(sol.lambda_E.numpy(), [0, 1])
    np.testing.assert_array_equal(sol.lambda_I.numpy(), [2, 3, 4])
    for name in ("normalize_objective", "normalize_hessian"):
        (c, p), (jc, jp) = getattr(ttr, name)(qp), getattr(jtr, name)(jqp)
        np.testing.assert_allclose(c.b.numpy(), np.asarray(jc.b), rtol=1e-12)
        np.testing.assert_allclose(c.box.lb.numpy(), np.asarray(jc.box.lb), rtol=1e-12)
        s = Solution(x=qp.b, lambda_E=_t(np.ones(2)))
        js = jtr.Solution(x=jqp.b, lambda_E=jnp.ones(2))
        np.testing.assert_allclose(p(s).x.numpy(), np.asarray(jp(js).x), rtol=1e-12)
        np.testing.assert_allclose(p(s).lambda_E.numpy(), np.asarray(jp(js).lambda_E),
                                   rtol=1e-12)


@pytest.mark.parametrize("kw,atol", [
    (dict(normalize="hessian", orth_eq="gs"), 1e-5),
    (dict(dual=False, project=False, penalty=1e8), 1e-4),
], ids=["normalize_orth_dual_project", "penalty"])
def test_all_in_one_pipelines_match_kkt(kw, atol):
    """all_in_one on the singular QP of feti_prepare: normalize ->
    orthonormalize -> dualize -> project, and the penalty tail (A + rho
    BE'BE is definite here), against the KKT solution."""
    qp, kkt, b = _singular_eq_qp()
    child, post = ttr.all_in_one(qp.replace(R=None) if "penalty" in kw else qp, **kw)
    res = tpt.solve(child, qps_type="cg", tol=Tolerances(rtol=1e-12)) if "penalty" in kw \
        else tpt.solve(child)
    np.testing.assert_allclose(post(Solution(x=res.x)).x.numpy(), kkt(b), atol=atol)
