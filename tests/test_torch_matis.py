"""The MATIS entry of permon_tpu_torch (``feti/matis.py``), the dense
operators of the path (``core/blockdiag.py``, ``core/gluing.py``, the
extension's ``todense`` / ``vstack``) and the numpy copies of the example
builders, against the JAX package and tests/test_matis.py, on the CPU.

Tolerances, per check:

- builders (``build_feti_ex1``, ``build_ex71`` for each pde, dimension and
  Dirichlet diagonal, ``build_feti_contact``) and the host helpers
  (``matis_ctx``, ``decompose_vec``, ``assemble_vec``): np.array_equal with
  equal dtypes;
- the operators' mv / rmv / todense against the JAX package's on the same
  arrays: 1e-14 (the gather tables add each row's entries in the JAX
  package's entry order); MatIS against the assembled matrix: 1e-13;
- feti_problem_from_matis -> feti_solve: the direct solve of
  tests/test_matis.py to 1e-8.  ex71 through the MATIS entry against the
  FetiProblem entry and the JAX package's solve is
  tests/test_torch_feti_dense.py::test_ex71_through_matis_matches_problem_entry_and_jax,
  beside the JAX solve of the same problem it shares.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import examples.feti_contact as jcontact
import examples.feti_ex1 as jex1
import examples.feti_ex71 as jex71
import permon_tpu.core.blockdiag as jbd
import permon_tpu.core.gluing as jgl
import permon_tpu.feti.matis as jmatis
from permon_tpu.core.extension import SubdomainExtension as JaxExtension

import permon_tpu_torch.feti.matis as tmatis
import permon_tpu_torch.problems as tprob
from permon_tpu_torch.core.blockdiag import BlockColumns, BlockDiagDense
from permon_tpu_torch.core.extension import SubdomainExtension
from permon_tpu_torch.core.gluing import Gluing
from permon_tpu_torch.feti.assembly import build_gluing
from permon_tpu_torch.feti.solve import FetiOptions, feti_solve
from permon_tpu_torch.interop import from_arrays
from permon_tpu_torch.qp.qp import QP
from permon_tpu_torch.qp.transforms import Solution

torch.set_num_threads(2)

CLOSE = dict(rtol=0, atol=1e-14)


def _same_problem(prob, jprob):
    for f in dataclasses.fields(jprob):
        a, b = getattr(prob, f.name), getattr(jprob, f.name)
        if a is None or b is None or isinstance(a, str):
            assert a == b
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(a, b), f.name


# -- builders -----------------------------------------------------------------------


EX71_CASES = [
    dict(), dict(dirichlet_diag="copy"), dict(dirichlet_diag="owner"),
    dict(cells=(8, 8), grid=(2, 2)), dict(cells=(12,), grid=(3,)),
    dict(cells=(6, 4), grid=(3, 1), pde="elasticity"),
    dict(cells=(5, 5, 5), grid=(2, 2, 1), pde="elasticity", dirichlet_diag="owner"),
    dict(cells=(8, 6, 4), grid=(7, 1, 1), pde="elasticity"),
    dict(cells=(7, 8, 9), grid=(2, 2, 2), dirichlet_diag="copy"),
]


@pytest.mark.parametrize("kw", EX71_CASES, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()) or "default")
def test_build_ex71_equal(kw):
    _same_problem(tprob.build_ex71(**kw), jex71.build(**kw))


@pytest.mark.parametrize("ns,ne", [(4, 7), (3, 5), (2100, 1)])
def test_build_feti_ex1_equal(ns, ne):
    _same_problem(tprob.build_feti_ex1(ns, ne), jex1.build(ns, ne))


def test_build_feti_contact_and_q1_poisson_equal():
    prob, BI, cI, lb = tprob.build_feti_contact(4, 25)
    jprob, jBI, jcI, jlb = jcontact.build(4, 25)
    _same_problem(prob, jprob)
    for f in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(BI, f), np.asarray(getattr(jBI, f)))
    np.testing.assert_array_equal(cI, jcI)
    np.testing.assert_array_equal(lb, jlb)
    for dim in (1, 2, 3):
        np.testing.assert_array_equal(tprob.q1_poisson_emat(dim), jex71.q1_poisson_emat(dim))
    np.testing.assert_array_equal(tprob.POISS_3D_EMAT, jex71.POISS_3D_EMAT)


# -- the operators of the dense path ------------------------------------------------


def test_blockdiag_operators_match_jax():
    rng = np.random.default_rng(0)
    K, R = rng.normal(size=(3, 5, 5)), rng.normal(size=(3, 5, 2))
    x, a = rng.normal(size=15), rng.normal(size=6)
    for T, J, fwd, back in ((BlockDiagDense, jbd.BlockDiagDense, x, x),
                            (BlockColumns, jbd.BlockColumns, a, x)):
        blocks = K if T is BlockDiagDense else R
        t, j = T(blocks=torch.as_tensor(blocks)), J(blocks=jnp.asarray(blocks))
        assert t.shape == j.shape
        np.testing.assert_allclose(t.mv(torch.as_tensor(fwd)).numpy(),
                                   np.asarray(j.mv(jnp.asarray(fwd))), **CLOSE)
        np.testing.assert_allclose(t.rmv(torch.as_tensor(back)).numpy(),
                                   np.asarray(j.rmv(jnp.asarray(back))), **CLOSE)
        np.testing.assert_array_equal(t.todense().numpy(), np.asarray(j.todense()))
        np.testing.assert_array_equal(from_arrays(j, "cpu").blocks.numpy(), blocks)
    np.testing.assert_array_equal(BlockDiagDense(blocks=torch.as_tensor(K)).diagonal().numpy(),
                                  np.asarray(jbd.BlockDiagDense(blocks=jnp.asarray(K)).diagonal()))


@pytest.mark.parametrize("gluing", ["nonred", "full", "orth"])
def test_gluing_operator_matches_jax(gluing):
    """Gluing over ex71's 2 x 2 x 2 decomposition (dofs with up to 8
    copies: B' rows past the two table slots go to the overflow planes)."""
    prob = tprob.build_ex71((5, 5, 5), (2, 2, 2))
    r, c, v, m = build_gluing(prob.l2g, gluing)
    n = prob.n_decomposed
    t = Gluing.from_coo(r, c, v, m, n, device="cpu")
    j = jgl.Gluing.from_coo(r, c, v, m, n)
    assert t.gBt.ov_tgt is not None  # corner dofs overflow
    rng = np.random.default_rng(1)
    u, lam = rng.normal(size=n), rng.normal(size=m)
    np.testing.assert_allclose(t.mv(torch.as_tensor(u)).numpy(), np.asarray(j.mv(jnp.asarray(u))),
                               **CLOSE)
    np.testing.assert_allclose(t.rmv(torch.as_tensor(lam)).numpy(),
                               np.asarray(j.rmv(jnp.asarray(lam))), **CLOSE)
    np.testing.assert_array_equal(t.todense().numpy(), np.asarray(j.todense()))
    moved = from_arrays(j, "cpu")
    np.testing.assert_array_equal(moved.mv(torch.as_tensor(u)).numpy(),
                                  t.mv(torch.as_tensor(u)).numpy())
    np.testing.assert_array_equal(t.with_kernel(False).rmv(torch.as_tensor(lam)).numpy(),
                                  t.rmv(torch.as_tensor(lam)).numpy())


def test_extension_todense_and_vstack_match_jax():
    prob, BI, cI, _ = tprob.build_feti_contact(3, 6)
    r, c, v, m = build_gluing(prob.l2g, "full")
    BE = SubdomainExtension.from_coo(r, c, v, m=m, ns=prob.ns, nl=prob.nl)
    jBE = JaxExtension.from_coo(r, c, v, m=m, ns=prob.ns, nl=prob.nl)
    jBI = JaxExtension.from_coo(*(np.asarray(a) for a in (
        BI.rows.reshape(-1), (np.arange(BI.ns)[:, None] * BI.nl + BI.cols).reshape(-1),
        BI.vals.reshape(-1))), m=BI.m_dual, ns=BI.ns, nl=BI.nl)
    np.testing.assert_array_equal(BE.todense().numpy(), np.asarray(jBE.todense()))
    st = SubdomainExtension.vstack((BE.with_gather_apply("cpu"), BI))
    jst = JaxExtension.vstack((jBE, jBI))
    np.testing.assert_array_equal(st.todense().numpy(), np.asarray(jst.todense()))
    x = np.random.default_rng(2).normal(size=st.shape[1])
    np.testing.assert_allclose(st.mv(torch.as_tensor(x)).numpy(),
                               np.asarray(jst.mv(jnp.asarray(x))), **CLOSE)


# -- MatIS (tests/test_matis.py) ----------------------------------------------------


def _two_subdomain_laplacian(ne=4):
    n_nodes, nl = 2 * ne + 1, ne + 1
    l2g = np.stack([np.arange(nl), np.arange(ne, n_nodes)])
    K = np.zeros((2, nl, nl))
    e = np.arange(ne)
    for a, c, val in ((0, 0, 1.0), (0, 1, -1.0), (1, 0, -1.0), (1, 1, 1.0)):
        K[:, e + a, e + c] += val
    K[0][0, :] = K[0][:, 0] = 0.0  # Dirichlet at global 0, in the Hessian
    K[0][0, 0] = 1.0
    return K, l2g, n_nodes


def test_matis_operator_matches_assembled_and_jax():
    K, l2g, ng = _two_subdomain_laplacian()
    A = tmatis.MatIS.create(K, l2g, ng, device="cpu")
    Ad = np.zeros((ng, ng))
    for s in range(2):
        Ad[np.ix_(l2g[s], l2g[s])] += K[s]
    x = np.linspace(0.0, 1.0, ng)
    np.testing.assert_allclose(A.mv(torch.as_tensor(x)).numpy(), Ad @ x, rtol=0, atol=1e-13)
    np.testing.assert_allclose(A.rmv(torch.as_tensor(x)).numpy(), Ad.T @ x, rtol=0, atol=1e-13)
    np.testing.assert_allclose(A.todense().numpy(), Ad, rtol=0, atol=1e-13)
    j = jmatis.MatIS.create(K, l2g, ng)
    np.testing.assert_allclose(A.mv(torch.as_tensor(x)).numpy(), np.asarray(j.mv(jnp.asarray(x))),
                               **CLOSE)
    np.testing.assert_array_equal(from_arrays(j, "cpu").mv(torch.as_tensor(x)).numpy(),
                                  A.with_kernel(False).mv(torch.as_tensor(x)).numpy())


def test_matis_padding_dofs_do_not_leak():
    K, l2g, ng = _two_subdomain_laplacian()
    nl = l2g.shape[1]
    Kp = np.zeros((2, nl + 1, nl + 1))
    Kp[:, :nl, :nl] = K
    Kp[:, nl, nl] = 1.0
    l2gp = np.concatenate([l2g, -np.ones((2, 1), dtype=np.int64)], axis=1)
    x = torch.as_tensor(np.sin(np.arange(ng, dtype=float)))
    np.testing.assert_allclose(tmatis.MatIS.create(Kp, l2gp, ng, device="cpu").mv(x).numpy(),
                               tmatis.MatIS.create(K, l2g, ng, device="cpu").mv(x).numpy(),
                               **CLOSE)


def test_matis_ctx_and_vectors_equal_jax():
    prob = tprob.build_ex71((5, 5, 5), (2, 2, 1))
    ctx, jctx = tmatis.matis_ctx(prob.l2g), jmatis.matis_ctx(prob.l2g)
    for f in ("multiplicity", "i2g", "interior", "interface_masks"):
        np.testing.assert_array_equal(getattr(ctx, f), getattr(jctx, f))
    v = np.arange(1.0, prob.n_global + 1)
    for scale in (True, False):
        loc = tmatis.decompose_vec(v, prob.l2g, ctx.multiplicity, scale=scale)
        np.testing.assert_array_equal(loc, jmatis.decompose_vec(v, prob.l2g, ctx.multiplicity,
                                                                scale=scale))
        for average in (True, False):
            np.testing.assert_array_equal(
                tmatis.assemble_vec(loc, prob.l2g, prob.n_global, average=average),
                jmatis.assemble_vec(loc, prob.l2g, prob.n_global, average=average))
    loc = tmatis.decompose_vec(v, prob.l2g, ctx.multiplicity, scale=True)
    np.testing.assert_allclose(tmatis.assemble_vec(loc, prob.l2g, prob.n_global, average=False),
                               v, rtol=1e-15)


def test_matis_to_blockdiag_rhs_x0_and_check():
    K, l2g, ng = _two_subdomain_laplacian()
    A = tmatis.MatIS.create(K, l2g, ng, device="cpu")
    x0 = np.arange(ng, dtype=float)
    qp = QP(A=A, b=torch.ones(ng, dtype=torch.float64), x0=torch.as_tensor(x0))
    child, post, ctx = tmatis.matis_to_blockdiag(qp, check_residual=True)
    assert isinstance(child.A, BlockDiagDense)
    b_loc = child.b.numpy().reshape(l2g.shape)
    iface = int(ctx.i2g[0])
    for s in range(2):
        assert b_loc[s][np.flatnonzero(l2g[s] == iface)[0]] == 0.5
        np.testing.assert_array_equal(child.x0.numpy().reshape(l2g.shape)[s], x0[l2g[s]])
    with pytest.raises(RuntimeError, match="reassembly check"):
        post(Solution(x=torch.zeros(child.b.shape[0], dtype=torch.float64)))
    with pytest.raises(TypeError):
        tmatis.matis_to_blockdiag(QP(A=BlockDiagDense(blocks=torch.as_tensor(K)), b=qp.b))


def test_decomposed_solve_matches_global():
    K, l2g, ng = _two_subdomain_laplacian()
    A = tmatis.MatIS.create(K, l2g, ng, device="cpu")
    b = np.ones(ng)
    b[0] = 0.0
    prob, post, _ = tmatis.feti_problem_from_matis(A, b)
    res = feti_solve(prob, FetiOptions(gluing="nonred"), device="cpu")
    np.testing.assert_allclose(post(Solution(x=res.u_decomposed)).x.numpy(), res.x_global,
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(res.x_global, np.linalg.solve(A.todense().numpy(), b), atol=1e-8)
