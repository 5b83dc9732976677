"""The leaf path of permon_tpu_torch (``FetiOptions(throughput=True)``:
feti/leaf.py, feti/leafqp.py, explicit K+, dense extension blocks) against
the JAX package, on the CPU.

Tolerances, per check:

- ``LeafDualSpace``: partners and weights array-equal to the JAX package's
  (its native builder or its Python fallback); lift / restrict / combine /
  dot on the same inputs to 1e-14 (restrict, combine: the same additions
  in the same order; dot: one reduction over the leaves, whose order may
  differ);
- the leaf F apply against the row-space F = B K+ B' of the port, and
  against the JAX package's leaf apply on the same blocks and inverses
  (interop), to 1e-12 relative;
- ``leaf_cg`` with the leaf projector: the JAX package's count, x to 1e-10;
- solves: leaf counts equal to the port's row-path counts and to the JAX
  package's leaf counts on the same problem (tests/test_leafqp.py,
  tests/test_feti.py:313-325), x_global to 1e-9 of the row path (1e-10 for
  contact, as the JAX tests hold theirs);
- precision (tests/test_precision.py:96-160): f64 leaf contact at 34 / 91
  outer / inner; 'mixed' reason 2 within 38 +-2 / 89 +-4 with f32 leaf
  state and f64 dots, x within 1e-4 of f64 and the obstacle kept to 5e-4;
  linear 'mixed' within 4 iterations of f64, x within 5e-4.
"""

import numpy as np
import pytest
import torch

import examples.feti_contact as jcontact
import examples.feti_ex1 as jex1
import examples.feti_ex71 as jex71
import permon_tpu.feti.leaf as jleaf
import permon_tpu.feti.solve as jsolve
from permon_tpu.core.convergence import Tolerances as JaxTolerances
from permon_tpu.feti.solve import FetiOptions as JaxFetiOptions

import permon_tpu_torch.problems as tprob
from permon_tpu_torch.core.convergence import Tolerances
from permon_tpu_torch.core.linop import Product, Transpose
from permon_tpu_torch.feti.leaf import LeafDualOperator, LeafDualSpace, LeafProjector, leaf_cg
from permon_tpu_torch.feti.leafqp import ScaledLeafOperator
from permon_tpu_torch.feti.solve import (FetiOptions, FetiSolver, assemble_qp, feti_solve,
                                         make_blockdiag_kplus, prepare_contact_children)
from permon_tpu_torch.interop import from_arrays
from permon_tpu_torch.qp.transforms import dualize, homogenize_eq

torch.set_num_threads(2)


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.fixture(scope="module", params=["nonred", "full"])
def spaces(request):
    """(port assembled qp, port K+, JAX qp, JAX K+) of ex1 on 4 subdomains."""
    gluing = request.param
    qp, K, fixed, nb = assemble_qp(tprob.build_feti_ex1(4, 7), FetiOptions(gluing=gluing),
                                   device="cpu")
    jprob = jex1.build(4, 7)
    jqp, jK, jfixed, jnb = jsolve.assemble_qp(jprob, JaxFetiOptions(gluing=gluing))
    return (qp, make_blockdiag_kplus(K, fixed, tprob.build_feti_ex1(4, 7), nb, explicit=True),
            jqp, jsolve.make_blockdiag_kplus(jK, jfixed, jprob, jnb, explicit=True))


def test_space_equals_jax(spaces):
    qp, _, jqp, _ = spaces
    sp = LeafDualSpace.build(qp.BE.with_dense_blocks())
    jsp = jleaf.LeafDualSpace.build(jqp.BE.with_dense_blocks())
    np.testing.assert_array_equal(sp.partners, np.asarray(jsp.partners))
    np.testing.assert_array_equal(sp.weights.numpy(), np.asarray(jsp.weights))
    np.testing.assert_array_equal(sp.rows, np.asarray(jsp.rows))
    rng = np.random.default_rng(0)
    m = qp.BE.m_dual
    lam, mu = rng.standard_normal(m), rng.standard_normal(m)
    contrib = rng.standard_normal(sp.rows.shape)
    Lam = sp.lift(_t(lam))
    jLam = jsp.lift(lam)
    np.testing.assert_array_equal(Lam.numpy(), np.asarray(jLam))
    np.testing.assert_allclose(sp.restrict(Lam).numpy(), np.asarray(jsp.restrict(jLam)),
                               rtol=0, atol=1e-14)
    np.testing.assert_allclose(sp.restrict(Lam).numpy(), lam, rtol=0, atol=1e-14)
    np.testing.assert_allclose(sp.combine(_t(contrib)).numpy(),
                               np.asarray(jsp.combine(contrib)), rtol=0, atol=1e-14)
    np.testing.assert_allclose(float(sp.dot(Lam, sp.lift(_t(mu)))),
                               float(jsp.dot(jLam, jsp.lift(mu))), rtol=0, atol=1e-14)
    # the interop twin of the JAX space gives the same tables
    tw = from_arrays(jsp, device="cpu")
    for name in ("comb", "restr", "lift_tab"):
        assert torch.equal(getattr(tw, name).idx, getattr(sp, name).idx)
        assert torch.equal(getattr(tw, name).vals, getattr(sp, name).vals)


def test_partners_of_a_random_extension():
    """Rows of up to 4 leaves in any order, zero values and pad slots: the
    vectorized build against the JAX package's."""
    from permon_tpu.core.extension import SubdomainExtension as JaxExtension

    from permon_tpu_torch.core.extension import SubdomainExtension

    rng = np.random.default_rng(5)
    ns, nl, m, nnz = 6, 5, 17, 50
    rows, cols = rng.integers(0, m, nnz), rng.integers(0, ns * nl, nnz)
    vals = rng.standard_normal(nnz)
    vals[::7] = 0.0
    B = SubdomainExtension.from_coo(rows, cols, vals, m=m, ns=ns, nl=nl)
    jB = JaxExtension.from_coo(rows, cols, vals, m=m, ns=ns, nl=nl)
    sp = LeafDualSpace.build(B, device="cpu")
    jsp = jleaf.LeafDualSpace.build(jB)
    assert sp.partners.shape[0] >= 2
    np.testing.assert_array_equal(sp.partners, np.asarray(jsp.partners))
    np.testing.assert_array_equal(sp.weights.numpy(), np.asarray(jsp.weights))
    contrib = rng.standard_normal(sp.rows.shape)
    np.testing.assert_allclose(sp.combine(_t(contrib)).numpy(), np.asarray(jsp.combine(contrib)),
                               rtol=0, atol=1e-14)
    # the dense blocks: one value per (subdomain, slot)
    np.testing.assert_array_equal(B.with_dense_blocks(device="cpu").blk.numpy(),
                                  np.asarray(jB.with_dense_blocks().blk))


def test_leaf_apply_matches_row_and_jax(spaces):
    qp, kplus, jqp, jkplus = spaces
    op = LeafDualOperator.create(qp.BE, kplus)
    F = Product((qp.BE, kplus, Transpose(qp.BE)))
    lam = _t(np.random.default_rng(3).standard_normal(qp.BE.m_dual))
    out = op.space.restrict(op.apply(op.space.lift(lam)))
    ref = F.mv(lam)
    scale = float(ref.abs().max())
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0, atol=1e-12 * scale)
    # the JAX package's leaf operator and its port through interop
    jop = jleaf.LeafDualOperator.create(jqp.BE, jkplus)
    top = from_arrays(jop, device="cpu")
    Lam = np.random.default_rng(4).standard_normal(top.space.rows.shape)
    Lam = np.asarray(jop.space.lift(jop.space.restrict(Lam)))  # a consistent array
    np.testing.assert_allclose(top.apply(_t(Lam)).numpy(), np.asarray(jop.apply(Lam)),
                               rtol=0, atol=1e-12 * scale)


def test_leaf_cg_matches_jax():
    """Projected leaf CG on ex71 (6, 6, 6) on (2, 2, 2), nonred (4 floating
    subdomains): the JAX package's count and x (ex1's projected rhs is
    round-off: its P is 0 to round-off)."""
    prob = tprob.build_ex71((6, 6, 6), (2, 2, 2))
    qp, K, fixed, nb = assemble_qp(prob, FetiOptions(gluing="nonred"), device="cpu")
    kplus = make_blockdiag_kplus(K, fixed, prob, nb)
    dual, _ = dualize(qp, kplus=kplus)
    cur, _ = homogenize_eq(dual)
    op = LeafDualOperator.create(qp.BE, kplus)
    P = LeafProjector.create(op.space, dual.BE)
    res = leaf_cg(op, P(op.space.lift(cur.b)), tol=Tolerances(), project=P)

    jprob = jex71.build((6, 6, 6), (2, 2, 2))
    jqp, jK, jfixed, jnb = jsolve.assemble_qp(jprob, JaxFetiOptions(gluing="nonred"))
    jkplus = jsolve.make_blockdiag_kplus(jK, jfixed, jprob, jnb)
    from permon_tpu.qp import transforms as jtr

    jdual, _ = jtr.dualize(jqp, kplus=jkplus)
    jcur, _ = jtr.homogenize_eq(jdual)
    jop = jleaf.LeafDualOperator.create(jqp.BE, jkplus)
    jP = jleaf.LeafProjector.create(jop.space, jdual.BE)
    jres = jleaf.leaf_cg(jop, jP(jop.space.lift(jcur.b)), tol=JaxTolerances(), project=jP)
    assert (res.iterations, res.reason) == (int(jres.iterations), int(jres.reason))
    assert res.nmv == int(jres.nmv)
    assert res.iterations > 5
    np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x), rtol=0,
                               atol=1e-10 * float(np.abs(np.asarray(jres.x)).max()))


def test_throughput_ex1():
    """tests/test_feti.py:313-325: the row path's count and x_global to 1e-9
    (the row path is held to the JAX package's ex1 in
    tests/test_torch_feti_dense.py)."""
    prob = tprob.build_feti_ex1(4, 7)
    row = feti_solve(prob, FetiOptions(), device="cpu")
    thr = feti_solve(prob, FetiOptions(throughput=True), device="cpu")
    assert thr.result.iterations == row.result.iterations == 1
    np.testing.assert_allclose(thr.x_global, row.x_global, rtol=0, atol=1e-9)
    assert thr.qp.BE.blk is not None and thr.qp.BE.blk.shape[1:] == (thr.qp.BE.rows.shape[1],
                                                                   prob.nl)


@pytest.fixture(scope="module")
def contact():
    return tprob.build_feti_contact(4, 25), jcontact.build(4, 25)


def _counts(r):
    return (int(r.iterations), int(r.inner_iterations))


@pytest.mark.parametrize("project", [True, False], ids=["projected", "project0"])
def test_contact_leaf_counts(contact, project):
    """tests/test_leafqp.py: leaf SMALXE / MPRGP counts equal to the row
    path's, in both packages."""
    (prob, BI, cI, lb), (jprob, jBI, jcI, _) = contact
    base = dict(gluing="nonred", project=project)
    row = feti_solve(prob, FetiOptions(**base), BI=BI, cI=cI, device="cpu")
    leaf = feti_solve(prob, FetiOptions(**base, throughput=True), BI=BI, cI=cI, device="cpu")
    jleafr = jsolve.feti_solve(jprob, JaxFetiOptions(**base, throughput=True), BI=jBI, cI=jcI)
    assert _counts(leaf.result) == _counts(row.result) == _counts(jleafr.result)
    np.testing.assert_allclose(leaf.x_global, row.x_global, rtol=0, atol=1e-10)
    np.testing.assert_allclose(leaf.x_global, jleafr.x_global, rtol=0, atol=1e-9)
    assert (leaf.x_global - lb).min() > -5e-5


def test_lumped_leaf_cg():
    """tests/test_leafqp.py::TestLeafLumpedParity: projected CG with the
    lumped PC through the leaf path: the row path's and the JAX package's
    count."""
    prob = tprob.build_ex71((5, 5, 5), (1, 2, 3))
    tol = Tolerances(rtol=1e-10)
    row = feti_solve(prob, FetiOptions(pc_dual="lumped"), tol=tol, device="cpu")
    leaf = feti_solve(prob, FetiOptions(pc_dual="lumped", throughput=True), tol=tol, device="cpu")
    jl = jsolve.feti_solve(jex71.build((5, 5, 5), (1, 2, 3)),
                           JaxFetiOptions(pc_dual="lumped", throughput=True),
                           tol=JaxTolerances(rtol=1e-10))
    assert leaf.result.iterations == row.result.iterations == int(jl.result.iterations)
    np.testing.assert_allclose(leaf.x_global, row.x_global, rtol=0, atol=1e-8)
    np.testing.assert_allclose(leaf.x_global, jl.x_global, rtol=0, atol=1e-8)


def test_contact_leaf_precision(contact):
    """tests/test_precision.py:96-136: f64 leaf contact 34 / 91; 'mixed' in
    its band with f32 leaf state and f64 dots; the FetiSolver re-solve on
    the cached leaf operators gives the same."""
    (prob, BI, cI, lb), _ = contact
    tol = Tolerances(rtol=1e-6)
    r64 = feti_solve(prob, FetiOptions(gluing="nonred", throughput=True), BI=BI, cI=cI, tol=tol,
                     device="cpu")
    solver = FetiSolver(prob, FetiOptions(gluing="nonred", throughput=True, precision="mixed"),
                        BI=BI, cI=cI, device="cpu")
    rmx = solver.solve(tol=tol)
    assert (r64.result.reason, rmx.result.reason) == (2, 2)
    assert _counts(r64.result) == (34, 91)
    itmx, inmx = _counts(rmx.result)
    assert abs(itmx - 38) <= 2 and abs(inmx - 89) <= 4, (itmx, inmx)
    np.testing.assert_allclose(rmx.x_global, r64.x_global, rtol=0, atol=1e-4)
    assert (rmx.x_global >= lb - 5e-4).all()
    again = solver.solve(b_loc=prob.b_loc, tol=tol)
    assert _counts(again.result) == (itmx, inmx)
    np.testing.assert_array_equal(again.x_global, rmx.x_global)

    leaf, sm, sls = prepare_contact_children(
        prob, FetiOptions(gluing="nonred", throughput=True, precision="mixed"), BI, cI,
        device="cpu")
    assert sls is not None  # the leaf path was taken
    assert leaf.b.dtype == torch.float32 and leaf.dots_dtype == "float64"
    assert torch.as_tensor(sm.maxeig).dtype == torch.float64  # estimates on f64 operators
    A = leaf.A.ops[1]  # P A P: the f32 leaf operator
    assert isinstance(A, ScaledLeafOperator)
    assert A.op.blk.dtype == A.op.invs.dtype == A.sp.s.dtype == torch.float32
    assert A.op.space.comb.vals.dtype == A.op.space.restr.vals.dtype == torch.float32
    assert leaf.BE.Gl.dtype == torch.float32 and leaf.pf.G.Gl.dtype == torch.float64
    assert A.op.space.comb.idx.dtype == torch.int32


def test_linear_leaf_mixed():
    """tests/test_precision.py:138-160: linear 'mixed' within 4 iterations
    of f64, x within 5e-4."""
    prob = tprob.build_ex71((8, 8, 8), (2, 2, 2))
    tol = Tolerances(rtol=1e-6)
    r64 = feti_solve(prob, FetiOptions(gluing="nonred", throughput=True), tol=tol, device="cpu")
    row = feti_solve(prob, FetiOptions(gluing="nonred"), tol=tol, device="cpu")
    rmx = feti_solve(prob, FetiOptions(gluing="nonred", throughput=True, precision="mixed"),
                     tol=tol, device="cpu")
    assert r64.result.iterations == row.result.iterations
    assert rmx.result.reason == 2
    assert abs(rmx.result.iterations - r64.result.iterations) <= 4
    np.testing.assert_allclose(rmx.x_global, r64.x_global, rtol=0, atol=5e-4)


def test_leaf_rejects_tf32_on_cuda(monkeypatch):
    """The leaf products must run at full precision: under TF32 the leaf
    operator raises on a CUDA device (checked here without one)."""
    from permon_tpu_torch.feti import leaf as tleaf

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="full-precision"):
        tleaf.check_full_precision(torch.device("cuda"))
    tleaf.check_full_precision(torch.device("cpu"))  # the CPU never uses TF32
