"""permon_tpu_torch gather kernel (core/sell.gather_apply) against the JAX
package: the plain PyTorch version must equal the JAX table path and the
interpreted Pallas SELL gather kernel BITWISE, in f32 and f64, for mv and
rmv with an overflow COO present.  On the CPU no kernel launches; the
CUDA kernel itself is compared with the plain version on the card in
tests/test_torch_cuda.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from examples.feti_large import build_sparse as jax_build_sparse
from permon_tpu.core.extension import SubdomainExtension as JaxExtension
from permon_tpu.feti.assembly import build_gluing as jax_build_gluing
from permon_tpu_torch.core.extension import GatherTable
from permon_tpu_torch.core.sell import gather_apply, gather_apply_plain
from permon_tpu_torch.interop import from_arrays

torch.set_num_threads(2)


def _gluing_ext(cells=(6, 6, 6), grid=(2, 2, 2)):
    """The real B of a small nonredundant-gluing problem: corner copies
    have up to 7 rows, so the B' table has an overflow COO."""
    prob = jax_build_sparse(cells, grid)
    r, c, v, m = jax_build_gluing(prob.l2g, "nonred", True)
    return JaxExtension.from_coo(r, c, v, m=m, ns=prob.ns, nl=prob.nl).with_gather_apply()


def _random_ext(seed=0, ns=5, nl=40, m=60, nnz=300):
    rng = np.random.RandomState(seed)
    B = JaxExtension.from_coo(rng.randint(0, m, nnz), rng.randint(0, ns * nl, nnz),
                              rng.randn(nnz), m=m, ns=ns, nl=nl)
    return B.with_gather_apply()


@pytest.fixture(scope="module")
def exts():
    return {"gluing": _gluing_ext(), "random": _random_ext()}


def _vectors(B, dtype, seed):
    rng = np.random.RandomState(seed)
    u = rng.randn(B.ns * B.nl).astype(dtype)
    lam = rng.randn(B.m_dual).astype(dtype)
    return u, lam


@pytest.mark.parametrize("kind", ["gluing", "random"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_plain_equals_jax_table_path(exts, kind, dtype):
    B = exts[kind]
    assert B.gBt_ov_cols is not None  # the overflow COO is exercised
    Bt = from_arrays(B, "cpu")
    u, lam = _vectors(B, dtype, seed=1)
    gather_apply.launches = 0
    mv = Bt.mv(torch.as_tensor(u))
    rmv = Bt.rmv(torch.as_tensor(lam))
    np.testing.assert_array_equal(mv.numpy(), np.asarray(B.mv(jnp.asarray(u))))
    np.testing.assert_array_equal(rmv.numpy(), np.asarray(B.rmv(jnp.asarray(lam))))
    assert mv.dtype == torch.float64  # promotion with the f64 table values
    assert gather_apply.launches == 0  # CPU tensors never launch the kernel


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_plain_equals_jax_interpreted_kernel(exts, dtype):
    """The JAX production path on a TPU (SELL plans through the Pallas
    kernel, here interpreted) against the port's plain version."""
    B = exts["gluing"]
    Bs = B.with_sell_gather()
    Bs = Bs.replace(sB=Bs.sB.replace(use_pallas=True, interpret=True),
                    sBt=Bs.sBt.replace(use_pallas=True, interpret=True))
    Bt = from_arrays(B, "cpu")
    u, lam = _vectors(B, dtype, seed=2)
    np.testing.assert_array_equal(Bt.mv(torch.as_tensor(u)).numpy(),
                                  np.asarray(Bs.mv(jnp.asarray(u))))
    np.testing.assert_array_equal(Bt.rmv(torch.as_tensor(lam)).numpy(),
                                  np.asarray(Bs.rmv(jnp.asarray(lam))))


def test_port_tables_equal_jax_tables(exts):
    """with_gather_apply of the port builds the same plane-major tables."""
    from permon_tpu_torch.core.extension import SubdomainExtension

    B = exts["gluing"]
    P = SubdomainExtension(rows=np.asarray(B.rows), cols=np.asarray(B.cols),
                           vals=np.asarray(B.vals), m_dual=B.m_dual, ns=B.ns,
                           nl=B.nl).with_gather_apply("cpu")
    np.testing.assert_array_equal(P.gB.idx.numpy(), np.asarray(B.gB_cols))
    np.testing.assert_array_equal(P.gB.vals.numpy(), np.asarray(B.gB_vals))
    np.testing.assert_array_equal(P.gBt.idx.numpy(), np.asarray(B.gBt_rows))
    np.testing.assert_array_equal(P.gBt.vals.numpy(), np.asarray(B.gBt_vals))
    Q = from_arrays(B, "cpu")
    for f in ("ov_tgt", "ov_idx", "ov_vals"):
        np.testing.assert_array_equal(getattr(P.gBt, f).numpy(), getattr(Q.gBt, f).numpy())


def test_accumulate_mode_adds_in_entry_order():
    """The overflow: target t adds its planes onto the table's sum of row
    ov_tgt[t], after the table planes, in plane (= entry) order; the plain
    accumulate mode itself adds onto out[tgt[r]] in place."""
    x = torch.tensor([1.0, 2.0, 4.0], dtype=torch.float64)
    idx = torch.tensor([[0, 2], [1, 3]], dtype=torch.int32)  # 3 = pad
    vals = torch.tensor([[1.0, 10.0], [100.0, 5.0]], dtype=torch.float64)
    out = torch.tensor([0.5, 0.25, 0.125], dtype=torch.float64)
    gather_apply_plain(idx, vals, x, out=out, tgt=torch.tensor([2, 0], dtype=torch.int32))
    np.testing.assert_array_equal(out.numpy(), [0.5 + 40.0 + 0.0, 0.25, 0.125 + 1.0 + 200.0])
    # entry order decides the rounding: 1 + 1e16 - 1e16 = 0, not 1
    tab = GatherTable.from_host(np.array([[0, 1, 3]]), np.ones((1, 3)), "cpu", n_src=3,
                                overflow=(np.array([2, 0, 0]), np.array([2, 1, 2]),
                                          np.array([7.0, 1e16, -1e16 / 4.0])))
    got = gather_apply(tab, x).numpy()
    np.testing.assert_array_equal(got, [(1.0 + 2e16) - 1e16, 2.0, 0.0 + 28.0])
    np.testing.assert_array_equal(tab.ov_tgt.numpy(), [0, 2])


@pytest.mark.parametrize("bad", ["idx_dtype", "shape", "vals_dtype", "x_dim", "ov_dtype"])
def test_wrapper_rejects_bad_inputs(bad):
    idx = torch.zeros((2, 4), dtype=torch.int32)
    vals = torch.ones((2, 4), dtype=torch.float64)
    x = torch.ones(3, dtype=torch.float64)
    kw = {}
    if bad == "idx_dtype":
        idx = idx.long()
    elif bad == "shape":
        vals = vals[:, :3]
    elif bad == "vals_dtype":
        vals = vals.half()
    elif bad == "x_dim":
        x = x[:, None]
    elif bad == "ov_dtype":  # overflow values of another dtype than the table's
        kw = dict(ov_tgt=torch.zeros(1, dtype=torch.int32),
                  ov_idx=torch.zeros((1, 1), dtype=torch.int32),
                  ov_vals=torch.ones((1, 1), dtype=torch.float32))
    with pytest.raises((TypeError, ValueError)):
        gather_apply(GatherTable(idx=idx, vals=vals, n_src=3, **kw), x)


def test_gather_table_validates_indices_and_length():
    with pytest.raises(ValueError, match="outside"):
        GatherTable.from_host(np.array([[0, 5]]), np.ones((1, 2)), "cpu", n_src=4)
    tab = GatherTable.from_host(np.array([[0, 4]]), np.ones((1, 2)), "cpu", n_src=4)
    np.testing.assert_array_equal(tab.apply(torch.arange(1.0, 5.0, dtype=torch.float64)).numpy(),
                                  [1.0, 0.0])
    with pytest.raises(ValueError, match="vector of length 4"):
        tab.apply(torch.ones(5, dtype=torch.float64))
