"""permon_tpu_torch launch plans and the host-side layout data of the
redesigned kernels (core/sell.py, core/extension.py), on the CPU at small
shapes with inputs from a numpy seed:

- the overflow marker of a gather table against plain numpy, and the padded
  plane strides against the unpadded table;
- ``GatherTable.apply`` with the merged overflow against the JAX package's
  ``SubdomainExtension.mv`` / ``rmv`` on the same gluing (bitwise: both add
  the same planes in the same order), and ``SEll.mv`` against the JAX
  ``SEll`` and scipy to 1e-14 of max |y| in f64 (rows of at most 5
  products, summed in two different orders);
- the launch plan: built once per operator object, built anew after
  ``.replace``, and the per-call check of ``x`` that still raises on a wrong
  length, dtype, layout or device once a plan exists;
- the ctypes argument structs against the structs of the CUDA sources.

On the CPU no kernel launches; the kernels themselves are held against the
plain versions on the card in tests/test_torch_cuda.py.  The variant of the
SpMV kernel that staged slices through shared memory was measured and
deleted with its chunk table, so there is no chunk layout to test.
"""

import ctypes
import re
import weakref
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import examples.feti_large as jfl
import permon_tpu.feti.assembly as jasm
from permon_tpu.core.extension import SubdomainExtension as JaxExtension
from permon_tpu.core.sell import SEll as JaxSEll
from permon_tpu_torch.core import sell
from permon_tpu_torch.core.extension import (MARK_GROUP, PLANE_ALIGN, GatherTable,
                                             SubdomainExtension, overflow_marker)
from permon_tpu_torch.core.sell import (GatherArgs, LaunchPlan, SEll, SellArgs, check_x,
                                        gather_apply, gather_plan, plane_stride, sell_mv,
                                        sell_plan)
from permon_tpu_torch.feti.assembly import build_gluing
from permon_tpu_torch.feti.large import ReassemblyTables

torch.set_num_threads(2)

CSRC = Path(sell.__file__).resolve().parent.parent / "csrc"


# ------------------------------------------------------- overflow marker


def _marker_targets(mark, nrows):
    """Decode a marker with plain numpy: (rows with their bit set, the
    overflow column the kernel's rule gives each of them)."""
    rows, ranks = [], []
    for g in range(mark.shape[0]):
        seen = int(mark[g, 0])
        for q in range(8):
            word = int(np.uint32(mark[g, 1 + q]))
            for bit in range(32):
                if (word >> bit) & 1:
                    rows.append(g * MARK_GROUP + 32 * q + bit)
                    ranks.append(seen)
                    seen += 1
    assert all(r < nrows for r in rows)
    return np.array(rows, dtype=np.int64), np.array(ranks, dtype=np.int64)


@pytest.mark.parametrize("nrows,nt,seed", [(1, 1, 0), (31, 5, 1), (32, 32, 2), (257, 40, 3),
                                           (5000, 300, 4), (5000, 0, 5), (70000, 2673, 6)])
def test_overflow_marker_names_exactly_the_targets(nrows, nt, seed):
    tgt = np.sort(np.random.RandomState(seed).choice(nrows, size=nt, replace=False))
    mark = overflow_marker(tgt, nrows)
    assert mark.dtype == np.int32 and mark.shape == ((nrows + MARK_GROUP - 1) // MARK_GROUP, 9)
    rows, ranks = _marker_targets(mark, nrows)
    np.testing.assert_array_equal(rows, tgt)
    np.testing.assert_array_equal(ranks, np.arange(nt))  # column t belongs to tgt[t]


def _random_table(seed, nrows, n_src, w, cap, dtype=np.float64):
    """Host COO with up to ``w`` entries a row, packed with a width cap so
    that an overflow exists."""
    from permon_tpu_torch.core.extension import pack_planes

    rng = np.random.RandomState(seed)
    counts = rng.randint(0, w + 1, size=nrows)
    keys = np.repeat(np.arange(nrows), counts)
    src = rng.randint(0, n_src, size=len(keys)).astype(np.int32)
    vals = rng.standard_normal(len(keys)).astype(dtype)
    return pack_planes(keys, src, vals, nrows, n_src, cap=cap)


@pytest.mark.parametrize("nrows", [1, 7, 64, 1001, 4098])
def test_from_host_marks_the_overflow_targets(nrows):
    idx, vals, ov = _random_table(nrows, nrows, n_src=50, w=6, cap=2)
    tab = GatherTable.from_host(idx, vals, "cpu", n_src=50, overflow=ov)
    if ov is None or not len(ov[0]):
        assert tab.ov_tgt is None and tab.ov_mark is None
        return
    rows, _ = _marker_targets(tab.ov_mark.numpy(), nrows)
    np.testing.assert_array_equal(rows, np.unique(ov[0]))
    np.testing.assert_array_equal(rows, tab.ov_tgt.numpy())
    # at most 1% of an f64 table of width 2, past the few rows of a last record
    table_bytes = idx.size * 4 + vals.size * 8
    assert tab.ov_mark.numel() * 4 <= 0.01 * table_bytes + 36


# ------------------------------------------------------ padded planes


@pytest.mark.parametrize("nrows", [1, 2, 3, 4, 5, 94, 1001])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_padded_plane_strides_keep_apply_equal(nrows, dtype):
    idx, vals, ov = _random_table(nrows + 1, nrows, n_src=40, w=5, cap=3, dtype=dtype)
    padded = GatherTable.from_host(idx, vals, "cpu", n_src=40, overflow=ov)
    w = idx.shape[0]
    stride = plane_stride(padded.idx)
    assert padded.idx.shape == idx.shape and padded.vals.shape == vals.shape
    if w > 1:
        assert stride % PLANE_ALIGN == 0 and 0 <= stride - nrows < PLANE_ALIGN
        assert plane_stride(padded.vals) == stride
        # the pad entries: the zero slot of x, value 0
        full_i = padded.idx.as_strided((w, stride), (stride, 1)).numpy()
        full_v = padded.vals.as_strided((w, stride), (stride, 1)).numpy()
        assert (full_i[:, nrows:] == 40).all() and (full_v[:, nrows:] == 0).all()
    np.testing.assert_array_equal(padded.idx.numpy(), idx)
    np.testing.assert_array_equal(padded.vals.numpy(), vals)
    compact = padded.replace(idx=torch.tensor(idx), vals=torch.tensor(vals))
    assert plane_stride(compact.idx) == nrows or w == 1
    for xdt in (np.float64, np.float32):
        x = torch.as_tensor(np.random.RandomState(9).standard_normal(40).astype(xdt))
        np.testing.assert_array_equal(padded.apply(x).numpy(), compact.apply(x).numpy())
    lo = padded.cast(torch.float32)
    assert lo.vals.dtype == torch.float32 and plane_stride(lo.vals) == plane_stride(padded.vals)
    np.testing.assert_array_equal(lo.vals.numpy(), vals.astype(np.float32))
    assert lo.ov_vals is None or lo.ov_vals.dtype == torch.float32


# ------------------------------------- against the JAX package and scipy


def _gluing(cells=(6, 5, 4), grid=(2, 2, 2)):
    prob = jfl.build_sparse(cells, grid)
    return prob, jasm.build_gluing(prob.l2g, "nonred", True)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_merged_overflow_apply_equals_jax_extension(dtype):
    """The same gluing through the JAX table path and the port's tables: the
    overflow rides in the same apply and the result is bitwise equal."""
    prob, (r, c, v, m) = _gluing()
    J = JaxExtension.from_coo(r, c, v, m=m, ns=prob.ns, nl=prob.nl).with_gather_apply()
    assert J.gBt_ov_cols is not None
    gr, gc, gv, gm = build_gluing(prob.l2g, "nonred", True)
    P = SubdomainExtension.from_coo(gr, gc, gv, m=gm, ns=prob.ns,
                                    nl=prob.nl).with_gather_apply("cpu")
    assert P.gBt.ov_tgt is not None and P.gBt.ov_mark is not None and P.gB.ov_tgt is None
    rng = np.random.RandomState(11)
    u = rng.standard_normal(prob.ns * prob.nl).astype(dtype)
    lam = rng.standard_normal(m).astype(dtype)
    gather_apply.launches = 0
    np.testing.assert_array_equal(P.mv(torch.as_tensor(u)).numpy(),
                                  np.asarray(J.mv(jnp.asarray(u))))
    np.testing.assert_array_equal(P.rmv(torch.as_tensor(lam)).numpy(),
                                  np.asarray(J.rmv(jnp.asarray(lam))))
    assert gather_apply.launches == 0  # an operator on the CPU never launches


def test_reassembly_table_sums_the_copies():
    """The copies table of the warm solve (with its merged overflow) against
    numpy's scatter-add over the same l2g."""
    prob, _ = _gluing()
    nlp = prob.nl + 3
    tabs = ReassemblyTables.build(prob.l2g, nlp, "cpu")
    assert tabs.copies.ov_tgt is not None  # corner dofs have more than 2 copies
    xd = np.random.RandomState(2).standard_normal(prob.ns * nlp)
    ref = np.zeros(prob.n_global)
    flat = np.full((prob.ns, nlp), -1, dtype=np.int64)
    flat[:, : prob.nl] = prob.l2g
    real = flat.reshape(-1) >= 0
    np.add.at(ref, flat.reshape(-1)[real], xd[real])
    got = tabs.copies.apply(torch.as_tensor(xd)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-14 * np.abs(ref).max())


def _permuted_laplacian(nx, seed):
    n1 = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(nx, nx), format="csr")
    a = (sp.kron(n1, sp.identity(nx)) + sp.kron(sp.identity(nx), n1)).tocsr()
    perm = np.random.RandomState(seed).permutation(a.shape[0])
    return a[perm][:, perm].tocsr()


@pytest.mark.parametrize("nx,seed", [(6, 0), (17, 1), (33, 2)])
def test_sell_mv_equals_jax_sell_and_scipy(nx, seed):
    a = _permuted_laplacian(nx, seed)
    x = np.random.RandomState(seed + 5).standard_normal(a.shape[1])
    top = SEll.from_scipy(a, symmetric=True, device="cpu")
    got = top.mv(torch.as_tensor(x)).numpy()
    ref = a @ x
    tol = 1e-14 * np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol)
    jop = JaxSEll.from_scipy(a, symmetric=True)
    np.testing.assert_allclose(got, np.asarray(jop.mv(jnp.asarray(x))), rtol=0, atol=tol)
    np.testing.assert_array_equal(top.rmv(torch.as_tensor(x)).numpy(), got)


# ------------------------------------------------------------ launch plans


def _small_ops():
    a = _permuted_laplacian(9, 3)
    idx, vals, ov = _random_table(4, 30, n_src=81, w=5, cap=2)
    return (SEll.from_scipy(a, symmetric=True, device="cpu"),
            GatherTable.from_host(idx, vals, "cpu", n_src=81, overflow=ov))


@pytest.mark.parametrize("kind", ["sell", "gather"])
def test_plan_is_built_once_and_anew_after_replace(monkeypatch, kind):
    """The operator's own tensors are checked when the plan is first used,
    never again for that object; ``.replace`` gives a new object and so a
    new plan."""
    op = _small_ops()[kind == "gather"]
    name = "sell_plan" if kind == "sell" else "gather_plan"
    built = []
    make = getattr(sell, name)
    monkeypatch.setattr(sell, name, lambda o: built.append(o) or make(o))
    apply = (lambda o, x: sell_mv(o, x)) if kind == "sell" else (lambda o, x: gather_apply(o, x))
    x = torch.as_tensor(np.random.RandomState(0).standard_normal(81))
    assert "_plan" not in op.__dict__
    y = [apply(op, x) for _ in range(3)]
    plan = op.__dict__["_plan"]
    assert isinstance(plan, LaunchPlan) and built == [op]
    assert not plan.launch and plan.args is None  # on the CPU: the plain version
    assert plan.device == torch.device("cpu") and plan.n == 81
    new = op.replace(vals=op.vals.to(torch.float32)) if kind == "sell" else op.cast(torch.float32)
    assert "_plan" not in new.__dict__
    z = apply(new, x)
    assert built == [op, new] and new.__dict__["_plan"] is not plan
    assert op.__dict__["_plan"] is plan
    assert z.dtype == torch.float64  # x decides (sell) / the promotion (gather)
    np.testing.assert_allclose(z.numpy(), y[0].numpy(), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(y[0].numpy(), y[2].numpy())


@pytest.mark.parametrize("kind", ["sell", "gather"])
def test_plan_does_not_keep_the_operator_alive(kind):
    """The plan holds the operator's tensors, not the operator: dropping the
    last reference frees the operator at once, without the cycle collector."""
    op = _small_ops()[kind == "gather"]
    x = torch.ones(81, dtype=torch.float64)
    op.mv(x) if kind == "sell" else op.apply(x)
    alive = weakref.ref(op)
    del op
    assert alive() is None


@pytest.mark.parametrize("bad", ["length", "dim", "dtype", "noncontiguous", "device"])
def test_check_x_raises(bad):
    """The per-call check itself, as a launch runs it (contiguity
    included)."""
    x = torch.ones(12, dtype=torch.float64)
    cpu = torch.device("cpu")
    check_x(x, 12, cpu)
    check_x(x.float(), 12, cpu)
    exc = ValueError
    if bad == "length":
        x = x[:11]
    elif bad == "dim":
        x = x.reshape(3, 4)
    elif bad == "dtype":
        x, exc = x.half(), TypeError
    elif bad == "noncontiguous":
        x = torch.ones(24, dtype=torch.float64)[::2]
        check_x(x, 12, cpu, contiguous=False)  # the plain version takes any layout
    elif bad == "device":
        x = torch.ones(12, dtype=torch.float64, device="meta")
    with pytest.raises(exc):
        check_x(x, 12, cpu)


@pytest.mark.parametrize("kind", ["sell", "gather"])
@pytest.mark.parametrize("bad", ["length", "dtype", "device"])
def test_wrong_x_raises_after_a_plan_exists(kind, bad):
    op = _small_ops()[kind == "gather"]
    x = torch.ones(81, dtype=torch.float64)
    first = op.mv(x) if kind == "sell" else op.apply(x)
    assert "_plan" in op.__dict__ and first.shape[0] == (81 if kind == "sell" else 30)
    exc = ValueError
    if bad == "length":
        x = torch.ones(80, dtype=torch.float64)
    elif bad == "dtype":
        x, exc = x.to(torch.int64), TypeError
    elif bad == "device":
        x = torch.ones(81, dtype=torch.float64, device="meta")
    with pytest.raises(exc):
        op.mv(x) if kind == "sell" else op.apply(x)


@pytest.mark.parametrize("bad", ["planes_transposed", "two_strides", "idx_dtype", "ov_shape"])
def test_gather_plan_rejects_bad_tables(bad):
    idx = torch.zeros((2, 6), dtype=torch.int32)
    vals = torch.ones((2, 6), dtype=torch.float64)
    kw = {}
    if bad == "planes_transposed":
        idx = torch.zeros((6, 2), dtype=torch.int32).T
    elif bad == "two_strides":
        vals = torch.ones((2, 8), dtype=torch.float64)[:, :6]
    elif bad == "idx_dtype":
        idx = idx.to(torch.int16)
    elif bad == "ov_shape":
        kw = dict(ov_tgt=torch.zeros(2, dtype=torch.int32),
                  ov_idx=torch.zeros((1, 3), dtype=torch.int32),
                  ov_vals=torch.ones((1, 3), dtype=torch.float64))
    with pytest.raises((TypeError, ValueError)):
        gather_plan(GatherTable(idx=idx, vals=vals, n_src=4, **kw))


def test_sell_plan_rejects_a_wrong_value_dtype():
    op = _small_ops()[0]
    with pytest.raises(TypeError):
        sell_plan(op.replace(vals=op.vals.half()))


@pytest.mark.parametrize("source,struct,size", [("gather_apply", GatherArgs, 72),
                                                ("sell_mv", SellArgs, 40)])
def test_ctypes_structs_mirror_the_cuda_sources(source, struct, size):
    """Field for field: names, order and kinds (pointer / int32) of the
    ctypes struct are those of the struct in the .cu file."""
    text = (CSRC / f"{source}.cu").read_text()
    body = re.search(r"struct %s \{(.*?)\n\};" % struct.__name__, text, re.S).group(1)
    fields = []
    for line in body.splitlines():
        line = line.split("//")[0].strip().rstrip(";")
        if not line:
            continue
        pointer = "*" in line
        kind, names = line.replace("*", " ").rsplit(None, 1)[0], line.replace("*", " ")
        if pointer:
            fields.append((names.split()[-1], ctypes.c_void_p))
        else:
            assert kind.startswith("int32_t")
            fields += [(n.strip(), ctypes.c_int32) for n in line[len("int32_t"):].split(",")]
    assert fields == list(struct._fields_)
    assert ctypes.sizeof(struct) == size
