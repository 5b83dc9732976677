"""The schedule of the fixed-tree kernel (permon_tpu_torch/csrc/det_sum.cu)
on the CPU, where the kernel cannot run: a plain-Python model of what its
launches compute, read from the same layout and passes that the wrapper in
core/detred.py hands the kernel, held bitwise against the plain tree
(det_sum on a CPU tensor):

- each thread of a pass evaluates value j of level L from its 2^L leaves
  (j plus subset sums of the level offsets), in the tree's order; the last
  value of a level walks the chain of carried ends;
- a partial pass writes level L to scratch, a final pass finishes the
  levels in the block, as the plain tree does;
- the layout reads every value where the kernel reads it: offsets of the
  row dimensions and strides of both factors over each tensor's storage,
  broadcast dimensions at stride 0, one part a det_dots pair.

Lengths: those of the main path (BlockCoarse's 13,440 dofs, CG's 245,850 and
94,563 dual unknowns, the k = 540 coarse inverse, the Poisson cell's 48
coarse rows) and random ones up to 300,000.  Compiles no JAX program.  The
kernel itself is held against the plain tree on the card in
tests/test_torch_cuda.py.
"""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from permon_tpu_torch.core import detred
from permon_tpu_torch.core.detred import (MAX_LEVELS, MAX_THREADS, ROW_DIMS, DetSumArgs,
                                          det_dot, det_sum, det_sum_plain, level_size,
                                          parts_layout, pass_sources, tree_layout,
                                          tree_passes)
from permon_tpu_torch.sys import tracing

torch.set_num_threads(2)

CSRC = Path(__file__).resolve().parents[1] / "permon_tpu_torch" / "csrc"
#: the SMs of the card the plans are modelled for (an H100 SXM)
SMS = 132
MAIN_LENGTHS = [1, 2, 3, 5, 64, 1000, 13440, 94563, 245850]


def _wide(rng, shape, dtype=torch.float64):
    """Values over many binades, so that another pairing rounds otherwise."""
    v = rng.standard_normal(shape) * 10.0 ** rng.uniform(-6, 6, shape)
    return torch.as_tensor(v, dtype=dtype)


def _storage(t):
    return torch.empty(0, dtype=t.dtype).set_(t.untyped_storage())


def _source(lay, xs, ys):
    """(rows, n) values of the first pass as the kernel reads them: the row
    offsets from the layout's dimensions, each part's tensor at its storage
    offset, the product formed when there is a second factor."""
    rpp = lay.rows // lay.parts
    rem = torch.arange(lay.rows) % rpp
    part = torch.arange(lay.rows) // rpp
    oa = torch.zeros(lay.rows, dtype=torch.int64)
    ob = torch.zeros(lay.rows, dtype=torch.int64)
    for d in reversed(range(ROW_DIMS)):
        i = rem % lay.size[d]
        rem = rem // lay.size[d]
        oa += i * lay.sta[d]
        ob += i * lay.stb[d]
    pos = torch.arange(lay.n)
    vals = torch.empty((lay.rows, lay.n), dtype=lay.dtype)
    for k in range(lay.parts):
        sel = part == k
        a = _storage(xs[k])[xs[k].storage_offset() + oa[sel, None] + pos[None, :] * lay.sa]
        if lay.has_b:
            a = a * _storage(ys[k])[ys[k].storage_offset() + ob[sel, None] + pos[None, :] * lay.sb]
        vals[sel] = a
    return vals


def _full(S, base, h):
    """Full sub-trees of len(h) levels, one a column of ``base``: leaves at
    base + subset sums of h (bit d of the leaf's index <-> h[d]), added
    bottom-up in the tree's order."""
    L = len(h)
    sums = torch.zeros(1 << L, dtype=torch.int64)
    for d in range(L):
        sums = sums + ((torch.arange(1 << L) >> d) & 1) * h[d]
    pos = (base[None, :] + sums[:, None]).clamp(max=S.shape[1] - 1)
    V = S[:, pos]  # (rows, 2^L, len(base)); a bit-0 pair is neighbours
    for _ in range(L):
        V = V[:, 0::2] + V[:, 1::2]
    return V[:, 0]


def _last(S, base, h, odd):
    """The last value of level len(h): carried from its right child where
    the level below is odd, else full left sub-tree + last right value."""
    D = len(h)
    if D == 0:
        return S[:, base]
    right = _last(S, base + h[D - 1], h[:D - 1], odd[:D - 1])
    if odd[D - 1]:
        return right
    return _full(S, torch.tensor([base]), h[:D - 1])[:, 0] + right


def _model(lay, xs, ys):
    """What the kernel's launches leave in ``out``, pass by pass."""
    S = _source(lay, xs, ys)
    for p in lay.passes:
        m, h, odd = S.shape[1], [], []
        for _ in range(p.levels):
            h.append(m // 2)
            odd.append(m % 2)
            m -= m // 2
        assert p.levels <= MAX_LEVELS and p.group * p.span <= MAX_THREADS
        level = torch.empty((S.shape[0], m), dtype=S.dtype)
        if m > 1:
            level[:, :-1] = _full(S, torch.arange(m - 1), h)
        level[:, -1] = _last(S, m - 1, h, odd)
        if p.partial:
            assert -(-m // p.span) <= 65535
            S = level
            continue
        assert m <= p.span  # a block holds the level's values of its rows
        src = level
        while m > 1:  # the shared-memory levels of the block
            half, m1 = m // 2, m - m // 2
            dst = src[:, half: half + m1].clone()  # the carried value, for odd m
            dst[:, :half] = src[:, :half] + src[:, half: 2 * half]
            src, m = dst, m1
        return src[:, 0].reshape(lay.out_shape)
    raise AssertionError("the passes end without a final pass")


def _kernel_model(x, axis=-1, y=None):
    lay = tree_layout(x, axis, y, SMS)
    return _model(lay, [x], [] if y is None else [y])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", MAIN_LENGTHS)
def test_schedule_is_the_tree_at_main_path_lengths(n, dtype):
    rng = np.random.RandomState(n)
    x, y = _wide(rng, n, dtype), _wide(rng, n, dtype)
    got = _kernel_model(x, -1, y)
    assert torch.equal(got, det_sum(x * y))
    assert torch.equal(_kernel_model(x), det_sum(x))


@pytest.mark.parametrize("seed", range(6))
def test_schedule_is_the_tree_at_random_lengths(seed):
    rng = np.random.RandomState(100 + seed)
    for n in rng.randint(1, 300_001, size=3):
        rows = int(rng.randint(1, 4))
        x = _wide(rng, (rows, int(n)))
        assert torch.equal(_kernel_model(x, -1), det_sum(x, -1)), n


def test_another_pairing_is_not_the_tree():
    """The comparison has teeth: pairing neighbours (i with i + 1) instead of
    i with i + n//2 rounds otherwise on these values."""
    x = _wide(np.random.RandomState(7), 1000)
    v = x.clone()
    while v.shape[0] > 1:
        tail = v[-1:] if v.shape[0] % 2 else v[:0]
        v = torch.cat([v[0: v.shape[0] - 1: 2] + v[1::2], tail])
    assert not torch.equal(v[0], det_sum(x))


def _layout_cases():
    rng = np.random.RandomState(3)
    w = _wide(rng, (5, 13440))
    g = _wide(rng, (7, 33))
    base = _wide(rng, (6, 40, 9))
    return {
        # BlockCoarse.mv: (ns, nlp, 6) bases against (ns, nlp) along the dofs
        "block_coarse": (_wide(rng, (5, 13440, 6)), 1, w[:, :, None]),
        # DenseTree.mv / .rmv: a (k, m) G against x along m, against y along k
        "dense_tree_mv": (_wide(rng, (48, 2000)), -1, _wide(rng, 2000)[None, :]),
        "dense_tree_rmv": (_wide(rng, (48, 2000)), 0, _wide(rng, 48)[:, None]),
        # apply_cp's explicit inverse against v
        "apply_cp": (_wide(rng, (540, 540)), -1, _wide(rng, 540)[None, :]),
        # det_gram: both factors broadcast
        "gram": (g[:, None, :], -1, g[None, :, :]),
        "transposed": (_wide(rng, (300, 70)).T, -1, None),
        "sliced": (_wide(rng, (90, 400))[::3, 1::2], 1, None),
        "four_row_dims": (base.permute(2, 0, 1)[:, :, ::2, None].expand(9, 6, 20, 3), 2,
                          None),
        "one_row": (_wide(rng, 13440), 0, _wide(rng, 13440)),
        "long_rows_axis0": (_wide(rng, (245850, 2)), 0, None),
    }


@pytest.mark.parametrize("case", sorted(_layout_cases()))
def test_layouts_read_where_the_kernel_reads(case):
    x, axis, y = _layout_cases()[case]
    lay = tree_layout(x, axis, y, SMS)
    ref = det_sum(x, axis, y)
    src = _source(lay, [x], [] if y is None else [y])
    prod = x if y is None else x * y
    assert torch.equal(src, torch.movedim(prod, axis, -1).reshape(lay.rows, lay.n))
    got = _model(lay, [x], [] if y is None else [y])
    assert got.shape == ref.shape and torch.equal(got, ref)


@pytest.mark.parametrize("npairs", [1, 2, 3])
def test_parts_rows_are_each_pairs_det_dot(npairs):
    rng = np.random.RandomState(npairs)
    n = 245850
    vecs = [_wide(rng, n) for _ in range(npairs + 1)]
    pairs = [(vecs[k], vecs[k + 1]) for k in range(npairs)]
    lay = parts_layout(pairs, SMS)
    got = _model(lay, [x for x, _ in pairs], [y for _, y in pairs])
    for k, (x, y) in enumerate(pairs):
        assert torch.equal(got[k], det_dot(x, y))
    assert [torch.equal(a, b) for a, b in zip(detred.det_dots(pairs), got)] == [True] * npairs


def test_main_path_shapes_take_one_launch_or_two():
    one = [(540, 540, 1), (94563, 48, 32), (2304, 1820, 1)]
    two = [(648, 13440, 6), (1, 245850, 1), (2, 245850, 1), (3, 245850, 1), (1, 94563, 1),
           (48, 94563, 1)]
    for rows, n, g in one:
        passes = tree_passes(rows, n, g, SMS)
        assert len(passes) == 1 and not passes[0].partial, (rows, n, g, passes)
    for rows, n, g in two:
        passes = tree_passes(rows, n, g, SMS)
        assert [p.partial for p in passes] == [True, False], (rows, n, g, passes)
    rng = np.random.RandomState(0)
    for rows, n, g in zip(rng.randint(1, 5000, 200), rng.randint(1, 10 ** 7, 200),
                          rng.randint(1, 33, 200)):
        passes = tree_passes(int(rows), int(n), int(g), SMS)
        m = int(n)
        for p in passes:
            m = level_size(m, p.levels)
            assert 0 <= p.levels <= MAX_LEVELS and 1 <= p.group * p.span <= MAX_THREADS
        assert not passes[-1].partial and m <= passes[-1].span
        assert all(p.partial for p in passes[:-1]) and len(passes) <= 4


def test_plans_follow_the_cards_sm_count():
    """Blocks that leave SMs idle take up to 1,024 threads, else 256: 200
    rows of 4,000 fill a card of 132 SMs (a final pass of 250 values a row
    after 4 levels) and not one of 264 (1,000 after 2)."""
    assert tree_passes(200, 4000, 1, 132) == (detred.TreePass(4, 250, 1, False),)
    assert tree_passes(200, 4000, 1, 264) == (detred.TreePass(2, 1000, 1, False),)


def test_pass_sources_after_a_partial_pass_are_the_scratch_rows():
    lay = tree_layout(torch.zeros(3, 245850), -1, torch.zeros(245850), SMS)
    (first, second) = pass_sources(lay)
    assert first[0] == 245850 and first[-1] is True
    n1 = level_size(245850, lay.passes[0].levels)
    assert second == (n1, 1, 0, (1, 1, 1, 3), (0, 0, 0, n1), (0, 0, 0, 0), 3, False)


@pytest.mark.parametrize("bad", ["int", "half", "bf16", "mixed", "row_dims", "empty"])
def test_layout_refuses_what_the_kernel_does_not_take(bad):
    x = torch.zeros(4, 5)
    if bad == "int":
        args, err = (torch.zeros(4, 5, dtype=torch.int32),), TypeError
    elif bad == "half":
        args, err = (x.half(),), TypeError
    elif bad == "bf16":
        args, err = (x.bfloat16(), -1, x.bfloat16()), TypeError
    elif bad == "mixed":
        args, err = (x, -1, x.double()), TypeError
    elif bad == "row_dims":
        big = torch.zeros(2, 3, 4, 5, 6, 7, 8).permute(6, 0, 5, 1, 4, 2, 3)
        args, err = (big, -1), ValueError
    else:
        args, err = (torch.zeros(4, 0),), IndexError
    with pytest.raises(err):
        tree_layout(*args, sms=SMS)


def test_cpu_tensors_take_the_plain_tree_and_open_one_span():
    rng = np.random.RandomState(5)
    a, w = _wide(rng, (4, 300, 6)), _wide(rng, (4, 300))
    tracing.reset()
    n0 = det_sum.launches
    got = det_sum(a, 1, w[:, :, None])
    assert torch.equal(got, det_sum_plain(a * w[:, :, None], 1))
    assert tracing.events["detred.sum"][0] == 1 and "detred.kernel" not in tracing.events
    assert det_sum.launches == n0


def test_ctypes_struct_mirrors_the_cuda_source():
    """Field for field: names, order, kinds (pointer, int64, int32) and
    array lengths of DetSumArgs are those of the struct in det_sum.cu."""
    text = (CSRC / "det_sum.cu").read_text()
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", text)}
    body = re.search(r"struct DetSumArgs \{(.*?)\n\};", text, re.S).group(1)
    kinds = {"int64_t": ctypes.c_int64, "int32_t": ctypes.c_int32}
    fields = []
    for line in body.splitlines():
        line = line.split("//")[0].strip().rstrip(";")
        if not line:
            continue
        m = re.match(r"(?:const )?(\w+)\s*(\*?)\s*(\w+)(?:\[(\w+)\])?$", line)
        kind, ptr, name, length = m.groups()
        t = ctypes.c_void_p if ptr else kinds[kind]
        if length:
            t = t * consts[length]
        fields.append((name, t))
    got = [(n, t) for n, t in DetSumArgs._fields_]
    assert [n for n, _ in got] == [n for n, _ in fields]
    for (_, t1), (_, t2) in zip(got, fields):
        assert ctypes.sizeof(t1) == ctypes.sizeof(t2)
        assert getattr(t1, "_type_", t1) == getattr(t2, "_type_", t2)
    assert consts["kMaxParts"] == detred.MAX_PARTS and consts["kRowDims"] == ROW_DIMS
    assert consts["kMaxLevels"] == MAX_LEVELS and consts["kMaxThreads"] == MAX_THREADS
    assert ctypes.sizeof(DetSumArgs) == 296
