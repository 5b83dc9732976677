"""The roofline counts against hand counts, and against the program's own
shapes (the counts themselves never read them)."""

import numpy as np
import pytest

from h100bench import counts, peaks


def test_axis_parts_and_boxes():
    assert counts.axis_parts(101, 4) == [26, 26, 26, 26]
    assert counts.axis_parts(5, 2) == [3, 3]
    assert counts.axis_parts(4, 2) == [2, 3]
    assert counts.subdomain_boxes((3, 1, 1), (2, 1, 1)) == [(2, 2, 2), (3, 2, 2)]


def test_band_factor_entries_by_hand():
    # a 3 x 2 x 2 box: 12 rows, band w = 3*2 + 3 + 1 = 10, row i holds min(i, 10) + 1
    assert counts.band_factor_entries(3, 2, 2) == sum(min(i, 10) + 1 for i in range(12)) == 77
    # a 2 x 2 x 2 box is within its band: the whole lower triangle
    assert counts.band_factor_entries(2, 2, 2) == 36


def test_kplus_work_by_hand():
    # cells (3, 1, 1) on (2, 1, 1): boxes 2x2x2 (36 entries, 8 rows) and 3x2x2 (77, 12)
    nbytes, flops = counts.kplus_apply_work((3, 1, 1), (2, 1, 1), "float32", "float64")
    assert nbytes == (36 + 77) * 4 + 2 * (8 + 12) * 8
    assert flops == 4 * (36 + 77)
    # the north star: 64 boxes of 26^3, w = 703
    nb, _ = counts.kplus_apply_work((100,) * 3, (4,) * 3)
    n, w = 26**3, 26 * 26 + 26 + 1
    assert nb == 64 * ((n * (w + 1) - w * (w + 1) // 2) * 4 + 2 * n * 8)
    assert 0.9e-3 < peaks.least_seconds(nb, 0, "float32") < 0.95e-3


def test_gluing_rows_by_hand():
    # 5^3 nodes on 2^3: one shared layer per axis at node 2; nodes on one layer
    # have 1 row, on two 3, on three 7
    one, two, three = 3 * 4 * 4, 3 * 4, 1
    assert counts.gluing_rows((4, 4, 4), (2, 2, 2)) == (one + 3 * two + 7 * three, 6**3)
    assert counts.gluing_rows((100,) * 3, (4,) * 3) == (94563, 64 * 26**3)


def test_gather_work_by_hand():
    m, n_loc = counts.gluing_rows((4, 4, 4), (2, 2, 2))
    nnz = 2 * m
    nbytes, flops = counts.gather_f_apply_work((4, 4, 4), (2, 2, 2))
    bt = nnz * 12 + n_loc * 8 + min(32 * nnz, 8 * m)
    b = nnz * 12 + m * 8 + min(32 * nnz, 8 * n_loc)
    assert (nbytes, flops) == (bt + b, 4 * nnz)


@pytest.mark.parametrize("cells,grid", [((20,) * 3, (4,) * 3), ((12, 9, 7), (3, 2, 2))])
def test_counts_match_the_programs_shapes(cells, grid):
    from permon_tpu_torch.core.band import bandwidth
    from permon_tpu_torch.feti.assembly import build_gluing
    from permon_tpu_torch.problems import build_sparse

    prob = build_sparse(cells, grid)
    boxes = counts.subdomain_boxes(cells, grid)
    assert sorted(int(np.prod(b)) for b in boxes) == sorted(
        int((row >= 0).sum()) for row in prob.l2g)
    for s, (nx, ny, nz) in enumerate(boxes):
        n = nx * ny * nz
        K = prob.K_blocks[s][:n, :n].tocsr(copy=True)
        K.eliminate_zeros()  # the blocks store some explicit zeros
        assert bandwidth(K) == nx * ny + nx + 1
    m, n_loc = counts.gluing_rows(cells, grid)
    assert build_gluing(prob.l2g, "nonred")[3] == m
    assert n_loc == int((prob.l2g >= 0).sum())
