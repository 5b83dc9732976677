"""The elasticity configuration's pieces on the CPU, at a size this file
sets itself (the cell elastic3d-1.2m.loadsteps cut to 9 x 9 x 17 nodes on
2 x 2 x 2 subdomains):

- the plain reference (reference/box_q1_elastic.py): its operator is the
  program's assembled system, it imports nothing of the program, an exact
  answer passes and a wrong one does not;
- the program through the whole harness, untraced and traced, and its
  answer against a dense solve of the reference's operator;
- faults planted under the harness read not correct;
- the generator of three loads a node (generators/box_patches_xyz.py);
- the roofline counts (counts_elastic.py) by hand and against the port's
  own shapes;
- the BlockCoarse span metric (layer_metrics/coarse_ms.elastic.py) on
  given spans.
"""

import subprocess
import sys
import time

import numpy as np
import pytest
from conftest import ROOT

from h100bench import counts_elastic, harness, peaks, program_spans
from h100bench.reference import box_q1_elastic

ELASTIC = "elastic3d-1.2m.loadsteps"
CELLS, GRID = (8, 8, 16), (2, 2, 2)
NEW = ("kplus_roofline.elastic", "projector_roofline.elastic", "coarse_ms.elastic")


def small_cell(cells=CELLS, grid=GRID):
    import torch

    torch.set_num_threads(2)
    cell = harness.resolve(ROOT, ELASTIC)
    cell.config["problem"].update(cells=list(cells), grid=list(grid))
    cell.mix.update(pool=4, check_sample=3, trace_steps=1)
    return cell


def run_small(trace=False, factory=None, seconds=0.1, cell=None):
    import torch

    return harness.run_cell(cell or small_cell(), 2**31 + 23, seconds, trace,
                            torch.device("cpu"), time.perf_counter(), system_factory=factory)


@pytest.fixture
def block_coarse(monkeypatch):
    """The coarse side as the full-size cell builds it: G a BlockCoarse and
    the explicit coarse inverse (their cutoffs lowered to the small box)."""
    from permon_tpu_torch.qp import projector, transforms

    monkeypatch.setattr(transforms, "DENSE_G_ELEMENTS", 16)
    monkeypatch.setattr(projector, "EXPLICIT_INV_MIN_K", 8)


# -- the reference ---------------------------------------------------------------

@pytest.mark.parametrize("cells,lam,mu", [(CELLS, 1.0, 1.0), ((5, 4, 3), 1.3, 0.7)])
def test_operator_is_the_assembled_system(cells, lam, mu):
    import torch

    from permon_tpu_torch.problems import assembled_elasticity_system

    K, _ = assembled_elasticity_system(cells, lam=lam, mu=mu)
    A = box_q1_elastic.ClampedOperator(cells, lam, mu)
    assert A.n == K.shape[0]
    rs = np.random.RandomState(3)
    for _ in range(3):
        x = rs.standard_normal(A.n)
        y = K @ x
        got = A.apply(torch.as_tensor(x)).numpy()
        assert np.abs(got - y).max() <= 1e-12 * np.abs(y).max()


def test_element_matrix_is_the_tutorials_table():
    from permon_tpu_torch.problems import q1_elasticity_emat

    for lam, mu in ((1.0, 1.0), (1.3, 0.7)):
        np.testing.assert_allclose(box_q1_elastic.element_matrix(lam, mu).numpy(),
                                   q1_elasticity_emat(3, lam=lam, mu=mu), rtol=0, atol=1e-15)


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import h100bench.reference.box_q1_elastic, h100bench.generators.box_patches_xyz, "
            "h100bench.counts_elastic; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'permon_tpu_torch', 'permon_tpu', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_residual_of_an_exact_answer_is_zero_and_of_a_wrong_one_is_not():
    import torch

    ref = box_q1_elastic.Reference({"problem": {"cells": [5, 4, 3], "lam": 1.0, "mu": 1.0}})
    n = ref.A.n
    x = np.linspace(0.5, 1.5, n)
    f = ref.A.apply(torch.as_tensor(x)).numpy()
    assert ref.check(f, x)["residual"] < 1e-14
    y = x.copy()
    y[n // 2] += 0.1
    assert ref.check(f, y)["residual"] > 1e-3
    assert ref.check(f, np.full(n, np.nan))["residual"] == float("inf")
    assert ref.check(f, x[:-1])["residual"] == float("inf")


# -- the program through the harness --------------------------------------------

@pytest.mark.parametrize("trace", [False, True])
def test_the_program_passes_on_the_cpu(trace):
    r = run_small(trace=trace)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    cell = small_cell()
    names = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    assert set(r["metrics"]) <= names
    if not trace:
        assert set(r["metrics"]) == names == {"setup_s", "linear_solve_s", "linear_solve_p90_s"}
        return
    assert set(NEW) <= names and len(names) == 9
    m = r["metrics"]
    for name in ("dual_its_per_solve", "host_setup_s", "factor_s", "dual_iter_ms.linear"):
        assert m[name]["value"] > 0, name
    # on the CPU every K+ pass runs op by op
    assert m["kplus_graph_share.linear"]["value"] == 0.0
    # the two rooflines read a device trace: none on the CPU; at this size G
    # is a DenseTree (k m below the dense cutoff), so no BlockCoarse span opens
    assert not set(NEW) & set(m)
    assert "idle_share.linear" not in m  # no device records on the CPU


def test_the_answer_is_the_dense_solve(block_coarse):
    """At 5 x 5 x 7 nodes, G a BlockCoarse: the system's answer against
    torch.linalg.solve of the reference's operator, assembled column by
    column. Each of the two dual solves (the first and the f64 defect pass)
    stops at rtol 1e-5, so the answer is right to about rtol^2 = 1e-10 of
    its size (1e-11 measured); 1e-8 leaves room, and one pass alone (1e-5)
    would fail it."""
    import torch

    from permon_tpu_torch.feti.large import BlockCoarse

    cells, grid = (4, 4, 6), (2, 2, 2)
    cell = small_cell(cells, grid)
    system = harness.make_system(cell, torch.device("cpu"))
    A = box_q1_elastic.ClampedOperator(cells, 1.0, 1.0)
    eye = torch.eye(A.n, dtype=torch.float64)
    dense = torch.stack([A.apply(e) for e in eye], dim=1)
    gen = harness.generator(cell)
    for step in gen.steps(cell.mix, cell.config, 2**35 + 1)[:2]:
        f = gen.load(cell.mix, cell.config, step)
        ans = system.solve(system.to_input(f))
        x = torch.linalg.solve(dense, torch.as_tensor(f)).numpy()
        assert ans.ok and ans.counts["dual_its"] > 0
        assert np.abs(ans.x - x).max() <= 1e-8 * np.abs(x).max()
    assert isinstance(system.solver._pf.G, BlockCoarse)
    # the probe of projector_roofline.elastic: one P apply, P P = P
    p1 = system.projector_apply()()
    p2 = system.solver._pf.apply_p(p1)
    assert torch.allclose(p1, p2, atol=1e-10 * float(p1.abs().max()))
    system.close()


class Faulty:
    """The real system with a fault planted where the load goes in or the
    answer comes out."""

    def __init__(self, fault, cell, device, overrides=None):
        self.inner = harness.make_system(cell, device, overrides)
        self.fault = fault
        for k in ("spans", "timings", "sync", "close", "kplus_apply", "gather_applies",
                  "projector_apply", "build_seconds"):
            setattr(self, k, getattr(self.inner, k))

    def to_input(self, f):
        if self.fault == "y_load_dropped":
            f = f.copy()
            f[1::3] = 0.0
        return self.inner.to_input(f)

    def solve(self, b_loc):
        ans = self.inner.solve(b_loc)
        x = ans.x.copy()
        if self.fault == "y_z_swapped":
            x[1::3], x[2::3] = ans.x[2::3], ans.x[1::3]
        elif self.fault == "entry_altered":
            k = int(np.argmax(np.abs(x)))
            x[k] += 0.1 * x[k]
        elif self.fault == "unconverged":
            ans.ok = False
        ans.x = x
        return ans


@pytest.mark.parametrize("fault", ["y_load_dropped", "y_z_swapped", "entry_altered",
                                   "unconverged", "bf16_factors"])
def test_a_fault_is_not_correct(fault):
    over = small_cell().config["controls"]["bf16_factors"] if fault == "bf16_factors" else None
    r = run_small(factory=lambda cell, dev: Faulty(fault, cell, dev, over))
    assert not r["correct"], r["checks"]
    if fault == "unconverged":
        assert r["checks"]["failed_solves"]["value"] >= 1
    else:
        assert r["checks"]["residual"]["value"] > r["checks"]["residual"]["limit"]


# -- the generator ---------------------------------------------------------------

def _mix_and_generator():
    mix = harness.read_mix(ROOT / "h100bench" / "traffic" / "loadsteps-xyz.json")
    return mix, harness.load_module(harness.HERE / "generators" / f"{mix['generator']}.py")


def test_same_seed_same_loads_other_seed_same_pool():
    mix, gen = _mix_and_generator()
    cells = [54, 54, 129]  # the configuration's box: patches leave most of it bare
    config = {"problem": {"cells": cells}}
    nodes = tuple(c + 1 for c in cells)
    a = gen.steps(mix, config, 2**31 + 5)
    b = gen.steps(mix, config, 2**31 + 5)
    c = gen.steps(mix, config, 2**33 + 1)
    assert a == b and len(a) == mix["pool"] == 16
    assert a != c and sorted(a, key=lambda s: s.index) == sorted(c, key=lambda s: s.index)
    assert gen.steps(mix, config, -3) == gen.steps(mix, config, -3)
    assert gen.warmup(mix, config) not in a
    for sa, sb in zip(a, b):
        fa, fb = gen.load(mix, config, sa), gen.load(mix, config, sb)
        assert np.array_equal(fa, fb) and fa.shape == (3 * np.prod(nodes),)
        assert np.isfinite(fa).all()
        v = fa.reshape(nodes[2], nodes[1], nodes[0], 3)
        assert not v[:, :, 0].any()  # every component is 0 on the clamped face
        # three components, each its own field: the patches' amplitudes differ by component
        comp = v[:, :, 1:].reshape(-1, 3)
        assert all(not np.array_equal(comp[:, i], comp[:, j]) for i, j in ((0, 1), (0, 2), (1, 2)))
        assert (comp.min(axis=0) >= 0.5 - 4 * 6).all() and (comp.max(axis=0) <= 1.5 + 8 * 6).all()
        # the body load s (1, 1, 1) where no patch lies
        bare = np.ones(v.shape[:3], dtype=bool)
        for ((x0, x1), (y0, y1), (z0, z1)), _ in sa.patches:
            bare[z0:z1, y0:y1, x0:x1] = False
        bare[:, :, 0] = False
        assert bare.any() and (v[bare] == sa.body).all()


def test_the_dof_order_is_the_programs():
    """Entry 3 * node + c of the load is component c of node ``node``, as
    the program's global dofs are numbered."""
    from permon_tpu_torch.problems import build_sparse_elasticity

    mix, gen = _mix_and_generator()
    config = {"problem": {"cells": [4, 4, 6]}}
    step = gen.steps(mix, config, 7)[0]
    f = gen.load(mix, config, step)
    prob = build_sparse_elasticity((4, 4, 6), (2, 2, 2))
    assert f.shape == (prob.n_global,)
    Mx, My = 5, 5
    for (x0, x1), (y0, y1), (z0, z1) in [p[0] for p in step.patches]:
        if x0 == 0:
            continue
        node = (z0 * My + y0) * Mx + x0
        assert np.allclose(f[3 * node:3 * node + 3] - step.body,
                           sum(np.asarray(amp) for box, amp in step.patches
                               if all(lo <= v < hi for (lo, hi), v in zip(box, (x0, y0, z0)))))


# -- the counts ------------------------------------------------------------------

def test_counts_by_hand():
    # one 10 x 10 x 44 box: n = 13,200 dofs, w = 3 (100 + 10 + 1) + 2 = 335
    assert counts_elastic.bandwidth(10, 10) == 335
    assert counts_elastic.band_factor_entries(10, 10, 44) == 13200 * 336 - 335 * 336 // 2
    assert counts_elastic.band_factor_entries(10, 10, 44) == 4_378_920
    # a 2 x 2 x 2 box (24 dofs) lies within its band (w = 3 * 7 + 2 = 23)
    assert counts_elastic.band_factor_entries(2, 2, 2) == 24 * 25 // 2
    cells, grid = (54, 54, 129), (6, 6, 3)
    nbytes, flops = counts_elastic.kplus_apply_work(cells, grid, "float32")
    assert nbytes == 108 * 4_378_920 * 4 + 2 * 108 * 13200 * 8
    assert flops == 4 * 108 * 4_378_920
    assert 0.570e-3 < peaks.least_seconds(nbytes, flops, "float32") < 0.572e-3
    assert counts_elastic.floating_dofs(cells, grid) == (90, 90 * 13200)
    assert counts_elastic.coarse_dim(cells, grid) == 540
    assert counts_elastic.gluing_rows(cells, grid) == (245_850, 108 * 13200)
    m, n_loc = 245_850, 108 * 13200
    gb = (2 * m * 12 + n_loc * 8 + m * 8) + (2 * m * 12 + m * 8 + n_loc * 8)
    assert counts_elastic.gather_pair_work(cells, grid) == (gb, 8 * m)
    pb, pf = counts_elastic.projector_apply_work(cells, grid)
    assert pb == gb + 2 * 6 * 90 * 13200 * 8 + 540 * 540 * 8 + 2 * m * 8
    assert pf == 8 * m + 4 * 6 * 90 * 13200 + 2 * 540 * 540 + m


@pytest.mark.parametrize("cells,grid", [((8, 8, 16), (2, 2, 2)), ((9, 5, 7), (3, 1, 2))])
def test_counts_match_the_programs_shapes(cells, grid, block_coarse):
    import torch

    from permon_tpu_torch.core.band import bandwidth
    from permon_tpu_torch.feti.large import BlockCoarse, FetiSolverSparse
    from permon_tpu_torch.feti.solve import FetiOptions
    from permon_tpu_torch.problems import build_sparse_elasticity

    from h100bench import counts

    prob = build_sparse_elasticity(cells, grid)
    boxes = counts.subdomain_boxes(cells, grid)
    for s, (nx, ny, nz) in enumerate(boxes):
        n = 3 * nx * ny * nz
        assert int((prob.l2g[s] >= 0).sum()) == n
        K = prob.K_blocks[s][:n, :n].tocsr(copy=True)
        K.eliminate_zeros()
        assert bandwidth(K) == counts_elastic.bandwidth(nx, ny)
    opts = FetiOptions(**small_cell().config["recipe"]["options"])
    solver = FetiSolverSparse(prob, opts, kplus_dtype=torch.float32, device="cpu")
    solver._ensure_pf()
    pf, BE = solver._pf, solver.qp.BE
    m, n_loc = counts_elastic.gluing_rows(cells, grid)
    k = counts_elastic.coarse_dim(cells, grid)
    assert isinstance(pf.G, BlockCoarse) and pf.G.shape == (k, m)
    assert BE.shape == (m, BE.ns * BE.nl) and int((prob.l2g >= 0).sum()) == n_loc
    assert pf.G.Rb.shape == (len(boxes), BE.nl, counts_elastic.RBM) and pf.G.k == k
    # the floating subdomains' bases are the only nonzero blocks
    live = (pf.G.Rb != 0).flatten(1).any(dim=1).numpy()
    assert int(live.sum()) == counts_elastic.floating_dofs(cells, grid)[0]
    assert all(live[s] == (s % grid[0] != 0) for s in range(len(boxes)))
    assert pf.ggt_inv.shape == (k, k)


# -- the BlockCoarse span metric -------------------------------------------------

@pytest.mark.parametrize("events,want", [
    ({"coarse.g_mv": (30, 0.006, 0.003), "coarse.g_rmv": (30, 0.004, 0.002),
      "cg.iteration": (24, 0.2, 0.1), "cg.solve": (2, 0.25, 0.01)}, 1e3 * 0.010 / 22),
    ({"cg.iteration": (24, 0.2, 0.1), "cg.solve": (2, 0.25, 0.01)}, None),
    ({}, None)])
def test_coarse_ms_reads_the_spans(events, want):
    ctx = harness.Context(cell=small_cell(), setup_s=0.0, window_s=1.0, steps=[], spans={},
                          timings={}, cuda=True)
    ctx.program_spans = program_spans.Spans(steps=3, wall_s=2.4, events=events, parents={})
    got = harness.load_module(harness.metric_path("layer_metrics", "coarse_ms.elastic")).read(ctx)
    assert got == pytest.approx(want) if want is not None else got is None


@pytest.mark.parametrize("name", NEW)
def test_a_new_metric_without_its_source_reads_nothing(name):
    """No card (the rooflines' probes give no device time) and no spans
    (a program without them): the metric is left out of the line."""
    class Probes:
        def kplus_apply(self):
            return lambda: None

        projector_apply = kplus_apply

    ctx = harness.Context(cell=small_cell(), setup_s=0.0, window_s=1.0, steps=[], spans={},
                          timings={}, cuda=False, system=Probes())
    ctx.program_spans = None
    assert harness.load_module(harness.metric_path("layer_metrics", name)).read(ctx) is None
