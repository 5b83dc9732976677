"""The port's spans (permon_tpu_torch/sys/tracing.py) and where the large
linear path opens them:

- a span's self time is its total less its children's, and its count by
  parent is kept;
- a span opens a ``record_function`` range of its name only while a
  profiler records;
- ``trace`` keeps its ``events`` and BEGIN/END contract, ``seconds`` holds
  the duration, ``traced`` names the span by the function;
- one ``FetiSolverSparse.solve`` on the 12^3 box of
  test_torch_feti_large.py counts its CG turns, reads and K+ passes as the
  dual CG runs them, and its x_global is bitwise that of a solve under the
  profiler;
- one solve of a small elastic box whose coarse operator is a BlockCoarse
  (the rigid-body nullspace) opens ``coarse.g_mv``, ``coarse.g_rmv`` and
  ``projector.apply_cp`` once each for every P apply, and under
  ``feti.dualize`` and ``feti.post`` besides.
"""

import time

import numpy as np
import pytest
import torch

from permon_tpu_torch.core.convergence import Tolerances
from permon_tpu_torch.feti.large import FetiSolverSparse
from permon_tpu_torch.feti.solve import FetiOptions
from permon_tpu_torch.problems import build_sparse, build_sparse_elasticity
from permon_tpu_torch.sys import tracing
from permon_tpu_torch.sys.tracing import trace

torch.set_num_threads(2)

CELLS, GRID = (12, 12, 12), (2, 2, 2)
F32 = dict(kplus_dtype=torch.float32, kplus_refine=2, primal_refine=1)


def _busy(seconds):
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        pass


@pytest.mark.parametrize("children", [0, 1, 3])
def test_self_time_is_total_less_children(children):
    tracing.reset()
    with trace("outer") as outer:
        _busy(0.004)
        for _ in range(children):
            with trace("inner"):
                _busy(0.003)
    cnt, tot, own = tracing.events["outer"]
    assert cnt == 1 and tot == outer.seconds >= 0.004 + 0.003 * children
    inner = tracing.events["inner"][1] if children else 0.0
    assert own == pytest.approx(tot - inner, abs=1e-12)
    if children:
        c_cnt, c_tot, c_own = tracing.events["inner"]
        assert c_cnt == children and c_own == c_tot  # a leaf's self time is its total


def test_counts_by_parent():
    tracing.reset()
    with trace("a"):
        for _ in range(3):
            with trace("b"):
                with trace("c"):
                    pass
        with trace("c"):
            pass
    with trace("c"):
        pass
    assert dict(tracing.parents) == {(None, "a"): 1, ("a", "b"): 3, ("b", "c"): 3,
                                     ("a", "c"): 1, (None, "c"): 1}
    assert tracing.events["c"][0] == 5
    rep = tracing.event_report()
    assert "a -> b" in rep and "None -> c" in rep and "Self (s)" in rep


def test_a_range_only_under_the_profiler(monkeypatch):
    opened = []
    real = torch.profiler.record_function

    def spy(name):
        opened.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    with trace("span.off"):
        pass
    assert opened == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace("span.on"):
            with trace("span.inner"):
                torch.ones(4).sum()
    assert opened == ["span.on", "span.inner"]
    names = [e.name for e in prof.events()]
    assert "span.on" in names and "span.inner" in names and "span.off" not in names


def test_trace_keeps_events_and_begin_end(capsys):
    tracing.reset()
    old = tracing.trace_enabled
    tracing.set_from_options(trace=True)
    try:
        with trace("outer"):
            with trace("inner"):
                pass

        @tracing.traced
        def f():
            return 7

        assert f() == 7
    finally:
        tracing.set_from_options(trace=old)
    out = capsys.readouterr().out.splitlines()
    assert out[:2] == ["BEGIN FUNCTION outer", "  BEGIN FUNCTION inner"]
    assert out[2].startswith("  END FUNCTION inner (") and out[3].startswith("END FUNCTION outer (")
    assert out[4].endswith("BEGIN FUNCTION test_trace_keeps_events_and_begin_end.<locals>.f")
    assert tracing.events["outer"][0] == tracing.events["inner"][0] == 1
    assert tracing.log_event is trace


@pytest.fixture(scope="module")
def solved():
    """Two solves of one solver on a new load: spans counted, then under the
    profiler."""
    prob = build_sparse(CELLS, GRID)
    solver = FetiSolverSparse(prob, FetiOptions(gluing="nonred", coarse="sparse"),
                              device="cpu", **F32)
    assert solver.timings["host_setup_s"] > 0 and solver.timings["factor_s"] > 0
    b = prob.b_loc * 1.5
    tol = Tolerances(rtol=1e-6)
    tracing.reset()
    res = solver.solve(b_loc=b, tol=tol)
    events = {k: list(v) for k, v in tracing.events.items()}
    par = dict(tracing.parents)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        res_p = solver.solve(b_loc=b, tol=tol)
    return res, events, par, res_p, [e.name for e in prof.events()]


def test_solve_counts_cg_turns_reads_and_kplus(solved):
    res, events, par, _, _ = solved
    its = [r.iterations for r in res.results]
    assert len(its) == 2 and all(r.reason == 2 for r in res.results)
    assert events["cg.iteration"][0] == sum(i + 1 for i in its)
    assert events["cg.read"][0] == sum(i + 3 for i in its)
    assert par[("cg.iteration", "kplus.solve")] == sum(its)  # one per F apply in the loop
    assert par[("cg.iteration", "cg.read")] == sum(i + 1 for i in its)
    assert par[("cg.solve", "kplus.solve")] == 2  # r = b - F x0
    assert events["feti.solve"][0] == events["feti.to_host"][0] == events["feti.rhs"][0] == 1
    assert events["feti.dual_solve"][0] == events["feti.dualize"][0] == 2
    assert events["feti.post"][0] == events["cg.solve"][0] == 2
    assert events["feti.defect"][0] == 1 and events["feti.reassembly"][0] == 2
    assert par[(None, "feti.solve")] == 1
    # F applies by purpose: lambda0 and the projected dual, and the post chain
    # (the refined K+: a forward and backward pass each, two refinements)
    assert par[("feti.dualize", "kplus.solve")] > 0 and par[("feti.post", "kplus.solve")] > 0
    assert events["kplus.solve"][0] == sum(n for (p, s), n in par.items() if s == "kplus.solve")
    assert par[("cg.iteration", "projector.apply_p")] >= sum(its)
    # B' and B around each K+ pass of an F apply in the loop
    assert par[("cg.iteration", "gather.apply")] == 2 * sum(its)
    for name, (cnt, tot, own) in events.items():
        assert -1e-9 <= own <= tot + 1e-9, name
    fs = events["feti.solve"]
    assert fs[1] >= events["feti.dual_solve"][1] >= events["cg.solve"][1] >= events[
        "cg.iteration"][1]


def test_solve_under_the_profiler_is_bitwise_the_same(solved):
    res, _, _, res_p, names = solved
    np.testing.assert_array_equal(res_p.x_global, res.x_global)
    for name in ("feti.solve", "cg.iteration", "kplus.solve", "gather.apply", "feti.to_host"):
        assert name in names


@pytest.fixture(scope="module")
def elastic_spans():
    """The spans of one re-solve of an elastic box (6 rigid-body modes a
    floating subdomain, the clamped face eliminated in the Hessian), its G a
    BlockCoarse: the dense-G cutoff is lowered, as the 1.18M-dof box passes
    it."""
    from permon_tpu_torch.feti.large import BlockCoarse
    from permon_tpu_torch.qp import transforms

    mp = pytest.MonkeyPatch()
    mp.setattr(transforms, "DENSE_G_ELEMENTS", 16)
    try:
        prob = build_sparse_elasticity((8, 8, 8), (2, 2, 2))
        opts = FetiOptions(gluing="nonred", nullspace="rbm", deterministic=True,
                           coarse="sparse", dirichlet_by_B=False)
        solver = FetiSolverSparse(prob, opts, device="cpu", **F32)
        tol = Tolerances(rtol=1e-5)
        solver.solve(b_loc=prob.b_loc, tol=tol)
        assert isinstance(solver._pf.G, BlockCoarse)
        tracing.reset()
        res = solver.solve(b_loc=prob.b_loc * 1.5, tol=tol)
    finally:
        mp.undo()
    return res, {k: list(v) for k, v in tracing.events.items()}, dict(tracing.parents)


def test_block_coarse_spans_count_the_g_applies(elastic_spans):
    res, events, par = elastic_spans
    assert all(r.reason == 2 for r in res.results)
    n_p = events["projector.apply_p"][0]
    assert n_p >= sum(r.iterations for r in res.results)
    # one P = I - G'(GG')^-1 G apply: one G, one coarse solve, one G'
    for name in ("coarse.g_mv", "coarse.g_rmv", "projector.apply_cp"):
        assert par[("projector.apply_p", name)] == n_p, name
    # lambda0 = G'(GG')^-1 e in the dualization, alpha = (GG')^-1 G(...) in the post chain
    assert par[("feti.dualize", "coarse.g_rmv")] > 0
    assert par[("feti.dualize", "projector.apply_cp")] > 0
    assert par[("feti.post", "coarse.g_mv")] > 0
    assert par[("feti.post", "projector.apply_cp")] > 0
    for name in ("coarse.g_mv", "coarse.g_rmv", "projector.apply_cp"):
        assert events[name][0] == sum(n for (p, s), n in par.items() if s == name), name
    # each G apply runs one gather (B' in G, B in G')
    assert par[("coarse.g_mv", "gather.apply")] == events["coarse.g_mv"][0]
    assert par[("coarse.g_rmv", "gather.apply")] == events["coarse.g_rmv"][0]


def test_fixed_trees_open_detred_sum_and_launch_nothing_on_the_cpu(elastic_spans):
    """Every G apply reduces its bases over the dofs as one fixed tree (the
    span ``detred.sum``, a child of ``coarse.g_mv``); the deterministic
    CG's dots are trees too.  On the CPU no tree launches the kernel, so no
    ``detred.kernel`` span opens."""
    _, events, par = elastic_spans
    assert par[("coarse.g_mv", "detred.sum")] == events["coarse.g_mv"][0]
    assert par[("cg.iteration", "detred.sum")] > 0
    assert events["detred.sum"][0] == sum(n for (p, s), n in par.items() if s == "detred.sum")
    assert "detred.kernel" not in events
