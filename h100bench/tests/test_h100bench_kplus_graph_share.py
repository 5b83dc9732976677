"""The share of K+ passes that replay a CUDA graph
(layer_metrics/kplus_graph_share.linear.py), read from the program's spans:
100 where every pass is a replay, 50 where half are, nothing where no K+
pass ran."""

import pytest
from conftest import LINEAR, small_cell

from h100bench import harness, program_spans


@pytest.mark.parametrize("passes,replays,share", [(6, 6, 100.0), (6, 3, 50.0), (0, 0, None)])
def test_kplus_graph_share_counts_the_replays(passes, replays, share):
    events = {}
    if passes:
        events["kplus.solve"] = (passes, 0.02, 0.01)
    if replays:
        events["kplus.replay"] = (replays, 0.001, 0.001)
    ctx = harness.Context(cell=small_cell(LINEAR), setup_s=0.0, window_s=1.0, steps=[],
                          spans={}, timings={}, cuda=True)
    ctx.program_spans = program_spans.Spans(steps=3, wall_s=2.4, events=events, parents={})
    got = harness.load_module(harness.metric_path("layer_metrics",
                                                  "kplus_graph_share.linear")).read(ctx)
    assert got == share


@pytest.mark.parametrize("spans", ["none", "empty"])
def test_kplus_graph_share_without_spans_reads_nothing(spans):
    """A probe that failed (none), or a program that opens no span (empty),
    leaves the metric out of the line."""
    ctx = harness.Context(cell=small_cell(LINEAR), setup_s=0.0, window_s=1.0, steps=[],
                          spans={}, timings={}, cuda=True)
    ctx.program_spans = (None if spans == "none" else
                         program_spans.Spans(steps=3, wall_s=2.4, events={}, parents={}))
    got = harness.load_module(harness.metric_path("layer_metrics",
                                                  "kplus_graph_share.linear")).read(ctx)
    assert got is None
