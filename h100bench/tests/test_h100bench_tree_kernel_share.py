"""The share of fixed-tree reductions that ran as the kernel
(layer_metrics/tree_kernel_share.linear.py), read from the program's spans:
100 where every tree launched the kernel, 50 where half did, nothing where
no tree opened a span."""

import pytest
from conftest import LINEAR, small_cell

from h100bench import harness, program_spans


def _read(spans):
    ctx = harness.Context(cell=small_cell(LINEAR), setup_s=0.0, window_s=1.0, steps=[],
                          spans={}, timings={}, cuda=True)
    ctx.program_spans = spans
    return harness.load_module(harness.metric_path("layer_metrics",
                                                   "tree_kernel_share.linear")).read(ctx)


@pytest.mark.parametrize("trees,kernels,share", [(8, 8, 100.0), (8, 4, 50.0), (0, 0, None)])
def test_tree_kernel_share_counts_the_kernel_trees(trees, kernels, share):
    events = {}
    if trees:
        events["detred.sum"] = (trees, 0.002, 0.001)
    if kernels:
        events["detred.kernel"] = (kernels, 0.001, 0.001)
    assert _read(program_spans.Spans(steps=3, wall_s=2.4, events=events, parents={})) == share


@pytest.mark.parametrize("spans", ["none", "empty"])
def test_tree_kernel_share_without_spans_reads_nothing(spans):
    """A probe that failed (none), or a program that opens no span (empty,
    as the parent of the kernel), leaves the metric out of the line."""
    got = _read(None if spans == "none" else
                program_spans.Spans(steps=3, wall_s=2.4, events={}, parents={}))
    assert got is None
