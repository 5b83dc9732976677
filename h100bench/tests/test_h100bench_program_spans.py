"""The per-layer metrics that read the program's own spans
(program_spans.py): through the harness's CPU path they read the probe's
steps, run in a process of their own; the K+ share of its roofline waits
for a card; a program without the spans gives them nothing to read,
without an error."""

import pytest
from conftest import LINEAR, run_small, small_cell

from h100bench import harness, program_spans

READERS = ["dual_iter_ms.linear", "solve_entry_ms.linear", "kplus_host_ms.linear",
           "host_pace_share.linear"]
ON_A_CARD = ["kplus_span_roofline.linear"]


@pytest.fixture(scope="module")
def traced_line():
    return run_small(LINEAR, trace=True)


def test_the_span_readers_read_on_the_cpu(traced_line):
    r = traced_line
    assert r["correct"], r["checks"]
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert set(READERS) <= set(m) and not set(ON_A_CARD) & set(m)
    assert m["dual_iter_ms.linear"] > 0 and m["kplus_host_ms.linear"] > 0
    assert 0 < m["solve_entry_ms.linear"] and 0 < m["host_pace_share.linear"] <= 100
    # a turn of the loop holds at least the K+ pass of its F apply
    assert m["dual_iter_ms.linear"] > m["kplus_host_ms.linear"]


@pytest.mark.parametrize("name", READERS + ON_A_CARD)
@pytest.mark.parametrize("spans", ["none", "empty"])
def test_a_program_without_spans_reads_nothing(name, spans):
    """A probe that failed (none), or a program that opens no span (empty:
    its aggregates hold none of the names), leaves the metric out."""
    ctx = harness.Context(cell=small_cell(LINEAR), setup_s=0.0, window_s=1.0, steps=[],
                          spans={}, timings={}, cuda=True)
    ctx.program_spans = (None if spans == "none" else
                         program_spans.Spans(steps=3, wall_s=2.4, events={}, parents={}))
    assert harness.load_module(harness.metric_path("layer_metrics", name)).read(ctx) is None
