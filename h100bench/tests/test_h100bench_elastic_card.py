"""On a card: the elasticity cell at a test size through the whole
harness, traced: every K+ pass a graph replay, and both roofline shares
read from the device trace, finite and at most 100%. Skips without a
card.

    python -m pytest h100bench/tests -m cuda
"""

import math

import pytest


@pytest.mark.cuda
def test_the_elastic_cell_traced_on_the_card(cuda_device):
    import time

    from test_h100bench_elastic import small_cell

    from h100bench import harness

    r = harness.run_cell(small_cell(), 2**31 + 29, 1.0, True, cuda_device, time.perf_counter())
    assert r["correct"], r["checks"]
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert m["kplus_graph_share.linear"] == 100.0
    for name in ("kplus_roofline.elastic", "projector_roofline.elastic"):
        assert math.isfinite(m[name]) and 0 < m[name] <= 100, (name, m[name])
    assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"] * 1.01
