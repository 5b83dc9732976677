"""On a card: a test-size cell through the whole harness, traced, with
the device's numbers read from the trace.  Skips without a card.

    python -m pytest h100bench/tests -m cuda
"""

import pytest
from conftest import LINEAR


@pytest.mark.cuda
def test_a_traced_cell_on_the_card(cuda_device):
    import time

    from conftest import small_cell

    from h100bench import harness

    r = harness.run_cell(small_cell(LINEAR), 7, 1.0, True, cuda_device, time.perf_counter())
    assert r["correct"], r["checks"]
    dev = r["device"]
    assert dev["platform"] == "gpu" and 0 < dev["busy_s"] <= dev["window_s"] * 1.01
    assert 0 < r["metrics"]["idle_share.linear"]["value"] < 100
    assert 0 < r["metrics"]["kplus_roofline.linear"]["value"] <= 105
    assert r["breakdown"]["device_ops"]
