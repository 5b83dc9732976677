"""The traffic is a function of the mix, the configuration and the seed
alone."""

import numpy as np
from conftest import ROOT

from h100bench import harness

CONFIG = {"problem": {"cells": [20, 20, 20]}}
NODES = (21, 21, 21)


def _mix_and_generator(name="loadsteps"):
    mix = harness.read_mix(ROOT / "h100bench" / "traffic" / f"{name}.json")
    return mix, harness.load_module(harness.HERE / "generators" / f"{mix['generator']}.py")


def test_same_seed_same_loads_other_seed_same_pool():
    mix, gen = _mix_and_generator()
    a = gen.steps(mix, CONFIG, 2**31 + 5)
    b = gen.steps(mix, CONFIG, 2**31 + 5)
    c = gen.steps(mix, CONFIG, 2**33 + 1)
    assert a == b and len(a) == mix["pool"]
    assert a != c and sorted(a, key=lambda s: s.index) == sorted(c, key=lambda s: s.index)
    fa = [gen.load(mix, CONFIG, s) for s in a]
    fb = [gen.load(mix, CONFIG, s) for s in b]
    assert all(np.array_equal(x, y) for x, y in zip(fa, fb))
    for f in fa:
        assert f.shape == (np.prod(NODES),) and np.isfinite(f).all()
        assert not f.reshape(NODES[::-1])[:, :, 0].any()  # the clamped face carries no load
    # the loads differ from step to step, not only by a scale
    unit = [f / np.linalg.norm(f) for f in fa]
    assert min(np.abs(u - v).max() for u, v in zip(unit, unit[1:])) > 1e-3
    assert gen.warmup(mix, CONFIG) not in a


def test_negative_and_huge_seeds_are_seeds():
    mix, gen = _mix_and_generator()
    assert gen.steps(mix, CONFIG, -3) == gen.steps(mix, CONFIG, -3)
    assert gen.steps(mix, CONFIG, 2**64 + 9)


def test_a_mix_without_the_harness_keys_is_refused(tmp_path):
    import json

    import pytest

    mix, _ = _mix_and_generator()
    del mix["generator"]
    (tmp_path / "m.json").write_text(json.dumps(mix))
    with pytest.raises(ValueError, match="generator"):
        harness.read_mix(tmp_path / "m.json")
