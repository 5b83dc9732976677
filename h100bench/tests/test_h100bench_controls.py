"""What decides ``correct`` fails where it must: the configuration's
control (the recipe with its factors one precision lower) and the faults a
load-step cell can have, planted under the harness at the test size."""

import numpy as np
import pytest
from conftest import LINEAR, run_small

from h100bench import harness


def test_the_control_is_not_correct():
    from conftest import small_cell

    for name, over in small_cell(LINEAR).config["controls"].items():
        r = run_small(LINEAR, factory=lambda cell, dev, o=over: harness.make_system(
            cell, dev, o))
        assert not r["correct"], (name, r["checks"])


class Faulty:
    """The real system with a fault planted where the answer is produced."""

    def __init__(self, fault, cell, device):
        self.inner = harness.make_system(cell, device)
        self.fault, self.last = fault, None
        for k in ("spans", "timings", "sync", "to_input", "close", "kplus_apply",
                  "gather_applies", "build_seconds"):
            setattr(self, k, getattr(self.inner, k))

    def solve(self, b_loc):
        if self.fault == "half_the_subdomains":
            b_loc = b_loc.copy()
            b_loc[: len(b_loc) // 2] = 0.0
        ans = self.inner.solve(b_loc)
        if self.fault == "state_unchanged" and self.last is not None:
            ans.x = self.last
        elif self.fault == "answer_altered":
            ans.x = ans.x.copy()
            k = int(np.argmax(np.abs(ans.x)))
            ans.x[k] += 0.1 * ans.x[k]
        self.last = ans.x
        return ans


@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_subdomains", "answer_altered"])
def test_a_fault_is_not_correct(fault):
    r = run_small(LINEAR, factory=lambda cell, dev: Faulty(fault, cell, dev), seconds=1.5)
    assert not r["correct"], r["checks"]


def test_an_unconverged_solve_is_not_correct():
    class Unconverged(Faulty):
        def solve(self, b_loc):
            ans = self.inner.solve(b_loc)
            ans.ok = False
            return ans

    r = run_small(LINEAR, factory=lambda cell, dev: Unconverged(None, cell, dev))
    assert not r["correct"] and r["checks"]["failed_solves"]["value"] >= 1
