"""The plain reference: its operator is the program's assembled system, it
imports nothing of the program, and the program's answers pass it on the
CPU at the test sizes, through the whole harness."""

import subprocess
import sys

import numpy as np
import pytest
from conftest import LINEAR, ROOT, run_small

from h100bench.reference import box_q1


@pytest.mark.parametrize("cells", [(20, 20, 20), (6, 5, 4)])
def test_operator_is_the_assembled_system(cells):
    from permon_tpu_torch.problems import assembled_system

    A, _ = assembled_system(cells)
    R = box_q1.assembled_operator(cells)
    assert abs(R - A).max() < 1e-14


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import h100bench.reference.box_q1, h100bench.generators.box_patches, h100bench.counts; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'permon_tpu_torch', 'permon_tpu', 'jax', 'torch'}))")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_residual_of_an_exact_answer_is_zero_and_of_a_wrong_one_is_not():
    ref = box_q1.Reference({"problem": {"cells": [6, 5, 4]}})
    n = ref.A.shape[0]
    x = np.linspace(0.5, 1.5, n)
    f = ref.A @ x
    assert ref.check(f, x)["residual"] < 1e-14
    y = x.copy()
    y[n // 2] += 0.1
    assert ref.check(f, y)["residual"] > 1e-3
    assert ref.check(f, np.full(n, np.nan))["residual"] == float("inf")
    assert ref.check(f, x[:-1])["residual"] == float("inf")


@pytest.mark.parametrize("trace", [False, True])
def test_the_program_passes_on_the_cpu(trace):
    workload = LINEAR
    r = run_small(workload, trace=trace)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    kind = "per_layer" if trace else "end_to_end"
    from conftest import small_cell

    names = {m["name"] for m in getattr(small_cell(workload), kind)}
    assert set(r["metrics"]) <= names
    if not trace:
        assert set(r["metrics"]) == names  # every end-to-end metric reads on the CPU too
