"""Shared pieces of the benchmark's CPU tests: the cell of BENCHMARK.json
cut to a size a test run holds (the twin of the north star, 21^3 nodes on
4^3 subdomains), driven through the harness on the CPU.

    python -m pytest h100bench/tests -q
"""

import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

LINEAR = "poisson3d-1m.loadsteps"
#: the test size: cells and subdomain grid
CELLS, GRID = (20, 20, 20), (4, 4, 4)


def small_cell(workload: str):
    import torch

    from h100bench import harness

    torch.set_num_threads(2)
    cell = harness.resolve(ROOT, workload)
    cell.config["problem"].update(cells=list(CELLS), grid=list(GRID))
    cell.mix.update(pool=4, check_sample=3, trace_steps=1)
    return cell


def run_small(workload: str, seed: int = 2**31 + 11, trace: bool = False, factory=None,
              seconds: float = 0.1):
    import torch

    from h100bench import harness

    return harness.run_cell(small_cell(workload), seed, seconds, trace, torch.device("cpu"),
                            time.perf_counter(), system_factory=factory)


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided here, when the test runs."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return torch.device("cuda", 0)
