"""The port's command-line examples (``permon_tpu_torch/examples/``): the
command line itself.  ``--device cpu`` is taken out of the arguments
wherever it stands, the module run as a program prints what its ``main``
prints, and without a device an example asks for the card.

Each example's ``main`` against the JAX package's (``check_example`` of
tests/torch_example_parity.py, ``test_example_matches_jax_example``) runs in
the test file of its path, beside the cases whose JAX programs it shares:
ex1 / ex2 / jbearing2 in tests/test_torch_mprgp.py, ex3 in
tests/test_torch_factor.py, svm in tests/test_torch_user.py, feti_ex1 /
feti_contact / feti_ex71 in tests/test_torch_feti_dense.py, feti_large and
feti_large-f32 in tests/test_torch_feti_large.py.
"""

import pytest
import torch

from permon_tpu_torch.examples import split_device
from torch_example_parity import captured

torch.set_num_threads(2)


def test_command_line_device_and_default():
    """``--device`` is taken out of a command line wherever it stands; the
    module run as a program prints what its main prints; without a device
    an example asks for the card, never the CPU."""
    import os
    import subprocess
    import sys

    assert split_device(["100", "--device", "cpu"]) == ("cpu", ["100"])
    assert split_device(["--device=cpu", "elasticity", "lumped"]) == (
        "cpu", ["elasticity", "lumped"])
    assert split_device(["24", "2"]) == (None, ["24", "2"])
    from permon_tpu_torch.examples import ex1

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    run = subprocess.run([sys.executable, "-m", "permon_tpu_torch.examples.ex1", "30", "--device",
                          "cpu"], cwd=root, capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    assert run.stdout == captured(lambda: ex1.main(30, device="cpu"))[1]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ex1.main(10, view=False)
