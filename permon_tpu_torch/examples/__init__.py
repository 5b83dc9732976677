"""Command-line examples of the port: the counterparts of the JAX package's
``examples/`` (the PERMON tutorials ex1, ex2, ex3, jbearing2, feti_ex1,
feti_ex71, the TFETI contact and SVM demos, and the large-path example
feti_large).

Each module has the functions of its JAX twin with the same keyword
arguments plus ``device`` (None: the card), takes the twin's command line
plus ``--device DEV``, and prints the twin's lines::

    python -m permon_tpu_torch.examples.ex1 100
    python -m permon_tpu_torch.examples.feti_large 100 4
    python -m permon_tpu_torch.examples.feti_ex71 elasticity lumped --device cpu
"""

from __future__ import annotations

import sys


def split_device(argv=None):
    """(device, the other arguments) of a command line: ``--device DEV`` or
    ``--device=DEV`` anywhere in it; None (the card) when it is absent."""
    args = list(sys.argv[1:] if argv is None else argv)
    device = None
    for i, a in enumerate(args):
        if a == "--device":
            device = args[i + 1]
            del args[i:i + 2]
            break
        if a.startswith("--device="):
            device = a.split("=", 1)[1]
            del args[i]
            break
    return device, args
