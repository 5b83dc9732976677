"""feti_large's default recipe (f32 factors + 2 refinement steps, one f64
primal defect pass, rtol 1e-5) through the JAX example and the port's on
the CPU, one line each: the dual CG counts of every pass and the assembled
residual.

    python scripts/feti_large_counts.py [ncells ...]            # main(ncells, 2)
    python scripts/feti_large_counts.py elasticity [ncells ...]  # main_elasticity(ncells, 2)

ncells 6 and 24 (main's default) by default, 16 (its default) for
elasticity.  The JAX example returns only its last pass: its first comes
from a second call with ``primal_refine=0`` (main) and is not printed for
main_elasticity, which has no such argument.
"""

import contextlib
import io
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def quiet(fn):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn()


def main():
    import jax
    import torch

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(int(os.environ.get("COUNTS_THREADS", "2")))
    from examples import feti_large as jx
    from permon_tpu_torch.examples import feti_large as pt

    args = sys.argv[1:]
    elasticity = bool(args) and args[0] == "elasticity"
    sizes = [int(a) for a in args[elasticity:]] or ([16] if elasticity else [6, 24])
    for n in sizes:
        if elasticity:
            rj = quiet(lambda: jx.main_elasticity(n, 2))
            rt = quiet(lambda: pt.main_elasticity(n, 2, device="cpu"))
            first, resj, rest = "", None, None
        else:
            rj, resj = quiet(lambda: jx.main(n, 2))
            rt, rest = quiet(lambda: pt.main(n, 2, device="cpu"))
            r0 = quiet(lambda: jx.main(n, 2, primal_refine=0, verify=False))[0]
            first = f"first pass {int(r0.result.iterations)}, "
        dx = float(np.abs(np.asarray(rj.x_global) - rt.x_global).max())
        print(f"{'main_elasticity' if elasticity else 'main'}({n}, 2): JAX example {first}"
              f"last pass {int(rj.result.iterations)}"
              + (f", residual {resj:.3e}" if resj is not None else "")
              + f"; port passes {[int(r.iterations) for r in rt.results]}"
              + (f", residual {rest:.3e}" if rest is not None else "")
              + f"; max |x_port - x_JAX| {dx:.3e}", flush=True)


if __name__ == "__main__":
    main()
