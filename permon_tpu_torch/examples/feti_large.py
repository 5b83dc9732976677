"""Large-scale TFETI — 3-D Poisson at 10^5-10^6+ dofs on one card, the port
of ``examples/feti_large.py``.

The sparse-blocks analog of feti_ex71 (same Q1 elements, same DMDA
upper-corner element ownership, same x=0 Dirichlet face and rhs = 1
convention — reference: src/tutorials/feti/ex71.c) built WITHOUT dense
per-subdomain matrices (``permon_tpu_torch.problems.build_sparse``) and
solved through permon_tpu_torch.feti.large (band Cholesky K+, projected
dual CG; B, B' and the reassembly on the gather kernel,
csrc/gather_apply.cu).

The north-star configuration:

    python -m permon_tpu_torch.examples.feti_large 100 4   # 101^3 = 1,030,301 dofs,
                                                           # 64 subdomains of 26^3
    python -m permon_tpu_torch.examples.feti_large elasticity 16 2 [contact]

f32 factors + 2 refinement steps and one f64 primal defect pass by default.
Verification at any size: the global solution's residual against the
assembled 7-point system, printed as ||Ax-b||/||b||.  The solve times are
read from CUDA events on the card (the host clock with ``--device cpu``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import resolve_device
from ..problems import (assembled_elasticity_system, assembled_system,
                        build_obstacle_elasticity, build_sparse, build_sparse_elasticity)


class _Clock:
    """Seconds of device work on ``device``: CUDA events around the span
    (read after the end event completes), the host clock on the CPU."""

    def __init__(self, device=None):
        self.dev = resolve_device(device)
        if self.dev.type == "cuda":
            self._t0 = torch.cuda.Event(enable_timing=True)
            self._t0.record(torch.cuda.current_stream(self.dev))
        else:
            self._t0 = time.perf_counter()

    def seconds(self) -> float:
        if self.dev.type == "cuda":
            t1 = torch.cuda.Event(enable_timing=True)
            t1.record(torch.cuda.current_stream(self.dev))
            t1.synchronize()
            return self._t0.elapsed_time(t1) / 1e3
        return time.perf_counter() - self._t0


def main(ncells: int = 24, g: int = 2, f32: bool = True, rtol: float = 1e-5,
         verify: bool = None, primal_refine: int = 1, device=None):
    from ..core.convergence import Tolerances
    from ..feti.large import feti_solve_sparse
    from ..feti.solve import FetiOptions

    cells = (ncells,) * 3
    t0 = time.perf_counter()
    prob = build_sparse(cells, (g,) * 3)
    N = prob.n_global
    t1 = time.perf_counter()
    print(f"assembled {N} dofs, {prob.ns} subdomains of <= {prob.nl} dofs "
          f"({t1 - t0:.1f} s host)")
    # f32 factors on the device, the dual CG on cheap unrefined applies, the
    # post-solve on refined applies, and one f64 primal defect-correction
    # pass over the whole FETI solve for an f64-grade assembled residual
    kw = (
        dict(kplus_dtype=torch.float32, kplus_refine=2, primal_refine=primal_refine)
        if f32 else {}
    )
    clock = _Clock(device)
    res = feti_solve_sparse(
        prob, FetiOptions(gluing="nonred"), tol=Tolerances(rtol=rtol), device=device, **kw
    )
    t2 = clock.seconds()
    r = res.result
    print(f"dual CG: {int(r.iterations)} iterations, reason {int(r.reason)}, "
          f"rnorm {float(r.rnorm):.3e} ({t2:.1f} s incl. factorization)")
    if verify is None:
        verify = N <= 1.2e6
    if verify:
        A, b = assembled_system(cells)
        resid = np.linalg.norm(A @ res.x_global - b) / np.linalg.norm(b)
        print(f"||Ax-b||/||b|| = {resid:.3e} (assembled 7-point system)")
        return res, resid
    return res, None


def main_elasticity(ncells: int = 16, g: int = 2, rtol: float = 1e-5,
                    contact: bool = False, device=None):
    """3-D Q1 elasticity (optionally with the far-face plane obstacle)
    through the large path: rbm nullspace, in-Hessian clamped face."""
    from ..core.convergence import Tolerances
    from ..feti.large import FetiSolverSparse
    from ..feti.solve import FetiOptions

    cells, grid = (ncells,) * 3, (g,) * 3
    t0 = time.perf_counter()
    if contact:
        prob, BI, cI, gap = build_obstacle_elasticity(cells, grid)
    else:
        prob = build_sparse_elasticity(cells, grid)
        BI = cI = None
    N = prob.n_global
    print(f"assembled {N} elasticity dofs, {prob.ns} subdomains "
          f"({time.perf_counter() - t0:.1f} s host)")
    clock = _Clock(device)
    res = FetiSolverSparse(
        prob,
        FetiOptions(gluing="nonred", nullspace="rbm", dirichlet_by_B=False),
        kplus_dtype=torch.float32, kplus_refine=2,
        primal_refine=0 if contact else 1, BI=BI, cI=cI, device=device,
    ).solve(tol=Tolerances(rtol=rtol))
    r = res.result
    print(f"{'SMALXE' if contact else 'dual CG'}: {int(r.iterations)} "
          f"iterations, reason {int(r.reason)} ({clock.seconds():.1f} s "
          "incl. factorization)")
    if not contact and N <= 3e5:
        K, b = assembled_elasticity_system(cells)
        resid = np.linalg.norm(K @ res.x_global - b) / np.linalg.norm(b)
        print(f"||Kx-b||/||b|| = {resid:.3e} (assembled Q1 system)")
    return res


if __name__ == "__main__":
    from . import split_device

    device, args = split_device()
    if args and args[0] == "elasticity":
        nc = int(args[1]) if len(args) > 1 else 16
        g = int(args[2]) if len(args) > 2 else 2
        main_elasticity(nc, g, contact="contact" in args, device=device)
    else:
        nc = int(args[0]) if args else 24
        g = int(args[1]) if len(args) > 1 else 2
        main(nc, g, device=device)
