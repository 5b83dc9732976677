"""SMALBE proper on elastic contact, one outer iteration a line, through the
JAX package or the PyTorch port on the CPU (ROADMAP fault C2).

    python scripts/c2_smalbe_compare.py jax   [cells] [grid] [f32]
    python scripts/c2_smalbe_compare.py torch [cells] [grid] [f32]

cells 'cx,cy,cz' (default 36,36,87: 361,416 dofs, the size of
``chip_smoke.py --only=9c``), grid 'gx,gy,gz' (default 4,4,2).  The recipe
is that of phase 9c: ``build_obstacle_elasticity(cells, grid)``, nonred
gluing, rigid-body nullspace, deterministic, coarse='sparse', the clamped
face in the Hessian, ``project=False`` with SMALXE's rtol_E 0.1, rtol 1e-5;
f64 factors (``--9c-f64``) unless ``f32`` is given (f32 factors + 2
refinement steps).

Each inner solve prints one ``[c2] outer`` line (the same format as phase
9c): the outer iteration, the inner iterations and reason of its MPRGP
solve, the M1 and rho it ran with (an update shows as a change on the
next line), the last inner test's G, E = ||Bu|| / rtol_E and max(G, E),
and the state; SMALXE's own per-outer monitor (``monitor_outer``) prints
its block after each.  Both packages are driven through the same
``feti_solve_sparse``; the line is printed by a wrapper around the
``mprgp`` that the SMALXE module calls, so neither package is changed
(``torch_c2_log`` is the port's wrapper, which phase 9c uses too; the JAX
package's prints from inside its traced loop).
"""

import contextlib
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

LINE = ("[c2] outer {k:>3}: inner {i:>5} reason {r:>2}  M1 {m:.6e}  rho {rho:.6e}  "
        "G {g:.6e}  E {e:.6e}  max(G,E) {rn:.6e}  state {s}")


def _ints(s):
    return tuple(int(v) for v in s.split(","))


def run_jax(cells, grid, f32):
    import jax
    import jax.numpy as jnp

    import permon_tpu.solvers.smalxe as sm
    from examples.feti_large import build_obstacle_elasticity
    from permon_tpu.core.convergence import Tolerances
    from permon_tpu.feti.large import feti_solve_sparse
    from permon_tpu.feti.solve import FetiOptions

    jax.config.update("jax_platforms", "cpu")
    orig = sm.mprgp

    def logged(qp_inner, *args, **kw):
        res = orig(qp_inner, *args, **kw)
        a = res.aux
        jax.debug.print(LINE, k=kw["conv_aux"].outer_it + 1, i=res.iterations, r=res.reason,
                        m=kw["conv_aux"].M1, rho=qp_inner.A.rho, g=res.rnorm, e=a.enorm,
                        rn=a.outer_rnorm, s=a.state, ordered=True)
        return res

    sm.mprgp = logged
    prob, BI, cI, _ = build_obstacle_elasticity(cells, grid)
    factors = dict(kplus_dtype=jnp.float32, kplus_refine=2) if f32 else {}
    return prob, lambda opts, tol: feti_solve_sparse(prob, opts, tol, BI=BI, cI=cI, **factors), \
        FetiOptions, sm.SMALXEOptions, Tolerances


@contextlib.contextmanager
def torch_c2_log(emit):
    """While the block runs, ``emit`` one LINE per inner solve of the port's
    SMALXE: a wrapper around the ``mprgp`` that permon_tpu_torch.solvers.smalxe
    calls, taken out again after the block."""
    import permon_tpu_torch.solvers.smalxe as sm

    orig = sm.mprgp

    def logged(qp_inner, *args, **kw):
        res = orig(qp_inner, *args, **kw)
        a = res.aux
        emit(LINE.format(k=kw["conv_aux"].outer_it + 1, i=res.iterations, r=res.reason,
                         m=float(kw["conv_aux"].M1), rho=float(qp_inner.A.rho),
                         g=float(res.rnorm), e=float(a.enorm), rn=float(a.outer_rnorm),
                         s=a.state))
        return res

    sm.mprgp = logged
    try:
        yield
    finally:
        sm.mprgp = orig


def run_torch(cells, grid, f32):
    import torch

    from permon_tpu_torch.core.convergence import Tolerances
    from permon_tpu_torch.feti.large import feti_solve_sparse
    from permon_tpu_torch.feti.solve import FetiOptions
    from permon_tpu_torch.problems import build_obstacle_elasticity
    from permon_tpu_torch.solvers.smalxe import SMALXEOptions

    torch.set_num_threads(int(os.environ.get("C2_THREADS", "3")))
    prob, BI, cI, _ = build_obstacle_elasticity(cells, grid)
    factors = dict(kplus_dtype=torch.float32, kplus_refine=2) if f32 else {}

    def solve(opts, tol):
        with torch_c2_log(lambda line: print(line, flush=True)):
            return feti_solve_sparse(prob, opts, tol, BI=BI, cI=cI, device="cpu", **factors)

    return prob, solve, FetiOptions, SMALXEOptions, Tolerances


def main():
    pkg = sys.argv[1]
    cells = _ints(sys.argv[2]) if len(sys.argv) > 2 else (36, 36, 87)
    grid = _ints(sys.argv[3]) if len(sys.argv) > 3 else (4, 4, 2)
    f32 = "f32" in sys.argv[4:]
    t0 = time.perf_counter()
    prob, solve, FetiOptions, SMALXEOptions, Tolerances = \
        (run_jax if pkg == "jax" else run_torch)(cells, grid, f32)
    print(f"[c2] {pkg}: {prob.n_global} dofs, {prob.ns} subdomains, "
          f"{'f32 + 2 refinement steps' if f32 else 'f64'} factors, built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    opts = FetiOptions(gluing="nonred", nullspace="rbm", deterministic=True, coarse="sparse",
                       dirichlet_by_B=False, project=False,
                       smalxe=SMALXEOptions(rtol_E=0.1, monitor_outer=True))
    t0 = time.perf_counter()
    r = solve(opts, Tolerances(rtol=1e-5))
    res = r.result
    x = np.asarray(r.x_global)
    print(f"[c2] {pkg}: reason {int(res.reason)}, outer {int(res.iterations)}, inner "
          f"{int(res.inner_iterations)}, products {int(res.nmv)}, M1 updates "
          f"{int(res.M1_updates)}, rho updates {int(res.rho_updates)}, inner reason "
          f"{int(res.inner_reason)}, max|x| {float(np.abs(x).max()):.6e}, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
