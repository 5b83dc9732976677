"""feti_large's default recipe (f32 factors, 2 refinement steps, one f64
primal defect pass, rtol 1e-5) through the JAX package and the port on the
CPU, taken apart pass by pass: where the two packages' dual CG counts part
and why.

    PYTHONPATH=. python defect_pass_counts.py [ncells ...] [elasticity] [det] [scaled]

For each size (12 and 24 by default; elasticity uses
``build_sparse_elasticity``, ``det`` runs under ``deterministic_mode``) one
line of :func:`defect_pass_counts`.  With ``scaled``, one line of
:func:`scaled_counts` instead: each package's counts on its own factors with
the right-hand side scaled by a few numbers that are not powers of two (the
same problem in exact arithmetic, other last bits).  ``COUNTS_THREADS`` sets
torch's CPU threads (2 by default).
"""

import dataclasses
import os
import sys

import numpy as np

SCALES = (1.0, 3.0, 0.3, 7.0, 1.1)


def _prepare(n, elasticity, deterministic):
    """Both packages' problems and assembled QPs at n^3 cells on (2, 2, 2),
    the port's factors recomputed with the recurrence in f32 (as the JAX
    package runs it), and one runner per package: ``run(kplus, scale)`` ->
    the dual counts [first pass, defect pass] with b (and cE) multiplied by
    ``scale``, and their ||Pr|| histories."""
    import jax.numpy as jnp
    import torch

    import examples.feti_large as jfl
    import permon_tpu.feti.large as jlarge
    from permon_tpu.core.convergence import Tolerances as JTol
    from permon_tpu.core.detred import deterministic_mode as jdm
    from permon_tpu.feti.solve import FetiOptions as JFO
    import permon_tpu_torch.feti.large as tlarge
    import permon_tpu_torch.problems as tprob
    from permon_tpu_torch.core.band import BandCholInv
    from permon_tpu_torch.core.convergence import Tolerances
    from permon_tpu_torch.core.detred import deterministic_mode as tdm
    from permon_tpu_torch.core.precision import cast_floats
    from permon_tpu_torch.feti.solve import FetiOptions

    cells, grid = (n,) * 3, (2, 2, 2)
    kw = dict(gluing="nonred", deterministic=deterministic)
    if elasticity:
        kw.update(nullspace="rbm", dirichlet_by_B=False)
        pj, pt = jfl.build_sparse_elasticity(cells, grid), tprob.build_sparse_elasticity(cells, grid)
    else:
        pj, pt = jfl.build_sparse(cells, grid), tprob.build_sparse(cells, grid)
    jo, to = JFO(**kw), FetiOptions(**kw)
    qj, kj, _, ej = jlarge.assemble_qp_sparse(pj, jo, kplus_dtype=jnp.float32, kplus_refine=2)
    qt, kt, NB, et = tlarge.assemble_qp_sparse(pt, to, kplus_dtype=torch.float32,
                                               kplus_refine=2, device="cpu")
    pj = ej.eliminated_prob(pj) if ej is not None else pj
    pt = et.eliminated_prob(pt) if et is not None else pt
    k32 = BandCholInv.from_blockdia(cast_floats(kt.op, torch.float32), NB, dtype=torch.float32)
    kt = kt.replace(Dinv=k32.Dinv, F=k32.F)

    def scaled(prob, qp, s):
        # linear in (b, cE): the scaled problem's solution is s x
        cE = None if qp.cE is None else s * qp.cE
        return dataclasses.replace(prob, b_loc=s * prob.b_loc), qp.replace(b=s * qp.b, cE=cE)

    def histories(results):  # None where cg kept no history
        hs = [np.asarray(r.rnorm_history) for r in results]
        return [h[: int(r.iterations) + 1] if h.ndim else None for h, r in zip(hs, results)]

    def jrun(kp, s=1.0):
        """The JAX result keeps only its last pass: the first comes from a
        run without the defect pass."""
        prob, qp = scaled(pj, qj, s)
        out = []
        for passes in (0, 1):
            with jdm(deterministic):
                out.append(jlarge._run_prepared_sparse(prob, jo, JTol(rtol=1e-5), qp,
                                                       kp.replace(refine=0), kp, passes).result)
        return [int(r.iterations) for r in out], histories(out)

    def trun(kp, s=1.0):
        prob, qp = scaled(pt, qt, s)
        with tdm(deterministic):
            res = tlarge._run_prepared_sparse(prob, to, Tolerances(rtol=1e-5), qp,
                                              kp.replace(refine=0), kp, 1)
        return [int(r.iterations) for r in res.results], histories(res.results)

    return qt, kj, kt, jrun, trun


def _with_histories(fn):
    """fn() with both packages' feti/large ``cg`` keeping 400 ||Pr|| entries
    (``_run_prepared_sparse`` takes no history argument)."""
    import permon_tpu.feti.large as jlarge
    import permon_tpu_torch.feti.large as tlarge

    jcg, tcg = jlarge.cg, tlarge.cg
    try:
        jlarge.cg = lambda *a, **k: jcg(*a, history=400, **k)
        tlarge.cg = lambda *a, **k: tcg(*a, history=400, **k)
        return fn()
    finally:
        jlarge.cg, tlarge.cg = jcg, tcg


def defect_pass_counts(n: int, elasticity: bool = False, deterministic: bool = False):
    """Each package's ``_run_prepared_sparse`` on its own f32 factors and on
    the other package's.  Returns the dual counts [first pass, defect pass]
    of the four runs, the unrefined K+ of the two packages on the SAME
    factors and the refined K+ (2 steps) each on its own factors (max
    difference over max), the factors' difference, the iteration of the
    first pass where the port's ||Pr|| on the JAX factors first parts from
    the JAX package's by more than 1e-3, and how far apart the two runs'
    defect passes start (their first ||Pr||, relative)."""
    import jax.numpy as jnp
    import torch

    qt, kj, kt, jrun, trun = _prepare(n, elasticity, deterministic)
    Dj, Fj = np.array(kj.Dinv), np.array(kj.F)
    Dt, Ft = kt.Dinv.numpy().copy(), kt.F.numpy().copy()
    kt_j = kt.replace(Dinv=torch.as_tensor(Dj), F=torch.as_tensor(Fj))
    kj_t = kj.replace(Dinv=jnp.asarray(Dt), F=jnp.asarray(Ft))
    runs = _with_histories(lambda: {
        "JAX": jrun(kj), "JAX on the port's factors": jrun(kj_t),
        "port": trun(kt), "port on the JAX factors": trun(kt_j)})
    x = np.random.RandomState(0).standard_normal(qt.A.shape[0])
    yj = np.asarray(kj.replace(refine=0).mv(jnp.asarray(x)))
    yt = kt_j.replace(refine=0).mv(torch.as_tensor(x)).numpy()
    zj = np.asarray(kj.mv(jnp.asarray(x)))
    zt = kt.mv(torch.as_tensor(x)).numpy()
    (h0, h1), (a0, a1) = runs["JAX"][1], runs["port on the JAX factors"][1]
    m = min(len(a0), len(h0))
    apart = np.flatnonzero(np.abs(a0[:m] - h0[:m]) > 1e-3 * h0[:m])
    return dict(
        counts={k: v[0] for k, v in runs.items()},
        kplus_same_factors=float(np.abs(yt - yj).max() / np.abs(yj).max()),
        kplus_refined=float(np.abs(zt - zj).max() / np.abs(zj).max()),
        factors=float(max(np.abs(Dt - Dj).max() / np.abs(Dj).max(),
                          np.abs(Ft - Fj).max() / np.abs(Fj).max())),
        first_pass_parts_at=int(apart[0]) if len(apart) else None,
        defect_pass_starts_apart=float(abs(a1[0] - h1[0]) / h1[0]),
    )


def scaled_counts(n: int, elasticity: bool = False, deterministic: bool = False,
                  scales=SCALES):
    """{package: [[first pass, defect pass] for each scale]}: each package
    on its own f32 factors (the port's recurrence in f32) with b (and cE)
    multiplied by each of ``scales``."""
    _, kj, kt, jrun, trun = _prepare(n, elasticity, deterministic)
    return {"JAX": [jrun(kj, s)[0] for s in scales],
            "port (f32 recurrence)": [trun(kt, s)[0] for s in scales]}


def main():
    import jax
    import torch

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(int(os.environ.get("COUNTS_THREADS", "2")))
    args = sys.argv[1:]
    det, el = "det" in args, "elasticity" in args
    name = f"{'elasticity ' if el else ''}{{n}}^3 deterministic={det}"
    for n in [int(a) for a in args if a.isdigit()] or [12, 24]:
        if "scaled" in args:
            r = scaled_counts(n, elasticity=el, deterministic=det)
            print(name.format(n=n) + f", b scaled by {list(SCALES)}: " + "; ".join(
                f"{k} {v}" for k, v in r.items()), flush=True)
            continue
        r = defect_pass_counts(n, elasticity=el, deterministic=det)
        print(name.format(n=n) + ": " + ", ".join(f"{k} {v}" for k, v in r["counts"].items())
              + f"; factors apart {r['factors']:.2e}, unrefined K+ on the same factors apart "
              f"{r['kplus_same_factors']:.2e}, refined K+ apart {r['kplus_refined']:.2e}, first "
              f"pass parts (1e-3) at iteration {r['first_pass_parts_at']}, defect pass starts "
              f"{r['defect_pass_starts_apart']:.2e} apart", flush=True)


if __name__ == "__main__":
    main()
