#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (permon_tpu_torch) on one GPU.

    python3 chip_smoke.py

Drives the port's main path — the large-path linear TFETI solve
(FetiSolverSparse) on the 101^3 = 1,030,301-dof 3-D Poisson north star
(64 subdomains) — and checks it:

1. a CUDA device is visible; prints the card's name and power limit;
2. builds the CUDA gather kernel from permon_tpu_torch/csrc (nvcc);
3. kernel phase: the north-star B / B' gather tables through the kernel
   against the plain PyTorch version, bitwise (torch.equal), f32 and f64,
   with kernel and plain times from CUDA events;
4. the 64-subdomain 21^3 twin: reason 2, assembled residual < 1e-8,
   22-24 dual CG iterations (23 on the CPU);
5. the north star: factorize, solve, re-solve with 1.5 b; reason 2 on
   both, assembled residual <= 1e-6 (scipy f64), linear re-solve, and the
   gather kernel launched on the main path.

Every phase raises on failure (exit code != 0).  The line before the last
is the kernel JSON record, the last line {"ok": true, "device": ...}.
Imports nothing of JAX or of the JAX package permon_tpu.
"""

import json
import os
import subprocess
import sys
import time

NORTH_STAR = ((100,) * 3, (4,) * 3)
TWIN = ((20,) * 3, (4,) * 3)


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps=20, warmup=3):
    """Mean milliseconds of fn() on the current stream (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_kernel(prob, dev):
    """Kernel vs plain on the exact north-star gather tables."""
    import numpy as np
    import scipy.sparse as sp
    import torch

    from permon_tpu_torch.feti.large import band_layout, gluing_extension, padded
    from permon_tpu_torch.feti.solve import FetiOptions

    _, _, nlp = band_layout([sp.csr_matrix(K) for K in prob.K_blocks], prob.nl)
    BE = gluing_extension(padded(prob, nlp).l2g, FetiOptions(gluing="nonred"), dev)
    log(f"[kernel] B tables: gB {tuple(BE.gB.idx.shape)}, gBt {tuple(BE.gBt.idx.shape)}"
        f" + overflow {tuple(BE.gBt.ov_idx.shape)}")
    rng = np.random.RandomState(0)
    u = rng.standard_normal(BE.shape[1])
    lam = rng.standard_normal(BE.shape[0])
    max_err, rec = 0.0, {}
    for vdt, xdt in ((torch.float64, torch.float64), (torch.float32, torch.float32),
                     (torch.float64, torch.float32)):
        for name, tab, x in (("mv", BE.gB, u), ("rmv", BE.gBt, lam)):
            tab = tab.replace(vals=tab.vals.to(vdt),
                              ov_vals=None if tab.ov_vals is None else tab.ov_vals.to(vdt))
            plain = tab.replace(kernel=False)
            xt = torch.as_tensor(x, dtype=xdt, device=dev)
            got, ref = tab.apply(xt), plain.apply(xt)
            torch.cuda.synchronize()
            if got.dtype != torch.promote_types(vdt, xdt) or not torch.equal(got, ref):
                err = float((got.double() - ref.double()).abs().max())
                raise AssertionError(f"gather kernel != plain for {name} vals {vdt} "
                                     f"x {xdt}: max abs err {err}")
            max_err = max(max_err, float((got.double() - ref.double()).abs().max()))
            k_ms, p_ms = cuda_ms(lambda: tab.apply(xt)), cuda_ms(lambda: plain.apply(xt))
            key = f"{name} vals={str(vdt)[6:]} x={str(xdt)[6:]}"
            rec[key] = (k_ms, p_ms)
            log(f"[kernel] {key}: bitwise equal; kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")
    f64 = [rec["mv vals=float64 x=float64"], rec["rmv vals=float64 x=float64"]]
    return max_err, sum(k for k, _ in f64), sum(p for _, p in f64)


def phase_twin(dev):
    import numpy as np
    import torch

    from permon_tpu_torch.core.convergence import Tolerances
    from permon_tpu_torch.feti.large import feti_solve_sparse
    from permon_tpu_torch.feti.solve import FetiOptions
    from permon_tpu_torch.problems import assembled_system, build_sparse

    cells, grid = TWIN
    res = feti_solve_sparse(build_sparse(cells, grid), FetiOptions(gluing="nonred"),
                            tol=Tolerances(rtol=1e-5), kplus_dtype=torch.float32,
                            kplus_refine=2, primal_refine=1, device=dev)
    A, b = assembled_system(cells)
    resid = np.linalg.norm(A @ res.x_global - b) / np.linalg.norm(b)
    its = res.result.iterations
    log(f"[twin] {cells} / {grid}: reason {res.result.reason}, {its} dual CG iterations "
        f"(23 on the CPU), assembled residual {resid:.3e}")
    if res.result.reason != 2 or not resid < 1e-8 or not 22 <= its <= 24:
        raise AssertionError(f"twin failed: reason {res.result.reason}, its {its}, "
                             f"residual {resid}")


def phase_main(prob, t_host_prob, dev):
    import numpy as np
    import torch

    from permon_tpu_torch.core.convergence import Tolerances
    from permon_tpu_torch.core.sell import gather_apply
    from permon_tpu_torch.feti.large import FetiSolverSparse
    from permon_tpu_torch.feti.solve import FetiOptions
    from permon_tpu_torch.problems import assembled_system

    cells, _ = NORTH_STAR
    tol = Tolerances(rtol=1e-5)
    torch.cuda.reset_peak_memory_stats(dev)
    gather_apply.launches = 0  # count the main path's launches only
    solver = FetiSolverSparse(prob, FetiOptions(gluing="nonred", deterministic=True),
                              kplus_dtype=torch.float32, kplus_refine=2, primal_refine=1,
                              device=dev)
    t0 = time.perf_counter()
    r1 = solver.solve(tol=tol)
    torch.cuda.synchronize(dev)
    t1 = time.perf_counter()
    r2 = solver.solve(b_loc=prob.b_loc * 1.5, tol=tol)
    torch.cuda.synchronize(dev)
    t2 = time.perf_counter()
    launches = gather_apply.launches
    peak = torch.cuda.max_memory_allocated(dev)

    its1 = [r.iterations for r in r1.results]
    its2 = [r.iterations for r in r2.results]
    A, b = assembled_system(cells)
    resid = np.linalg.norm(A @ r1.x_global - b) / np.linalg.norm(b)
    lin = np.abs(r2.x_global - 1.5 * r1.x_global).max() / np.abs(r2.x_global).max()
    log(f"[main] {prob.n_global} dofs, {prob.ns} subdomains of <= {prob.nl} dofs, "
        f"NB {solver.NB}, k {solver.qp.R.shape[1]}, m {solver.qp.BE.shape[0]}")
    log(f"[main] host setup {t_host_prob + solver.timings['host_setup_s']:.3f} s "
        f"(problem build {t_host_prob:.3f} s), factorization "
        f"{solver.timings['factor_s']:.3f} s")
    log(f"[main] first solve {t1 - t0:.3f} s, dual CG iterations {its1} "
        f"(reasons {[r.reason for r in r1.results]}); warm re-solve {t2 - t1:.3f} s, "
        f"iterations {its2} (reasons {[r.reason for r in r2.results]})")
    log(f"[main] time per dual iteration (warm re-solve / its) "
        f"{1e3 * (t2 - t1) / sum(its2):.3f} ms")
    log(f"[main] assembled residual {resid:.3e}; linearity |x2 - 1.5 x1|/|x2| {lin:.3e}; "
        f"peak device memory {peak / 2**30:.3f} GiB; gather_apply launches {launches}")
    if not all(r.reason == 2 for r in r1.results + r2.results):
        raise AssertionError("north star: a dual solve did not reach reason 2")
    if not resid <= 1e-6:
        raise AssertionError(f"north star: assembled residual {resid} > 1e-6")
    if not lin <= 1e-6:
        raise AssertionError(f"north star: re-solve not linear ({lin})")
    if launches <= 0:
        raise AssertionError("north star: the gather kernel was never launched")

    # where the time of one dual iteration goes (CUDA events, same operators)
    qp, pf = solver.qp, solver._pf
    lam = torch.as_tensor(np.random.RandomState(1).standard_normal(qp.BE.shape[0]),
                          device=dev)
    v = qp.BE.rmv(lam)
    parts = {
        "B' (rmv)": lambda: qp.BE.rmv(lam),
        "K+ (f32, unrefined)": lambda: solver.kplus.mv(v),
        "B (mv)": lambda: qp.BE.mv(v),
        "P (coarse projector)": lambda: pf.apply_p(lam),
        "K+ refined (2 steps)": lambda: solver.kplus_post.mv(v),
    }
    for name, fn in parts.items():
        log(f"[main] breakdown {name}: {cuda_ms(fn, reps=5, warmup=1):.3f} ms")
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from permon_tpu_torch.core import sell
    from permon_tpu_torch.problems import build_sparse

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    log(f"[device] {smi.stdout.strip().splitlines()[0]}")
    log(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    sell.build(force=True)
    log(f"[build] gather_apply.cu built in {time.perf_counter() - t0:.2f} s")
    for line in sell.BUILD_INFO.get("log", "").splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")

    t0 = time.perf_counter()
    prob = build_sparse(*NORTH_STAR)
    t_host_prob = time.perf_counter() - t0
    max_err, k_ms, p_ms = phase_kernel(prob, dev)
    phase_twin(dev)
    launches = phase_main(prob, t_host_prob, dev)

    print(json.dumps({"kernels": [{
        "name": "gather_apply", "route": "cuda",
        "source": "permon_tpu_torch/csrc/gather_apply.cu",
        "replaces": "permon_tpu/core/sell.py:417",
        "launches": launches, "max_abs_err": max_err,
        "ms": k_ms, "plain_ms": p_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
