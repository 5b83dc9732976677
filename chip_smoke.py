#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (permon_tpu_torch) on one GPU.

    python3 chip_smoke.py

Drives the port's main paths and checks them:

- the large-path linear TFETI solve (FetiSolverSparse) on the 101^3 =
  1,030,301-dof 3-D Poisson north star (64 subdomains), on the gather
  kernel (csrc/gather_apply.cu);
- the general QP path (QP.create -> make_operator -> SEll -> solve ->
  MPRGP) on the RCM-ordered 512 x 512 journal bearing (MINPACK-2 DPJB,
  262,144 unknowns), on the SpMV kernel (csrc/sell_mv.cu).  512 is the
  largest power of two at which MPRGP reaches reason 2 inside its 10,000
  iterations (5,789 on an H100; at 1024 x 1024 it takes 39,425 and stops
  on atol, see chip_qp_scaling.py);
- contact on the large path (FetiSolverSparse with inequality rows BI/cI:
  SMALXE around MPRGP on the box-constrained dual) on the 80^3 =
  512,000-dof Poisson box with a ceiling on its far face (6,400 contact
  rows, 64 subdomains; the shape of scripts/northstar_contact.py), with
  the gather kernel applying the tables of BE and of BI;
- 3-D elasticity on the large path, linear and with contact (the north-star
  problem class): the 1,179,750-dof Q1 elasticity box of
  scripts/northstar_elasticity.py (108 subdomains of 10 x 10 x 44 nodes,
  3 dofs per node, 6 rigid body modes per floating subdomain, 7,150
  contact rows), whose coarse G = R'B' (540 x 253,000) is past the dense
  cutoff and runs as a BlockCoarse;
- a 3-D Poisson box cut into 2,744 subdomains (1,404,928 dofs), whose
  2,548 coarse rows switch the band factorization of GG' on by default;
- the rest of the general QP path: the 'bf16_mixed' policy on the SpMV
  kernel's (bf16, f32) pair, the TAO analog (GPCG, L-BFGS-B), and the dense
  inequality branch (tutorial ex3 through dualize with the dense Cholesky
  K+ on the card; PCPG).

Phases:

1. a CUDA device is visible; prints the card's name and power limit;
2. builds the three CUDA kernels from permon_tpu_torch/csrc (one nvcc each,
   started together) and prints the ptxas register/spill lines;
3. gather kernel phase: the north-star gather tables (B, B' with its
   overflow, the reassembly table of the warm solve), the contact rows'
   tables of phase 8 (BI, BI') and the elasticity tables of phase 9 (3 dofs
   per node: B, B' with its overflow, the reassembly table, BI, BI')
   through the kernel
   against the plain PyTorch version and against the kernel it replaced,
   bitwise (torch.equal), in all four (vals, x) dtype pairs, one launch per
   apply; then, in f64 and f32, one launch's time with a cold L2 (CUDA
   events around a launch made alone after a 256 MB buffer was rewritten),
   replaced kernel, new, new, replaced kernel in turns, beside the
   kernels' own device time by the profiler's records, the wrapper's
   back-to-back call period, the plain version and the bound;
4. SpMV kernel phase: sell_mv against sell_mv_plain and the replaced
   kernel, bitwise, in all four f32 / f64 dtype pairs, and against
   sell_mv_plain in the three bf16 pairs ('bf16_mixed': bf16 values with an
   f32, f64 or bf16 x), on the Hessian of the QP main
   path, on (a) the RCM-ordered journal-bearing Hessian at 1024 x 1024,
   (b) the RCM-ordered 7-point Laplacian at 128^3, (c) a small skewed
   matrix (dense row, dense column, empty rows) and a rectangular one
   through its transpose plan; in f64 also against scipy's A @ x to 1e-12
   relative; the same times as in phase 3, torch.mv on a CSR tensor (the
   library call, used nowhere in the port), the launch floor of the
   measurement and the host cost of one wrapper call;
4b. fixed-tree kernel phase (csrc/det_sum.cu): det_sum / det_dots on card
   tensors at the main paths' shapes (BlockCoarse.mv's (108, 13440, 6) x w
   along axis 1, apply_cp's (540, 540) x v, CG's dots over 245,850 and
   94,563 unknowns alone and as two pairs, DenseTree.mv / .rmv's (48,
   94,563) along both axes) against det_sum_plain on the same inputs,
   bitwise, in the launches the plan names; the kernel's device time (the
   profiler's kernel records after a 256 MB read, median and range of five
   rounds), the plain tree's and torch.sum(a * b, dim)'s the same way, the
   host time a call, the bound;
5. the 64-subdomain 21^3 twin: reason 2, assembled residual < 1e-8,
   22-24 dual CG iterations (23 on the CPU);
6. the north star: factorize, solve, re-solve with 1.5 b; reason 2 on
   both, assembled residual <= 1e-6 (scipy f64), linear re-solve, and the
   gather kernel and the fixed-tree kernel launched on the main path (its
   deterministic trees);
7. the QP main path with nothing but the default device: SEll chosen,
   reason 2, sell_mv launches = Hessian products of MPRGP + of the power
   method, the iterate inside the box exactly, the projected gradient
   recomputed on the host in scipy f64 within the tolerance, the same
   solve through SEll(kernel=False) with equal counts and a bitwise equal
   x, the unpermuted problem through Dia in agreement, and once more under
   with_precision('mixed') (reported);
8. contact at 512,000 dofs, f32 factors + 2 refinement steps, rtol 1e-5:
   (a) the projected dual: first solve and a warm re-solve with 1.001 b,
   reason 2 and ONE outer iteration each, the far face under the cap to
   1e-4 of the cap and touching it, the natural KKT residual of the
   assembled box QP (scipy f64) within 1e-3 ||b||, and the same solve
   through the plain
   gather version with equal counts and a bitwise equal x_global; (b)
   SMALBE proper (project=False, rtol_E 0.1): reason 2, more than one
   outer iteration, M1 updated, the solution within its limit of (a)'s;
   (c) the lumped dual preconditioner on the 21^3 twin: reason 2, first
   (eager) and warm (fast path) solve with equal counts, residual <= 1e-8;
9. elasticity at 1,179,750 dofs, f32 factors + 2 refinement steps, rtol
   1e-5, Dirichlet face eliminated in the Hessian, G a BlockCoarse:
   (a) linear with one primal defect pass: first solve and two re-solves
   with scaled loads, reason 2, the assembled residual on the free dofs
   from the decomposed blocks (scipy f64) <= 2e-4 (<= 1e-5 with a second
   defect pass), the clamped face exactly 0, where the time of a warm
   re-solve goes (device against host per part); (b) projected contact: first and warm solve, reason 2, the far
   face's u_x under the gap to 2e-5 of it, the natural KKT residual of the
   box QP from the decomposed blocks, the far-face multipliers' sign, and
   the same solve through the plain gather version with equal counts and a
   bitwise equal x_global;
10. the band GG': the Poisson box in 2,744 subdomains with coarse='auto':
   the projector holds a band factor and a BlockCoarse with one column per
   subdomain, reason 2, assembled residual <= 1e-6, the coarse solve timed
   (device against host); and reorder_rcm on the twin: the same solution,
   the count within 1;
11. (run right after phase 7) the rest of the general QP path: (a) the
   phase 7 problem under qp.with_precision('bf16_mixed'): SEll with bf16
   values on the card, sell_mv launches = products of MPRGP + of the power
   method, the same solve through SEll(kernel=False) with equal counts and a
   bitwise equal x, and reason 2 wherever the bf16-rounded Hessian is
   positive definite (its eigenvalues nearest 0 by scipy; reported: counts
   against f64, host ||gP||, the distance to the f64 solution); (b)
   solve(qp, 'tao') (GPCG) on the same problem in f64 and L-BFGS-B on the
   BLMVM_JBEARING grid: reason 2, every product on the kernel, host ||gP||
   within 10 max(rtol ||b||, atol), x within (||gP|| + ||gP_MPRGP||) /
   lambda_min(A) of the MPRGP solution; and on the BF16_JBEARING grid MPRGP
   in f64 and in 'bf16_mixed', warm, with their times per iteration; (c) tutorial ex3 at
   EX3_N unknowns: QP.create with n inequality rows -> dualize (K+ by
   make_inv: a dense Cholesky on the card) -> MPRGP at rtol 1e-12 -> post:
   reason 2, x >= obstacle - 1e-10 ||obstacle||, the primal KKT on the host;
   and solve(qp, 'pcpg') with 8 equality rows, cE != 0 and M = make_inv(A):
   BE x = cE to 1e-10;
12. the dense TFETI path (FetiSolver on a FetiProblem): (a) ex71 Poisson at
   262,144 dofs in 512 subdomains, (b) ex71 elasticity at 98,304 dofs
   (nonred, rigid body modes, lumped and none), (c) the reference
   tutorials' configurations, contact and the MATIS entry;
13. the leaf path (FetiOptions(throughput=True): explicit K+ inverses,
   dense extension blocks, the scaled-leaf dual iteration with its partner
   combine, restrict and lift tables on the gather kernel): (a) 12a's
   problem: reason 2, the count of 12a within LEAF_ROW_BAND, x_global
   within 1e-4 of 12a's, the residual under 12a's limit, the leaf F apply,
   the explicit-inverse GEMV and the leaf projector beside their bounds,
   the three tables beside the plain version and torch.mv on their CSR,
   the plain gather version bitwise equal, 'mixed' within its band; (b)
   12b's problem, lumped and none, counts within LEAF_ELASTIC_BAND of 12b's;
   (c) contact through prepare_contact_children + smalxe, row f64, leaf f64
   (equal counts) and leaf 'mixed', x against the serial solution; (d) the
   user side: solve_from_options on phase 7's QP (equal count, on
   sell_mv), a Timer around 13a's leaf operator (its count = cg's nmv),
   FetiSolver.save / load (a bitwise equal re-solve), SVC linear and rbf
   on data of a9a's shape (123 binary features; the rows cut to
   SVM_LINEAR_N / SVM_RBF_N, see there): reason 2, 0 <= alpha <= C,
   |y'alpha| under SMALXE's equality tolerance;
14. the multi-device layer (permon_tpu_torch.parallel), its ranks started
   by ``python -m torch.distributed.run --standalone`` on this script's
   rank worker (``--rank-worker=14a``), every rank on the one card (gloo:
   NCCL refuses two ranks on one GPU), each rank's backend and staged
   collectives printed: (a) the north star sharded over 2 ranks with phase
   6's recipe and coarse='sparse', a first solve and two warm re-solves:
   counts equal to a one-device run of the same options whose K+ makes
   the ranks' calls (32 subdomains each), x_global within 1e-12 max |x|
   of it, the residual as phase 6 holds it, each rank's B, B' and
   copy-sum tables bitwise against gather_apply_plain, the time of one F
   apply's all_reduce, each rank's peak memory; (b) the same on the (2, 2)
   mesh, first with the coarse factor replicated (counts equal to the
   one-device run with K+ in the ranks' calls of 16, x_global within 1e-12
   of it), then with qppf_redundancy (the first solve's counts equal to
   the replicated run's, a re-solve's defect pass within one, x_global
   within X_14B_RED of it and X_14B_14A of (a)'s), RedundantCoarse.mv
   within 1e-12 of cho_solve; (c) 12a's problem on the leaf path over 2 ranks
   (the overlapped exchange): 23 iterations, x_global within 1e-10 of
   13a's, the overlapped apply within 1e-12 of the flat one; (d) the twin
   on NCCL with one rank: counts equal to phase 5's.  Ranks that
   time-share one card measure correctness and collective overhead, not
   scaling;
15. the command-line examples (permon_tpu_torch/examples/, the port of the
   JAX package's examples/): each example's main on the card at its JAX
   twin's default arguments (ex1, ex2, ex3, jbearing2, feti_ex1,
   feti_contact, feti_ex71 and its main_elasticity, svm; feti_large's main
   at the north star and its main_elasticity), its printed lines logged, its
   counts held beside the JAX example's (EXAMPLE_REFERENCE), reason > 0, the
   gather kernel launched under every FETI example, the QP tutorials'
   Hessian on Dia as the JAX package's make_operator picks it, feti_large's
   assembled residual <= 1e-6; the launches under the examples are counted
   from 0 and printed per example.
16. the JAX package's public names on the card, through ``import
   permon_tpu_torch as pt`` alone and on problems earlier phases built: (a)
   __graft_entry__.entry's recipe (ex1's obstacle QP at n = 1024 on
   pt.Dia, pt.mprgp capped at 200 iterations), the count equal and x within
   1e-9 of the same calls on CPU tensors; (b) phase 7's QP through
   pt.make_operator -> SEll and pt.mprgp: reason 2, counts and x bitwise
   those of phase 7's pt.solve; pt.Scaled(pt.Dia, 2.0).diagonal() of the
   unpermuted jbearing twice scipy's diagonal, bitwise; (c) phase 6's
   RegularizedBlockDia: diagonal() on the card bitwise equal to the same
   call on CPU tensors and to the host's scipy diagonal of the subdomain
   blocks with the fixing-dof correction added; (d) the twin's dual (phase
   5's recipe through dualize / homogenize_eq / enforce_eq_by_projector)
   by cg(monitor=True): one printed line per convergence test (iterations +
   1), counts and x bitwise those of monitor=False, the period per
   iteration of both (five runs each, alternated), and on the plain gather
   tables counts and x bitwise with no launch; the launches under the phase
   counted from 0.

Every phase raises on failure (exit code != 0).  The line before the last
is the kernel JSON record (``ms``: one launch between two events with a
cold L2 at the main path's shape, for gather_apply the B' table of the
north star; ``v1_ms``: the replaced kernel the same way, in turns;
``call_ms``: the wrapper's back-to-back call period; ``kernel_only_ms``: the
kernel's device time by the profiler; ``floor_ms``: what ``ms`` reads for a
32-thread launch; ``bf16_f32_*``: sell_mv's (bf16, f32) pair the same
way; ``launches``: every counted launch of the script, ``launches_examples``
those of phase 15 alone, ``launches_api`` those of phase 16; for det_sum
``launches`` are phase 6's, ``ms`` its device time at BlockCoarse.mv's
shape by the profiler, ``shapes`` phase 4b's rows), the last line {"ok": true,
"device": ...}.  Development options, none of which prints the result lines:
``--kernels-only`` stops after phase 4b; ``--only=9,10`` runs phases 1, 2
and the named ones of 9, 9c, 9t, 10, 11 (11 after phase 7), 12, 12c, 13, 15
(with the row-path solves of 12a / 12b and phase 7 it compares with), 16 (with
phase 7's solve and phase 6's operator, built by the phase itself), 14 (with the
single-device solves of phases 6 and 13a it compares with), 14k (the band K+ apply
by the subdomains its calls cover, which is why phase 14's one-device references make
the ranks' calls), 11c (the ex3
branch alone at the sizes of ``--ex3-n=4096,8192``), 11l (L-BFGS-B alone
on the grids of ``--blmvm-grids=96,128,192``, beside scipy's own cost).  9c is SMALBE proper
(project=False, rtol_E 0.1) on elastic contact at 361,416 dofs against its
projected twin (``--9c-f64``: f64 factors, ``--9c-rtol-E=v``: SMALBE's rtol_E,
``--9c-inner-max-it=n``: SMALXE's budget of inner iterations);
it is no part of the default run: on an H100 its 14th inner solve ran into
SMALXE's budget of 10,000 inner iterations, summed over the outer loop
(ROADMAP.md, fault C2); it logs one line per inner solve (iterations,
reason, M1, rho, G, E) and SMALXE's per-outer monitor.  9t sweeps the dual tolerance and
the factor precision of phase 9b's contact solve.
Imports nothing of JAX or of the JAX package permon_tpu.
"""

import json
import os
import subprocess
import sys
import time

# the host's share of this script is vector work (L-BFGS-B's iterate, the
# KKT checks).  OpenBLAS threads level-1 calls above 10,000 elements, which
# made scipy's L-BFGS-B ~100x slower per evaluation (PERF.md, phase 11b):
# one thread unless the caller sets the number
os.environ.setdefault("OPENBLAS_NUM_THREADS", "1")

NORTH_STAR = ((100,) * 3, (4,) * 3)
TWIN = ((20,) * 3, (4,) * 3)
CONTACT = ((79,) * 3, (4,) * 3)  # 80^3 = 512,000 dofs, 6,400 contact rows
ELASTICITY = ((54, 54, 129), (6, 6, 3))  # 1,179,750 dofs, 108 subdomains, 7,150 contact rows
SMALBE_ELASTICITY = ((36, 36, 87), (4, 4, 2))  # 361,416 dofs, 32 subdomains of the same boxes
BAND_COARSE = ((111,) * 3, (14,) * 3)  # 112^3 = 1,404,928 dofs, 2,744 subdomains
JBEARING = (512, 512)  # the QP main path: 262,144 unknowns
#: phase 11b's L-BFGS-B grid: the largest of `--only=11l`'s sweep that ends
#: in ~30 s with its iterate on the host (one BLAS thread: 24 s on an H100's
#: host; 384^2 took 50 s)
BLMVM_JBEARING = (320, 320)
#: phase 11b's grid for 'bf16_mixed' against f64: its bf16 Hessian is
#: positive definite (at 320^2 and 512^2 it is not)
BF16_JBEARING = (96, 96)
EX3_N = 16384  # phase 11c: tutorial ex3 at this n, the obstacle as n inequality rows
SPMV_JBEARING = (1024, 1024)  # SpMV matrix (a): 1,048,576 rows
LAPLACIAN_NX = 128  # SpMV matrix (b): 2,097,152 rows
DENSE_POISSON = ((63,) * 3, (8,) * 3)  # phase 12a: 262,144 dofs, 512 subdomains of <= 729
DENSE_ELASTICITY = ((31,) * 3, (4,) * 3)  # phase 12b: 98,304 dofs, 64 subdomains of 2,187
#: phase 12's assembled-residual limits at rtol 1e-5: 10x what the JAX
#: package's CPU run of a twin of the same subdomain shape gave (ex71
#: (31,)^3 on (4,)^3: 2.278e-5; elasticity (15,)^3 on (2,)^3, rbm, nonred:
#: 1.637e-4, lumped 1.893e-4)
DENSE_RESID_LIMIT = {"poisson": 2.3e-4, "elasticity": 1.9e-3}
#: published peaks of one H100 SXM: HBM bytes/s and f64 / f32 FLOP/s outside
#: the tensor cores (a card set below 700 W runs slower)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float64": 34e12, "float32": 67e12}
#: the card's name and power limit as nvidia-smi gives them (set by main),
#: printed beside phase 16's times
CARD = "card not queried"


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps=20, warmup=3, flush=None, clean=False):
    """Mean milliseconds of fn() on the current stream (CUDA events), the
    launches back to back; with ``flush`` (a buffer larger than the L2
    cache) each launch is timed alone after the buffer was rewritten, so it
    finds its inputs in device memory and the L2 full of modified lines
    that it must write back; with ``clean`` the buffer is read instead, so
    the L2 holds nothing to write back."""
    import torch

    for _ in range(warmup):
        fn()
    if flush is None:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps
    pairs = []
    for _ in range(reps):
        if clean:
            flush.view(torch.int64).sum()
        else:
            flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


def bound_ms(nbytes, flops, dtype="float64"):
    """(ms, "bytes" | "operations"): the least time the card could take."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def gather_table_work(tab, x, out):
    """Bytes and flops (2 per table slot) of one apply of a gather table: the
    tables, overflow planes and marker and out once each, and of x what the
    slots need: one 32-byte sector per slot, at most all of x (a table with
    few slots, as the contact rows' B, gathers a sliver of x)."""
    slots = tab.idx.numel() + (0 if tab.ov_idx is None else tab.ov_idx.numel())
    nbytes = (_nbytes(tab.idx, tab.vals, tab.ov_idx, tab.ov_vals, tab.ov_mark, out)
              + min(32 * slots, _nbytes(x)))
    return nbytes, 2 * slots


def gather_table_csr(tab):
    """The scipy CSR matrix (nrows, n_src) of a gather table's entries, its
    overflow planes included: the library call computing the same function
    is torch.mv on it (a weighted plane gather is an SpMV).  Entries of one
    (row, source) are summed."""
    import numpy as np
    import scipy.sparse as sp

    w, nrows = tab.idx.shape
    rows = [np.broadcast_to(np.arange(nrows), (w, nrows))]
    cols, vals = [tab.idx.cpu().numpy()], [tab.vals.double().cpu().numpy()]
    if tab.ov_tgt is not None:
        rows.append(np.broadcast_to(tab.ov_tgt.cpu().numpy(), tab.ov_idx.shape))
        cols.append(tab.ov_idx.cpu().numpy())
        vals.append(tab.ov_vals.double().cpu().numpy())
    r, c, v = (np.concatenate([a.reshape(-1) for a in arrs]) for arrs in (rows, cols, vals))
    live = c < tab.n_src
    return sp.csr_matrix((v[live], (r[live], c[live])), shape=(nrows, tab.n_src))


def turns_ms(fns, flush, reps=20, clean=False):
    """Cold-L2 milliseconds per launch of each named function, taken in
    turns in one run (a, b, ..., b, a): {name: (mean, first, second)}."""
    names = list(fns)
    got = {k: [] for k in names}
    for k in names + names[::-1]:
        got[k].append(cuda_ms(fns[k], reps=reps, flush=flush, clean=clean))
    return {k: (sum(v) / 2, v[0], v[1]) for k, v in got.items()}


def kernel_only_ms(fn, flush, reps=10):
    """Milliseconds that the port's kernels launched by one fn() run on the
    device, by the profiler's kernel records (no launch gap, no event), each
    fn() after the flush buffer was rewritten; None if the profiler reports
    no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    ours = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and ("sell_mv_kernel" in e.key or "gather_apply_kernel" in e.key)]
    total = sum(e.self_device_time_total for e in ours)
    return total / 1e3 / reps if total > 0 else None


def device_ms(fn, reps=10):
    """Milliseconds that one fn() keeps the device busy, by the profiler's
    kernel records (every kernel it launches); None if the profiler reports
    no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA)
    return total / 1e3 / reps if total > 0 else None


def breakdown(tag, parts):
    """Log, per named part, the back-to-back call period (CUDA events; the
    larger of what the host needs to enqueue one call and what the device
    needs to run it) beside the device's busy time alone."""
    for name, fn in parts.items():
        period = cuda_ms(fn, reps=5, warmup=1)
        log(f"[{tag}] breakdown {name}: period {period:.3f} ms, device busy "
            f"{fmt_ms(device_ms(fn))}")


def profile_solve(tag, run, wall_s):
    """Profile one run() (a warm re-solve): the device's busy time against
    the unprofiled wall time, the idle share and the eight largest kernels.
    Returns run()'s result."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = run()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3
    if dev_ms <= 0:
        log(f"[{tag}] profile: no device time reported; idle share not measured")
        return out
    log(f"[{tag}] profile of a warm re-solve: device time {dev_ms:.1f} ms against "
        f"{1e3 * wall_s:.1f} ms wall (unprofiled): device idle share "
        f"{1 - dev_ms / (1e3 * wall_s):.3f}; {sum(e.count for e in events)} kernel launches")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"[{tag}] profile   {e.self_device_time_total / 1e3:.2f} ms x{e.count}  {e.key[:90]}")
    return out


def host_us(fn, n=5000):
    """Microseconds of host time per fn() call (device work drained after)."""
    import torch

    for _ in range(100):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * t / n


def fmt_ms(t):
    return "not measured" if t is None else f"{t:.4f} ms"


def run_all(fns):
    for fn in fns:
        fn()


def phase_kernel(prob, eprob, eBI, dev):
    """The gather kernel on the exact north-star tables (B, B' with its
    overflow, the reassembly table of the warm solve), on the contact
    rows' tables of phase 8 (BI, BI') and on the elasticity tables of phase
    9 (3 dofs per node; ``eprob``, ``eBI``): against the plain
    PyTorch version and the replaced kernel bitwise in all four dtype
    pairs, then timed per launch with a cold L2, old against new in turns."""
    import numpy as np
    import scipy.sparse as sp
    import torch

    from permon_tpu_torch.core.sell import gather_apply, kernel_launchers
    from permon_tpu_torch.feti.large import (ReassemblyTables, band_layout, gluing_extension,
                                             padded)
    from permon_tpu_torch.feti.solve import FetiOptions
    from permon_tpu_torch.problems import build_obstacle

    _, _, nlp = band_layout([sp.csr_matrix(K) for K in prob.K_blocks], prob.nl)
    BE = gluing_extension(padded(prob, nlp).l2g, FetiOptions(gluing="nonred"), dev)
    copies = ReassemblyTables.build(prob.l2g, nlp, dev).copies
    # the contact rows of phase 8, re-padded as assemble_qp_sparse pads them
    cprob, BI, _, _ = build_obstacle(*CONTACT)
    _, _, cnlp = band_layout([sp.csr_matrix(K) for K in cprob.K_blocks], cprob.nl)
    BI = BI.replace(nl=cnlp).with_gather_apply(dev)
    del cprob
    # the elasticity tables of phase 9: the clamped face is eliminated in the
    # Hessian there, so BE is the gluing alone
    _, _, enlp = band_layout(eprob.K_blocks, eprob.nl)
    eBE = gluing_extension(padded(eprob, enlp).l2g, FetiOptions(gluing="nonred"), dev)
    ecopies = ReassemblyTables.build(eprob.l2g, enlp, dev).copies
    eBI = eBI.replace(nl=enlp).with_gather_apply(dev)
    rng = np.random.RandomState(0)
    tables = {"B": (BE.gB, rng.standard_normal(BE.shape[1])),
              "B'": (BE.gBt, rng.standard_normal(BE.shape[0])),
              "copies": (copies, rng.standard_normal(copies.n_src)),
              "BI": (BI.gB, rng.standard_normal(BI.shape[1])),
              "BI'": (BI.gBt, rng.standard_normal(BI.shape[0])),
              "elasticity B": (eBE.gB, rng.standard_normal(eBE.shape[1])),
              "elasticity B'": (eBE.gBt, rng.standard_normal(eBE.shape[0])),
              "elasticity copies": (ecopies, rng.standard_normal(ecopies.n_src)),
              "elasticity BI": (eBI.gB, rng.standard_normal(eBI.shape[1])),
              "elasticity BI'": (eBI.gBt, rng.standard_normal(eBI.shape[0]))}
    if eBE.gBt.ov_idx is None or ecopies.ov_idx is None:
        raise AssertionError("the elasticity B' / reassembly tables have no overflow planes")
    for name, (tab, _) in tables.items():
        log(f"[kernel] table {name}: {tuple(tab.idx.shape)}, plane stride {tab.idx.stride(0)}"
            + ("" if tab.ov_idx is None else f", overflow {tuple(tab.ov_idx.shape)}, marker "
               f"{_nbytes(tab.ov_mark) / _nbytes(tab.idx, tab.vals):.4f} of the table's bytes"))
    flush = torch.empty(1 << 28, dtype=torch.uint8, device=dev)  # 256 MB > the 50 MB L2
    f64, f32 = torch.float64, torch.float32
    max_err, record = 0.0, None
    for vdt, xdt in ((f64, f64), (f32, f32), (f64, f32), (f32, f64)):
        for name, (tab, x) in tables.items():
            tab = tab.cast(vdt)
            plain = tab.replace(kernel=False)
            xt = torch.as_tensor(x, dtype=xdt, device=dev)
            n0 = gather_apply.launches
            got, ref = tab.apply(xt), plain.apply(xt)
            if gather_apply.launches != n0 + 1:
                raise AssertionError(f"table {name}: {gather_apply.launches - n0} launches "
                                     "for one apply, not 1")
            new, out_new = kernel_launchers(tab, xt)
            old, out_old = kernel_launchers(tab, xt, version="v1")
            run_all(new + old)
            torch.cuda.synchronize()
            err = float((got.double() - ref.double()).abs().max())
            max_err = max(max_err, err)
            if got.dtype != torch.promote_types(vdt, xdt) or not torch.equal(got, ref):
                raise AssertionError(f"gather kernel != plain for {name} vals {vdt} "
                                     f"x {xdt}: max abs err {err}")
            if not (torch.equal(out_new, ref) and torch.equal(out_old, ref)):
                raise AssertionError(f"replaced gather kernel != new for {name} vals {vdt} "
                                     f"x {xdt}")
            key = f"{name} vals={str(vdt)[6:]} x={str(xdt)[6:]}"
            if vdt != xdt:
                log(f"[kernel] {key}: kernel = plain = replaced kernel, bitwise")
                continue
            fns = {"new": new[0], "v1": lambda: run_all(old)}
            if len(old) == 2:
                fns.update({"v1 table": old[0], "v1 overflow": old[1]})
            t = turns_ms(fns, flush)
            tc = turns_ms(fns, flush, clean=True)
            k_new, k_old = kernel_only_ms(fns["new"], flush), kernel_only_ms(fns["v1"], flush)
            log(f"[kernel] {key}: the kernels alone (profiler records, cold L2): new "
                f"{fmt_ms(k_new)}, v1 {fmt_ms(k_old)}; between events after the buffer was "
                "read, not rewritten: " + ", ".join(f"{k} {v[0]:.4f} ms" for k, v in tc.items()))
            call_ms = cuda_ms(lambda: tab.apply(xt))
            plain_ms = cuda_ms(lambda: plain.apply(xt), reps=5, warmup=1, flush=flush)
            lib_ms, lib_y = library_spmv_ms(gather_table_csr(tab), xt, flush)
            lib_err = float((lib_y - got).abs().max() / got.abs().max().clamp(min=1e-300))
            nbytes, flops = gather_table_work(tab, xt, got)
            b_ms, b_by = bound_ms(nbytes, flops, str(xdt)[6:])
            log(f"[kernel] {key}: kernel = plain = replaced kernel, bitwise; one launch, cold "
                f"L2: new {t['new'][0]:.4f} ms ({t['new'][1]:.4f}, {t['new'][2]:.4f}), v1 "
                f"{t['v1'][0]:.4f} ms ({t['v1'][1]:.4f}, {t['v1'][2]:.4f}; {len(old)} launches"
                + (f": table {t['v1 table'][0]:.4f}, overflow {t['v1 overflow'][0]:.4f}"
                   if len(old) == 2 else "")
                + f"); call period back to back {call_ms:.4f} ms; plain {plain_ms:.4f} ms; "
                f"library (torch.mv on the CSR of the same entries) {lib_ms:.4f} ms, relative "
                f"difference {lib_err:.1e}; bound {b_ms:.4f} ms by {b_by} ({nbytes / 1e6:.2f} MB, "
                f"bound / new {b_ms / t['new'][0]:.2f})")
            if name == "B'" and vdt == f64:  # the largest table of the main path
                record = dict(ms=t["new"][0], v1_ms=t["v1"][0], call_ms=call_ms,
                              kernel_only_ms=k_new, v1_kernel_only_ms=k_old,
                              plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                              library_ms=lib_ms)
    record["max_abs_err"] = max_err
    return record


def tree_shapes(dev):
    """The fixed trees of the main paths at their shapes, f64: (label,
    arguments of det_sum or the pairs of det_dots, unique input bytes,
    output values)."""
    import torch

    g = torch.Generator(device=dev).manual_seed(7)

    def r(*shape):
        return torch.randn(*shape, dtype=torch.float64, device=dev, generator=g)

    x, y, xp, yp = r(245850), r(245850), r(94563), r(94563)
    return [
        ("BlockCoarse.mv (108, 13440, 6) x w along axis 1", (r(108, 13440, 6), 1,
                                                              r(108, 13440)[:, :, None]),
         108 * 13440 * 7 * 8, 648),
        ("apply_cp (540, 540) x v", (r(540, 540), -1, r(540)[None, :]), (540 * 540 + 540) * 8,
         540),
        ("CG dot (1, 245850)", (x, -1, y), 2 * 245850 * 8, 1),
        ("CG dots (2, 245850)", [(x, y), (y, y)], 2 * 245850 * 8, 2),
        ("CG dot (1, 94563)", (xp, -1, yp), 2 * 94563 * 8, 1),
        ("DenseTree.mv (48, 94563) x x along axis 1", (r(48, 94563), -1, xp[None, :]),
         (48 * 94563 + 94563) * 8, 48),
        ("DenseTree.rmv (48, 94563) x y along axis 0", (r(48, 94563), 0, r(48)[:, None]),
         (48 * 94563 + 48) * 8, 94563),
    ]


def tree_device_ms(fn, flush, rounds=5, reps=40):
    """Milliseconds a call of fn() keeps the device busy by the profiler's
    kernel records, each call after a read of the 256 MB ``flush`` (so that
    the inputs come from device memory and no dirty line of another kernel
    is written back in their time; its max-reduction is left out by name):
    ((median, least, most) over the rounds of ``reps`` calls kept, the
    kernels a call launches, the rounds kept, their names), or (None, 0, 0,
    ()).  A round in which the profiler dropped records (fewer kernels than
    the fullest round) is not kept."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    got = []
    for _ in range(rounds):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                flush.max()
                fn()
            torch.cuda.synchronize()
        total, count, names = 0.0, 0, []
        for e in prof.key_averages():
            if (e.device_type != torch.autograd.DeviceType.CUDA
                    or "MaxNanFunctor" in e.key or "MaxOps" in e.key
                    or e.key.startswith("detred.") or e.self_device_time_total <= 0):
                continue  # the flush, and the spans' ranges on the device's timeline
            total += e.self_device_time_total
            count += e.count
            names.append(e.key[:80])
        got.append((count, total / 1e3 / reps, tuple(names)))
    full = max(c for c, _, _ in got)
    kept = [g for g in got if g[0] == full and full > 0]
    if not kept:
        return None, 0, 0, ()
    means = sorted(t for _, t, _ in kept)
    return ((means[len(means) // 2], means[0], means[-1]), full // reps, len(means),
            kept[0][2])


def phase_tree(dev):
    """The fixed-tree kernel (csrc/det_sum.cu) at the main paths' shapes:
    det_sum / det_dots on card tensors against det_sum_plain on the same
    inputs, bitwise (torch.equal), with the launches its plan names; then
    its device time (median, least and most of five rounds), its host time a
    call, the plain tree's and the library's (torch.sum(a * b, dim)) beside
    the bound (each input byte read once, the output written once).
    Returns the record of BlockCoarse.mv's tree, the largest of the main
    paths, with every shape's row under ``shapes``."""
    import torch

    from permon_tpu_torch.core.detred import (det_dots, det_sum, det_sum_plain, parts_layout,
                                              tree_layout)

    flush = torch.rand(64 << 20, device=dev)  # 256 MB of float32, read before each call
    rows = []
    for label, op, nbytes, nout in tree_shapes(dev):
        if isinstance(op, list):  # det_dots pairs
            kernel = lambda op=op: det_dots(op)  # noqa: E731
            plain = lambda op=op: det_sum_plain(torch.stack([a * b for a, b in op]))  # noqa: E731
            library = lambda op=op: (torch.stack([a for a, _ in op])  # noqa: E731
                                     * torch.stack([b for _, b in op])).sum(-1)
            planned = len(parts_layout(op).passes)
        else:
            kernel = lambda op=op: det_sum(*op)  # noqa: E731
            plain = lambda op=op: det_sum_plain(*op)  # noqa: E731
            library = lambda op=op: torch.sum(op[0] * op[2], dim=op[1])  # noqa: E731
            planned = len(tree_layout(*op).passes)
        n0 = det_sum.launches
        got = kernel()
        launches = det_sum.launches - n0
        got = torch.stack(got) if isinstance(got, tuple) else got
        ref = plain()
        torch.cuda.synchronize()
        if launches != planned or not torch.equal(got, ref):
            raise AssertionError(f"det_sum {label}: {launches} launches (planned {planned}), "
                                 f"bitwise {torch.equal(got, ref)}")
        row = dict(shape=label, launches=launches, bound_ms=(nbytes + 8 * nout)
                   / HBM_BYTES_PER_S * 1e3)
        text = []
        for name, fn in (("kernel", kernel), ("plain", plain), ("library", library)):
            t, kernels, kept, names = tree_device_ms(fn, flush)
            row.update({f"{name}_ms": t and t[0], f"{name}_ms_range": t and [t[1], t[2]],
                        f"{name}_kernels": kernels, f"{name}_rounds": kept,
                        f"{name}_host_us": host_us(fn, n=1000)})
            row[f"{name}_kernel_names"] = names
            text.append(f"{name} {fmt_ms(t and t[0])}" + (
                f" ({t[1]:.4f}-{t[2]:.4f} over {kept} rounds)" if t else "")
                + f" in {kernels} kernels, host {row[name + '_host_us']:.1f} us a call")
        rows.append(row)
        log(f"[tree] {label}: kernel = plain, bitwise, in {launches} launch(es); "
            + "; ".join(text) + f"; bound {row['bound_ms']:.4f} ms by bytes")
        if row["kernel_ms"] is not None and row["kernel_kernels"] != launches:
            raise AssertionError(f"det_sum {label}: {row['kernel_kernels']} kernels timed for "
                                 f"{launches} launches: {row['kernel_kernel_names']}")
    main = rows[0]
    return dict(ms=main["kernel_ms"], kernel_only_ms=main["kernel_ms"],
                plain_ms=main["plain_ms"], library_ms=main["library_ms"],
                bound_ms=main["bound_ms"], bound_by="bytes", shapes=rows)


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
    return [r.iterations for r in res.results]


def phase_main(prob, t_host_prob, dev):
    import numpy as np
    import torch

    from permon_tpu_torch.core.convergence import Tolerances
    from permon_tpu_torch.core.detred import det_sum
    from permon_tpu_torch.core.sell import gather_apply, sell_mv
    from permon_tpu_torch.feti.large import FetiSolverSparse
    from permon_tpu_torch.feti.solve import FetiOptions
    from permon_tpu_torch.problems import assembled_system

    cells, _ = NORTH_STAR
    tol = Tolerances(rtol=1e-5)
    torch.cuda.reset_peak_memory_stats(dev)
    gather_apply.launches = sell_mv.launches = det_sum.launches = 0  # the main path's only
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
    launches, tree_launches = gather_apply.launches, det_sum.launches
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
        f"peak device memory {peak / 2**30:.3f} GiB; gather_apply launches {launches}, "
        f"det_sum launches {tree_launches}")
    if not all(r.reason == 2 for r in r1.results + r2.results):
        raise AssertionError("north star: a dual solve did not reach reason 2")
    if not resid <= 1e-6:
        raise AssertionError(f"north star: assembled residual {resid} > 1e-6")
    if not lin <= 1e-6:
        raise AssertionError(f"north star: re-solve not linear ({lin})")
    if launches <= 0:
        raise AssertionError("north star: the gather kernel was never launched")
    if tree_launches <= 0:
        raise AssertionError("north star: the fixed-tree kernel was never launched")

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
    # phase 14a's single-device reference: these options took the sparse
    # coarse branch (a projector built before the first solve), which
    # coarse='sparse' takes too
    ref = None
    if solver._pf is not None:
        ref = dict(its1=its1, its2=its2, x1=r1.x_global, ms_per_it=1e3 * (t2 - t1) / sum(its2))
    # phase 16's K: the regularized stencil (not its factors) and its blocks' host diagonal
    kreg = (solver.kplus_post.op, north_star_host_diagonal(prob, solver.kplus_post.op.base.nlp))
    return launches, ref, kreg, tree_launches


def box_kkt(A, b, far, cap, x):
    """(natural residual, least multiplier over the largest) of the box QP.
    The natural residual ||x - P(x - g)|| / ||b|| of min 1/2 x'Ax - b'x,
    x <= cap on the dofs ``far``, with g = A x - b and P the projection on
    the box, in scipy f64: g on a free dof, max(g, x - cap) on a bounded one
    (zero exactly at a KKT point; it needs no guess of the contact set).
    The multiplier of a bounded dof is -g (>= 0 at a KKT point); the second
    value is its minimum over its maximum on ``far``."""
    import numpy as np

    g = A @ x - b
    r = np.where(far, np.maximum(g, x - cap), g)
    mu = -g[far]
    mu_rel = float(mu.min() / mu.max()) if mu.max() > 0 else -np.inf
    return float(np.linalg.norm(r) / np.linalg.norm(b)), mu_rel


def smalxe_counts(r):
    return (r.iterations, r.inner_iterations, r.nmv, r.M1_updates, r.rho_updates)


def phase_contact(dev):
    """Contact on the large path at 512,000 dofs: the projected dual, the
    same through the plain gather version, SMALBE proper, and the lumped
    preconditioner on the twin.  Returns the gather_apply launches of the
    contact solves that ran on the kernel."""
    import numpy as np
    import torch

    from permon_tpu_torch.core.convergence import Tolerances
    from permon_tpu_torch.core.sell import gather_apply
    from permon_tpu_torch.feti.large import FetiSolverSparse
    from permon_tpu_torch.feti.solve import FetiOptions
    from permon_tpu_torch.problems import assembled_system, build_obstacle, build_sparse
    from permon_tpu_torch.solvers.smalxe import SMALXEOptions

    cells, grid = CONTACT
    tol = Tolerances(rtol=1e-5)
    f32 = dict(kplus_dtype=torch.float32, kplus_refine=2)
    base = dict(gluing="nonred", deterministic=True, coarse="sparse")
    t0 = time.perf_counter()
    prob, BI, cI, cap = build_obstacle(cells, grid)
    t_build = time.perf_counter() - t0

    def timed(solver, **kw):
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        r = solver.solve(tol=tol, **kw)
        torch.cuda.synchronize(dev)
        return r, time.perf_counter() - t

    def report(tag, r, t, n_launch):
        # every F apply launches the kernel four times (B' and B of BE and of
        # BI); beside the inner solve's products F serves the two power
        # methods, the Lagrangians, d and the post-solve chain
        res, n_f = r.result, n_launch // 4
        log(f"[contact] {tag}: reason {res.reason}, outer {res.iterations}, inner "
            f"{res.inner_iterations}, Hessian products {res.nmv} (cg/exp/prop "
            f"{res.ncg}/{res.nexp}/{res.nprop}), M1 updates {res.M1_updates}, rho updates "
            f"{res.rho_updates}, {t:.3f} s; gather_apply launches {n_launch} = 4 x {n_f} F "
            f"applies + {n_launch % 4}: {1e3 * t / max(n_f, 1):.3f} ms per F apply with all "
            f"that rides on it, {1e3 * t / max(res.inner_iterations, 1):.3f} ms per inner "
            "iteration with the power methods and the post-solve chain charged to it")

    # ---- 8a: the projected dual --------------------------------------------
    torch.cuda.reset_peak_memory_stats(dev)
    gather_apply.launches = 0  # count this path's launches only
    solver = FetiSolverSparse(prob, FetiOptions(**base), BI=BI, cI=cI, device=dev, **f32)
    r1, t1 = timed(solver)
    n_first = gather_apply.launches
    r2, t2 = timed(solver, b_loc=prob.b_loc * 1.001)
    launches = gather_apply.launches
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"[contact] {prob.n_global} dofs, {prob.ns} subdomains of <= {prob.nl} dofs, NB "
        f"{solver.NB}, k {solver.qp.R.shape[1]}, gluing rows {solver.qp.BE.shape[0]}, contact "
        f"rows {solver.qp.BI.shape[0]}, cap {cap:.2f}")
    log(f"[contact] host setup {t_build + solver.timings['host_setup_s']:.3f} s (problem build "
        f"{t_build:.3f} s), factorization {solver.timings['factor_s']:.3f} s, peak device "
        f"memory {peak / 2**30:.3f} GiB")
    report("8a projected, first solve", r1, t1, n_first)
    report("8a projected, warm re-solve with 1.001 b", r2, t2, launches - n_first)
    for tag, r in (("first", r1), ("warm", r2)):
        if r.result.reason != 2 or r.result.iterations != 1:
            raise AssertionError(f"contact 8a {tag}: reason {r.result.reason}, outer "
                                 f"{r.result.iterations}; expected 2 and 1")
    if r1.dual_qp is not None or n_first <= 0 or launches <= n_first:
        raise AssertionError("contact 8a: the fast path or the gather kernel did not run")
    A, b = assembled_system(cells)
    Mx = cells[0] + 1
    far = np.arange(len(b)) % Mx == Mx - 1
    x = r1.x_global
    # the limits scale with the solution: the dual solve stops at
    # ||gP|| <= 1e-5 ||d||, so the primal is right to about 1e-5 of its own
    # size (the cap, 936 here): 2e-5 of the cap over it, 1e-3 ||b|| of KKT
    # residual; every far-face multiplier is held to its KKT sign, >= 0
    feas = 2e-5 * cap
    over = float((x[far] - cap).max())
    n_active = int((x[far] >= cap - feas).sum())
    kkt, mu_rel = box_kkt(A, b, far, cap, x)
    log(f"[contact] 8a on the host (scipy f64): max(x - cap) on the far face {over:.3e} (limit "
        f"2e-5 cap = {feas:.3e}), {n_active} of {int(far.sum())} far-face dofs within that of "
        f"the cap, natural KKT residual of the assembled box QP {kkt:.3e} ||b|| (limit 1e-3), "
        f"least far-face multiplier {mu_rel:.3e} of the largest (limit >= 0); interior max "
        f"{x.max():.2f}")
    if not (np.isfinite(x).all() and over <= feas and n_active > 0 and kkt <= 1e-3
            and mu_rel >= 0):
        raise AssertionError(f"contact 8a: over {over}, active {n_active}, KKT {kkt}, least "
                             f"multiplier {mu_rel}")
    move = np.abs(r2.x_global - x).max()
    if not 0 < move < 0.01 * cap:
        raise AssertionError(f"contact 8a: the warm re-solve moved x by {move}")

    # where the time of a warm solve goes: a profiled re-solve
    rp = profile_solve("contact", lambda: solver.solve(tol=tol, b_loc=prob.b_loc * 1.001), t2)
    if smalxe_counts(rp.result) != smalxe_counts(r2.result):
        raise AssertionError("contact 8a: the profiled re-solve changed its counts")
    qp, pf = solver.qp, solver._pf
    lam = torch.as_tensor(np.random.RandomState(1).standard_normal(pf.G.shape[1]), device=dev)
    lam_E, lam_I = lam[: qp.BE.shape[0]], lam[qp.BE.shape[0]:]
    v = qp.BE.rmv(lam_E)
    parts = {
        "BE' (rmv)": lambda: qp.BE.rmv(lam_E), "BI' (rmv)": lambda: qp.BI.rmv(lam_I),
        "K+ (f32, unrefined)": lambda: solver.kplus.mv(v),
        "BE (mv)": lambda: qp.BE.mv(v), "BI (mv)": lambda: qp.BI.mv(v),
        "P (coarse projector)": lambda: pf.apply_p(lam),
        "G'G (the penalty term)": lambda: pf.G.rmv(pf.G.mv(lam)),
        "K+ refined (2 steps)": lambda: solver.kplus_post.mv(v),
    }
    for name, fn in parts.items():
        log(f"[contact] breakdown {name}: {cuda_ms(fn, reps=5, warmup=1):.3f} ms")
    del solver, qp, pf

    # the same solve through the plain gather version
    gather_apply.launches = 0
    plain = FetiSolverSparse(prob, FetiOptions(**base, gather_kernel=False), BI=BI, cI=cI,
                             device=dev, **f32)
    rq, tq = timed(plain)
    del plain
    if gather_apply.launches != 0:
        raise AssertionError("contact: gather_kernel=False launched the kernel")
    if smalxe_counts(rq.result) != smalxe_counts(r1.result) or \
            not np.array_equal(rq.x_global, r1.x_global):
        raise AssertionError(f"contact: kernel and plain solves differ: "
                             f"{smalxe_counts(r1.result)} vs {smalxe_counts(rq.result)}")
    log(f"[contact] 8a gather_kernel=False: same counts, bitwise equal x_global; {tq:.3f} s")

    # ---- 8b: SMALBE proper, the unprojected dual ---------------------------
    torch.cuda.reset_peak_memory_stats(dev)
    gather_apply.launches = 0  # count this path's launches only
    solver = FetiSolverSparse(prob, FetiOptions(**base, project=False,
                                                smalxe=SMALXEOptions(rtol_E=0.1)),
                              BI=BI, cI=cI, device=dev, **f32)
    r3, t3 = timed(solver)
    n_b = gather_apply.launches
    del solver
    report("8b SMALBE proper (project=False, rtol_E 0.1)", r3, t3, n_b)
    xb = r3.x_global
    dx = float(np.abs(xb - x).max())
    over_b = float((xb[far] - cap).max())
    kkt_b, mu_rel_b = box_kkt(A, b, far, cap, xb)
    # the augmented Lagrangian holds G lambda = e only to rtol_E x its
    # tolerance, and a residual there shifts whole subdomains by a constant:
    # x leaves the projected solve's by 7e-4 of the cap and the KKT residual
    # is ten times the projected solve's, so the limits are 1.5e-3 of the cap
    # and 1e-2 ||b||; the far face is held under the cap to 5e-5 of it (8a: 2e-5)
    # and every far-face multiplier to its sign, as in 8a
    log(f"[contact] 8b on the host (scipy f64): max |x - x_projected| {dx:.4e} = {dx / cap:.3e} "
        f"of the cap (limit 1.5e-3), max(x - cap) on the far face {over_b:.3e} (limit 5e-5 cap "
        f"= {2.5 * feas:.3e}), natural KKT residual of the assembled box QP {kkt_b:.3e} ||b|| "
        f"(limit 1e-2), least far-face multiplier {mu_rel_b:.3e} of the largest (limit >= 0); "
        f"peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB")
    res = r3.result
    if res.reason != 2 or res.iterations <= 1 or res.M1_updates < 1:
        raise AssertionError(f"contact 8b: reason {res.reason}, outer {res.iterations}, M1 "
                             f"updates {res.M1_updates}")
    if not (np.isfinite(xb).all() and dx <= 1.5e-3 * cap and over_b <= 2.5 * feas
            and kkt_b <= 1e-2 and mu_rel_b >= 0):
        raise AssertionError(f"contact 8b: dx {dx}, over {over_b}, KKT {kkt_b}, least "
                             f"multiplier {mu_rel_b}")
    if n_b < 4 * res.nmv:
        raise AssertionError(f"contact 8b: {n_b} gather launches for {res.nmv} products")
    launches += n_b
    del A, prob, BI

    # ---- 8c: the lumped dual preconditioner on the twin ---------------------
    cells, grid = TWIN
    tprob = build_sparse(cells, grid)
    gather_apply.launches = 0  # count this path's launches only
    solver = FetiSolverSparse(tprob, FetiOptions(gluing="nonred", pc_dual="lumped"),
                              primal_refine=1, device=dev, **f32)
    ra, ta = timed(solver)
    rb, tb = timed(solver, b_loc=tprob.b_loc * 2.0)
    n_c = gather_apply.launches
    A, b = assembled_system(cells)
    resid = np.linalg.norm(A @ ra.x_global - b) / np.linalg.norm(b)
    lin = np.abs(rb.x_global - 2.0 * ra.x_global).max() / np.abs(rb.x_global).max()
    its_a, its_b = ([r.iterations for r in rr.results] for rr in (ra, rb))
    log(f"[contact] 8c lumped on the twin {cells} / {grid}: first (eager) solve {its_a} dual "
        f"iterations in {ta:.3f} s, warm (fast path) {its_b} in {tb:.3f} s, reasons "
        f"{[r.reason for r in ra.results + rb.results]}, assembled residual {resid:.3e}, "
        f"|x2 - 2 x1|/|x2| {lin:.3e}; gather_apply launches {n_c}")
    if ra.dual_qp is None or rb.dual_qp is not None:
        raise AssertionError("lumped twin: first solve not eager or warm solve not fast")
    if not all(r.reason == 2 for r in ra.results + rb.results) or its_a[0] != its_b[0] \
            or not resid <= 1e-8 or not lin <= 1e-6:
        raise AssertionError(f"lumped twin failed: {its_a} vs {its_b}, residual {resid}")
    if n_c <= 0:
        raise AssertionError("lumped twin: the gather kernel was never launched")
    return launches + n_c


def elastic_kkt(prob, face, gap, x):
    """(natural residual, least multiplier over the largest, clamped-face
    violation) of the elastic contact box QP min 1/2 x'Ax - b'x, x <= gap
    on the dofs ``face``, the clamped dofs eliminated, in scipy f64 from the
    decomposed blocks (no global assembly): ||x - P(x - g)|| / ||b|| over
    the free dofs with g = A x - b, i.e. g on a free dof, max(g, x - gap) on
    a bounded one; the multiplier of a bounded dof is -g."""
    import numpy as np

    from permon_tpu_torch.problems import assembled_gradient_free

    g, free, viol = assembled_gradient_free(prob, x)
    r = np.where(face, np.maximum(g, x - gap), g)[free]
    mu = -g[face]
    mu_rel = float(mu.min() / mu.max()) if mu.max() > 0 else -np.inf
    return float(np.linalg.norm(r) / np.sqrt(free.sum())), mu_rel, viol


def phase_elasticity(bundle, t_build, dev):
    """3-D elasticity at 1,179,750 dofs through the large path: linear with
    a defect pass, then projected contact, kernel against plain.  Returns
    the gather_apply launches of the solves that ran on the kernel."""
    import numpy as np
    import torch

    from permon_tpu_torch.core.convergence import Tolerances
    from permon_tpu_torch.core.sell import gather_apply
    from permon_tpu_torch.feti.large import BlockCoarse, FetiSolverSparse
    from permon_tpu_torch.feti.solve import FetiOptions
    from permon_tpu_torch.problems import assembled_residual_free

    cells, _ = ELASTICITY
    prob, BI, cI, gap = bundle
    tol = Tolerances(rtol=1e-5)
    f32 = dict(kplus_dtype=torch.float32, kplus_refine=2)
    base = dict(gluing="nonred", nullspace="rbm", deterministic=True, coarse="sparse",
                dirichlet_by_B=False)

    def timed(solver, **kw):
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        r = solver.solve(tol=tol, **kw)
        torch.cuda.synchronize(dev)
        return r, time.perf_counter() - t

    def check_coarse(solver):
        G = solver._pf.G
        if not isinstance(G, BlockCoarse) or solver._pf.ggt_inv is None:
            raise AssertionError(f"elasticity: G is a {type(G).__name__}, not a BlockCoarse "
                                 "with the explicit coarse inverse")
        return G

    # ---- 9a: linear ---------------------------------------------------------
    torch.cuda.reset_peak_memory_stats(dev)
    gather_apply.launches = 0  # count this path's launches only
    t0 = time.perf_counter()
    solver = FetiSolverSparse(prob, FetiOptions(**base), primal_refine=1, device=dev, **f32)
    t_ctor = time.perf_counter() - t0
    r1, t1 = timed(solver)
    n_first = gather_apply.launches
    r2, t2 = timed(solver, b_loc=prob.b_loc * 1.001)
    r3, t3 = timed(solver, b_loc=prob.b_loc * 1.002)
    launches = gather_apply.launches
    peak = torch.cuda.max_memory_allocated(dev)
    G = check_coarse(solver)
    qp = solver.qp
    log(f"[elasticity] {prob.n_global} dofs, {prob.ns} subdomains of <= {prob.nl} dofs, NB "
        f"{solver.NB}, {solver.kplus.Dinv.shape[0]} block rows, f32 factors "
        f"{2 * solver.kplus.Dinv.numel() * 4 / 1e9:.2f} GB, stencil diagonals "
        f"{len(qp.A.offsets)}, k {qp.R.shape[1]}, gluing rows {qp.BE.shape[0]}, G a BlockCoarse "
        f"{G.shape} with kf {G.Rb.shape[2]} ({G.shape[0] * G.shape[1] / 2**26:.2f} x 2^26 "
        "elements as a dense array)")
    log(f"[elasticity] host setup {t_build + solver.timings['host_setup_s']:.3f} s (problem "
        f"build {t_build:.3f} s), factorization {solver.timings['factor_s']:.3f} s, constructor "
        f"{t_ctor:.3f} s, peak device memory {peak / 2**30:.3f} GiB")
    its = [[r.iterations for r in rr.results] for rr in (r1, r2, r3)]
    reasons = [r.reason for rr in (r1, r2, r3) for r in rr.results]
    log(f"[elasticity] 9a linear: first solve {t1:.3f} s (the coarse build included), dual CG "
        f"iterations {its[0]}; re-solve with 1.001 b {t2:.3f} s {its[1]}; warm re-solve with "
        f"1.002 b {t3:.3f} s {its[2]}; reasons {reasons}; {1e3 * t3 / sum(its[2]):.3f} ms per "
        f"dual iteration; gather_apply launches {launches} ({n_first} in the first solve)")
    resid, viol = assembled_residual_free(prob, r1.x_global)
    lin = np.abs(r3.x_global - 1.002 * r1.x_global).max() / np.abs(r3.x_global).max()
    # one defect pass at rtol 1e-5 leaves ||A x - b|| / ||b|| near 1e-4 for a
    # solution of ~3.6e3 (b = 1): held to 2e-4; a second pass (the same
    # factors, one more dual solve) is held to 1e-5
    solver.primal_refine = 2
    r4, t4 = timed(solver)
    solver.primal_refine = 1
    resid2, _ = assembled_residual_free(prob, r4.x_global)
    reasons += [r.reason for r in r4.results]
    log(f"[elasticity] 9a on the host (scipy f64, decomposed blocks): assembled residual on "
        f"the free dofs {resid:.3e} (limit 2e-4), largest |u| on the clamped face {viol:.1e} "
        f"(limit: exactly 0), linearity |x3 - 1.002 x1| / |x3| {lin:.3e} (limit 1e-5), max |u| "
        f"{np.abs(r1.x_global).max():.2f}; with a second defect pass "
        f"({[r.iterations for r in r4.results]} iterations, {t4:.3f} s) {resid2:.3e} (limit 1e-5)")
    if not all(r == 2 for r in reasons):
        raise AssertionError(f"elasticity 9a: reasons {reasons}")
    if r1.dual_qp is not None or n_first <= 0:
        raise AssertionError("elasticity 9a: the fast path or the gather kernel did not run")
    if not (np.isfinite(r1.x_global).all() and resid <= 2e-4 and viol == 0.0 and lin <= 1e-5
            and resid2 <= 1e-5):
        raise AssertionError(f"elasticity 9a: residual {resid} (two passes {resid2}), clamped "
                             f"{viol}, linearity {lin}")

    # where the time of a warm re-solve goes
    profile_solve("elasticity", lambda: solver.solve(b_loc=prob.b_loc * 1.002, tol=tol), t3)
    pf = solver._pf
    lam = torch.as_tensor(np.random.RandomState(1).standard_normal(qp.BE.shape[0]), device=dev)
    v = qp.BE.rmv(lam)
    w = G.mv(lam)
    breakdown("elasticity", {
        "B' (rmv)": lambda: qp.BE.rmv(lam), "B (mv)": lambda: qp.BE.mv(v),
        "K+ (f32, unrefined, NB 384 x 35 rows)": lambda: solver.kplus.mv(v),
        "K+ refined (2 steps)": lambda: solver.kplus_post.mv(v),
        "A (the stencil)": lambda: qp.A.mv(v),
        "P (coarse projector)": lambda: pf.apply_p(lam),
        "G (BlockCoarse mv: B' + tree)": lambda: G.mv(lam),
        "G' (BlockCoarse rmv: kf adds + B)": lambda: G.rmv(w),
        "coarse solve (explicit inverse as a tree)": lambda: pf.apply_cp(w),
    })
    x_lin = r1.x_global
    del solver, qp, pf, G, r1, r2, r3, r4, lam, v, w

    # ---- 9b: projected contact ------------------------------------------------
    torch.cuda.reset_peak_memory_stats(dev)
    gather_apply.launches = 0  # count this path's launches only
    solver = FetiSolverSparse(prob, FetiOptions(**base), BI=BI, cI=cI, device=dev, **f32)
    c1, tc1 = timed(solver)
    n_c1 = gather_apply.launches
    c2, tc2 = timed(solver, b_loc=prob.b_loc * 1.001)
    n_contact = gather_apply.launches
    check_coarse(solver)
    peak = torch.cuda.max_memory_allocated(dev)
    for tag, r, t, n in (("first solve", c1, tc1, n_c1),
                         ("warm re-solve with 1.001 b", c2, tc2, n_contact - n_c1)):
        res = r.result
        # every F apply launches the kernel four times (B' and B of BE and of
        # BI); every G or G' apply of the BlockCoarse four more
        log(f"[elasticity] 9b projected contact, {tag}: reason {res.reason}, outer "
            f"{res.iterations}, inner {res.inner_iterations}, Hessian products {res.nmv} "
            f"(cg/exp/prop {res.ncg}/{res.nexp}/{res.nprop}), M1 updates {res.M1_updates}, rho "
            f"updates {res.rho_updates} (the JAX package's capture of this shape counted 28 "
            f"outer / 701 inner / 970 products with f32 factor recurrences), {t:.3f} s = "
            f"{1e3 * t / max(res.nmv, 1):.3f} ms per product with all that rides on it; "
            f"gather_apply launches {n}")
        if res.reason != 2:
            raise AssertionError(f"elasticity 9b {tag}: reason {res.reason}")
    log(f"[elasticity] 9b: contact rows {solver.qp.BI.shape[0]}, gap {gap:.2f}, peak device "
        f"memory {peak / 2**30:.3f} GiB")
    if c1.dual_qp is not None or n_c1 <= 0 or n_contact <= n_c1:
        raise AssertionError("elasticity 9b: the fast path or the gather kernel did not run")
    face = far_face_x_dofs(prob.n_global, cells)

    def host_checks(tag, x, limits):
        """Feasibility and KKT of a contact solution on the host; the limits
        are (over the gap / gap, KKT / ||b||, least multiplier / largest)."""
        over = float((x[face] - gap).max())
        n_active = int((x[face] >= gap - limits[0] * gap).sum())
        kkt, mu_rel, viol = elastic_kkt(prob, face, gap, x)
        log(f"[elasticity] {tag} on the host (scipy f64, decomposed blocks): max(u_x - gap) on "
            f"the far face {over:.3e} = {over / gap:.3e} of the gap (limit {limits[0]:g}), "
            f"{n_active} of {int(face.sum())} far-face nodes within that of the plane, natural "
            f"KKT residual of the box QP {kkt:.3e} ||b|| (limit {limits[1]:g}), least far-face "
            f"multiplier {mu_rel:.3e} of the largest (limit >= {-limits[2]:g}), clamped face "
            f"{viol:.1e} (limit: exactly 0)")
        if not (np.isfinite(x).all() and over <= limits[0] * gap and n_active > 0
                and kkt <= limits[1] and mu_rel >= -limits[2] and viol == 0.0):
            raise AssertionError(f"elasticity {tag}: over {over}, active {n_active}, KKT {kkt}, "
                                 f"least multiplier {mu_rel}, clamped {viol}")

    x = c1.x_global
    log(f"[elasticity] the free solution's far face reaches u_x = {x_lin[face].max():.2f}, the "
        f"plane stands at {gap:.2f}")
    if not x_lin[face].max() > gap:
        raise AssertionError("elasticity 9b: the obstacle does not bind")
    # The dual residual IS the primal infeasibility (jumps and penetration),
    # and the dual stops at 1e-5 of ||d||, which holds the huge rigid-body
    # parts of K+ b: at this recipe the far face ends ~5% of the gap inside
    # the plane and the KKT residual near 0.3 ||b||.  A linear solve repairs
    # the like by its defect pass; for contact there is none.  These limits
    # say "the recipe did what it does"; the KKT point is held below
    host_checks("9b (f32 factors, rtol 1e-5)", x, (0.1, 0.5, 0.2))
    move = np.abs(c2.x_global - x).max()
    if not 0 < move < 0.01 * np.abs(x).max():
        raise AssertionError(f"elasticity 9b: the warm re-solve moved x by {move}")
    del solver, c2

    # the same solve through the plain gather version
    gather_apply.launches = 0
    plain = FetiSolverSparse(prob, FetiOptions(**base, gather_kernel=False), BI=BI, cI=cI,
                             device=dev, **f32)
    cq, tq = timed(plain)
    del plain
    if gather_apply.launches != 0:
        raise AssertionError("elasticity: gather_kernel=False launched the kernel")
    if smalxe_counts(cq.result) != smalxe_counts(c1.result) or \
            not np.array_equal(cq.x_global, c1.x_global):
        raise AssertionError(f"elasticity: kernel and plain solves differ: "
                             f"{smalxe_counts(c1.result)} vs {smalxe_counts(cq.result)}")
    log(f"[elasticity] 9b gather_kernel=False: same counts, bitwise equal x_global; {tq:.3f} s")
    del cq, c1

    # the KKT point: f64 factors, rtol 1e-9
    torch.cuda.reset_peak_memory_stats(dev)
    gather_apply.launches = 0  # count this path's launches only
    tight = FetiSolverSparse(prob, FetiOptions(**base), BI=BI, cI=cI, device=dev)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    ck = tight.solve(tol=Tolerances(rtol=1e-9, max_it=20000))
    torch.cuda.synchronize(dev)
    tk = time.perf_counter() - t0
    n_tight = gather_apply.launches
    res = ck.result
    log(f"[elasticity] 9b f64 factors, rtol 1e-9: reason {res.reason}, outer {res.iterations}, "
        f"inner {res.inner_iterations}, Hessian products {res.nmv}, M1 updates "
        f"{res.M1_updates}, {tk:.3f} s = {1e3 * tk / max(res.nmv, 1):.3f} ms per product, "
        f"factorization {tight.timings['factor_s']:.3f} s, peak device memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB; gather_apply launches {n_tight}")
    del tight
    if res.reason != 2 or n_tight <= 0:
        raise AssertionError(f"elasticity 9b f64: reason {res.reason}")
    host_checks("9b (f64 factors, rtol 1e-9)", ck.x_global, (2e-5, 1e-4, 1e-4))
    return launches + n_contact + n_tight


def far_face_x_dofs(n_global, cells):
    """Mask of the x-dofs of the far face x = Lx (3 dofs per node)."""
    import numpy as np

    Mx = cells[0] + 1
    ids = np.arange(n_global)
    return (ids % 3 == 0) & ((ids // 3) % Mx == Mx - 1)


def phase_elastic_tolerances(bundle, dev):
    """9t (``--only=9t``, no part of the default run): how far projected
    elastic contact at 1,179,750 dofs stands from a KKT point, by factor
    precision and dual tolerance."""
    import torch

    from permon_tpu_torch.core.convergence import Tolerances
    from permon_tpu_torch.feti.large import FetiSolverSparse
    from permon_tpu_torch.feti.solve import FetiOptions

    prob, BI, cI, gap = bundle
    face = far_face_x_dofs(prob.n_global, ELASTICITY[0])
    opts = FetiOptions(gluing="nonred", nullspace="rbm", deterministic=True, coarse="sparse",
                       dirichlet_by_B=False)
    for name, kw, rtols in (("f32 factors + 2 refinement steps",
                             dict(kplus_dtype=torch.float32, kplus_refine=2), (1e-5, 1e-7)),
                            ("f64 factors", {}, (1e-5, 1e-7, 1e-9))):
        solver = FetiSolverSparse(prob, opts, BI=BI, cI=cI, device=dev, **kw)
        for rtol in rtols:
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            r = solver.solve(tol=Tolerances(rtol=rtol, max_it=20000))
            torch.cuda.synchronize(dev)
            t = time.perf_counter() - t0
            kkt, mu_rel, _ = elastic_kkt(prob, face, gap, r.x_global)
            over = float((r.x_global[face] - gap).max())
            log(f"[elasticity] 9t {name}, rtol {rtol:g}: reason {r.result.reason}, outer / inner "
                f"/ products / M1 / rho {smalxe_counts(r.result)}, {t:.1f} s; max(u_x - gap) "
                f"{over / gap:.3e} of the gap, natural KKT residual {kkt:.3e} ||b||, least "
                f"multiplier {mu_rel:.3e} of the largest")
        del solver


def phase_elastic_smalbe(dev, f64_factors=False, rtol_E=0.1, inner_max_it=10000):
    """9c (``--only=9c``, no part of the default run): SMALBE proper
    (project=False, rtol_E 0.1) on elastic contact at 361,416 dofs, against
    its projected twin, both by the recipe of phase 9b (f32 factors + 2
    refinement steps, rtol 1e-5).  ``--9c-f64`` factors in f64 instead,
    ``--9c-rtol-E=v`` sets SMALBE's rtol_E (the diagnosis of PERF.md §6),
    ``--9c-inner-max-it=n`` SMALXE's budget of inner iterations (summed over
    the outer loop; 10,000 by default in both packages), a diagnostic of
    fault C2 only (ROADMAP §C).  Each inner solve of SMALBE prints one
    ``[c2] outer`` line through scripts/c2_smalbe_compare.py's
    ``torch_c2_log`` (the script makes the CPU runs of both packages it is
    compared with): the inner iterations and reason, the M1 and rho the
    inner solve ran with, its last G, E and max(G, E), the state; SMALXE's
    own per-outer monitor (``monitor_outer``) prints its block after each.
    Returns the gather_apply launches."""
    import contextlib

    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts"))
    from c2_smalbe_compare import torch_c2_log

    from permon_tpu_torch.core.convergence import Tolerances
    from permon_tpu_torch.core.sell import gather_apply
    from permon_tpu_torch.feti.large import FetiSolverSparse
    from permon_tpu_torch.feti.solve import FetiOptions
    from permon_tpu_torch.problems import build_obstacle_elasticity
    from permon_tpu_torch.solvers.smalxe import SMALXEOptions

    cells, grid = SMALBE_ELASTICITY
    prob, BI, cI, gap = build_obstacle_elasticity(cells, grid)
    face = far_face_x_dofs(prob.n_global, cells)
    tol = Tolerances(rtol=1e-5)
    factors = {} if f64_factors else dict(kplus_dtype=torch.float32, kplus_refine=2)
    log(f"[elasticity] 9c: {'f64' if f64_factors else 'f32 + 2 refinement steps'} factors, "
        f"SMALBE rtol_E {rtol_E:g}, budget of {inner_max_it} inner iterations")
    base = dict(gluing="nonred", nullspace="rbm", deterministic=True, coarse="sparse",
                dirichlet_by_B=False)
    gather_apply.launches = 0  # count this path's launches only
    out = {}
    for tag, extra in (("projected", {}),
                       ("SMALBE", dict(project=False, smalxe=SMALXEOptions(
                           rtol_E=rtol_E, inner_max_it=inner_max_it, monitor_outer=True)))):
        solver = FetiSolverSparse(prob, FetiOptions(**base, **extra), BI=BI, cI=cI, device=dev,
                                  **factors)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        with torch_c2_log(log) if tag == "SMALBE" else contextlib.nullcontext():
            r = solver.solve(tol=tol)
        torch.cuda.synchronize(dev)
        t = time.perf_counter() - t0
        del solver
        res, x = r.result, r.x_global
        kkt, mu_rel, viol = elastic_kkt(prob, face, gap, x)
        over = float((x[face] - gap).max())
        log(f"[elasticity] 9c {tag} at {prob.n_global} dofs, {prob.ns} subdomains: reason "
            f"{res.reason}, outer {res.iterations}, inner {res.inner_iterations}, Hessian "
            f"products {res.nmv}, M1 updates {res.M1_updates}, rho updates {res.rho_updates}, "
            f"{t:.3f} s; on the host: max(u_x - gap) {over / gap:.3e} of the gap, natural KKT "
            f"residual {kkt:.3e} ||b||, least multiplier {mu_rel:.3e} of the largest, clamped "
            f"face {viol:.1e}")
        if res.reason != 2 or not np.isfinite(x).all() or viol != 0.0:
            raise AssertionError(f"elasticity 9c {tag}: reason {res.reason}, clamped {viol}")
        out[tag] = (res, x, over, kkt)
    res, xb, over, kkt = out["SMALBE"]
    xa = out["projected"][1]
    dx = float(np.abs(xb - xa).max() / np.abs(xa).max())
    # both stop at the loose 1e-5 of phase 9b's recipe: the two solutions are
    # held to each other and to the plane at that recipe's limits
    log(f"[elasticity] 9c: max |x_SMALBE - x_projected| / max |x| {dx:.3e} (limit 2e-2), "
        f"outer iterations {res.iterations} (limit > 1), M1 updates {res.M1_updates} (limit >= 1)")
    if res.iterations <= 1 or res.M1_updates < 1 or not dx <= 2e-2 or not over <= 0.1 * gap \
            or not kkt <= 0.5:
        raise AssertionError(f"elasticity 9c: outer {res.iterations}, M1 {res.M1_updates}, dx "
                             f"{dx}, over {over}, KKT {kkt}")
    return gather_apply.launches


def phase_band_coarse(dev):
    """The band GG' where it switches on by itself (more than 2048 coarse
    rows), and reorder_rcm on the twin.  Returns the gather_apply launches."""
    import numpy as np
    import torch

    from permon_tpu_torch.core.convergence import Tolerances
    from permon_tpu_torch.core.sell import gather_apply
    from permon_tpu_torch.feti.large import (BlockCoarse, FetiSolverSparse, feti_solve_sparse,
                                             reorder_rcm)
    from permon_tpu_torch.feti.solve import FetiOptions
    from permon_tpu_torch.problems import assembled_apply, build_sparse
    from permon_tpu_torch.qp.projector import SPARSE_GGT_THRESHOLD

    cells, grid = BAND_COARSE
    tol = Tolerances(rtol=1e-5)
    f32 = dict(kplus_dtype=torch.float32, kplus_refine=2, primal_refine=1)
    t0 = time.perf_counter()
    prob = build_sparse(cells, grid)
    t_build = time.perf_counter() - t0
    k = int(prob.floating.sum())
    if k <= SPARSE_GGT_THRESHOLD:
        raise AssertionError(f"{grid} gives {k} coarse rows, not more than {SPARSE_GGT_THRESHOLD}")
    torch.cuda.reset_peak_memory_stats(dev)
    gather_apply.launches = 0  # count this path's launches only
    solver = FetiSolverSparse(prob, FetiOptions(gluing="nonred", deterministic=True,
                                                coarse="auto"), device=dev, **f32)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    r1 = solver.solve(tol=tol)
    torch.cuda.synchronize(dev)
    t1 = time.perf_counter()
    r2 = solver.solve(b_loc=prob.b_loc * 1.5, tol=tol)
    torch.cuda.synchronize(dev)
    t2 = time.perf_counter()
    launches = gather_apply.launches
    peak = torch.cuda.max_memory_allocated(dev)
    pf, qp = solver._pf, solver.qp
    if pf.ggt_band is None or pf.ggt_chol is not None or not isinstance(pf.G, BlockCoarse) \
            or pf.G.Rb.shape[2] != 1:
        raise AssertionError(f"band coarse: projector holds band {pf.ggt_band is not None}, G a "
                             f"{type(pf.G).__name__}")
    band = pf.ggt_band
    log(f"[band] {prob.n_global} dofs, {prob.ns} subdomains of <= {prob.nl} dofs, NB {solver.NB}, "
        f"{solver.kplus.Dinv.shape[0]} block rows, k {k}, gluing rows {qp.BE.shape[0]}; G a "
        f"BlockCoarse {pf.G.shape} with kf 1; GG' as a band: NB {band.Dinv.shape[2]}, "
        f"{band.Dinv.shape[0]} block rows, {str(band.Dinv.dtype)[6:]} factors "
        f"{2 * band.Dinv.numel() * band.Dinv.element_size() / 1e6:.1f} MB")
    log(f"[band] host setup {t_build + solver.timings['host_setup_s']:.3f} s (problem build "
        f"{t_build:.3f} s), factorization {solver.timings['factor_s']:.3f} s, peak device "
        f"memory {peak / 2**30:.3f} GiB")
    its1, its2 = ([r.iterations for r in rr.results] for rr in (r1, r2))
    reasons = [r.reason for r in r1.results + r2.results]
    b = np.ones(prob.n_global)
    resid = np.linalg.norm(assembled_apply(prob, r1.x_global) - b) / np.linalg.norm(b)
    lin = np.abs(r2.x_global - 1.5 * r1.x_global).max() / np.abs(r2.x_global).max()
    log(f"[band] first solve {t1 - t0:.3f} s (the coarse build and the band factorization "
        f"included), dual CG iterations {its1}; warm re-solve {t2 - t1:.3f} s {its2}; reasons "
        f"{reasons}; {1e3 * (t2 - t1) / sum(its2):.3f} ms per dual iteration; assembled residual "
        f"(scipy f64, decomposed blocks) {resid:.3e} (limit 1e-6); |x2 - 1.5 x1| / |x2| "
        f"{lin:.3e}; gather_apply launches {launches}")
    if not all(r == 2 for r in reasons) or r1.dual_qp is not None or launches <= 0:
        raise AssertionError(f"band coarse: reasons {reasons}, fast path {r1.dual_qp is None}")
    if not (np.isfinite(r1.x_global).all() and resid <= 1e-6 and lin <= 1e-6):
        raise AssertionError(f"band coarse: residual {resid}, linearity {lin}")
    lam = torch.as_tensor(np.random.RandomState(1).standard_normal(qp.BE.shape[0]), device=dev)
    w = pf.G.mv(lam)
    y = pf.apply_cp(w)
    if not torch.equal(pf.apply_cp(w), y):
        raise AssertionError("band coarse: two coarse solves of one vector differ")
    gy = pf.G.mv(pf.G.rmv(y))  # (GG') y = w
    err = float((gy - w).abs().max() / w.abs().max())
    log(f"[band] the coarse solve: |GG' y - w| / |w| {err:.2e} (limit 1e-10)")
    if not err <= 1e-10:
        raise AssertionError(f"band coarse: the coarse solve is off by {err}")
    breakdown("band", {
        "coarse solve (band substitutions)": lambda: pf.apply_cp(w),
        "G (BlockCoarse mv)": lambda: pf.G.mv(lam), "G' (BlockCoarse rmv)": lambda: pf.G.rmv(w),
        "P (coarse projector)": lambda: pf.apply_p(lam),
        "K+ (f32, unrefined)": lambda: solver.kplus.mv(qp.BE.rmv(lam)),
    })
    del solver, pf, qp, prob

    # reorder_rcm on the twin: a renumbering, the same solution
    twin = build_sparse(*TWIN)
    opts = FetiOptions(gluing="nonred")
    gather_apply.launches = 0  # count this path's launches only
    ra = feti_solve_sparse(twin, opts, tol=tol, device=dev, **f32)
    t0 = time.perf_counter()
    twin_rcm = reorder_rcm(twin)
    t_rcm = time.perf_counter() - t0
    rb = feti_solve_sparse(twin_rcm, opts, tol=tol, device=dev, **f32)
    dx = np.abs(ra.x_global - rb.x_global).max() / np.abs(ra.x_global).max()
    its_a, its_b = ra.results[0].iterations, rb.results[0].iterations
    log(f"[band] reorder_rcm on the twin {TWIN[0]} / {TWIN[1]} ({t_rcm:.3f} s): dual CG "
        f"iterations {its_a} before, {its_b} after (limit: within 1), |x - x_rcm| / |x| "
        f"{dx:.3e} (limit 1e-7)")
    if ra.result.reason != 2 or rb.result.reason != 2 or not dx <= 1e-7 \
            or abs(its_a - its_b) > 1:
        raise AssertionError("reorder_rcm changed the twin's solution or its count")
    return launches + gather_apply.launches


def matis_residual(prob, x):
    """||A x - b|| / ||b|| of the assembled problem of a FetiProblem, on the
    host in numpy f64: A x = sum_s P_s' K_s P_s x, b the copy sum of b_loc."""
    import numpy as np

    real = prob.l2g >= 0
    xl = np.where(real, x[np.maximum(prob.l2g, 0)], 0.0)
    y = np.matmul(prob.K_blocks, xl[:, :, None])[:, :, 0]
    ids = prob.l2g[real]
    Ax = np.bincount(ids, weights=y[real], minlength=prob.n_global)
    b = np.bincount(ids, weights=prob.b_loc[real], minlength=prob.n_global)
    return float(np.linalg.norm(Ax - b) / np.linalg.norm(b))


def dense_tables_timed(tables, dev, tag="dense"):
    """Gather tables of phases 12a / 13a through the kernel: bitwise against
    the plain version, then one launch with a cold L2 (CUDA events), the
    kernel alone (profiler), the call period, the plain version, the
    library call (torch.mv on the CSR of the same entries) and the bound,
    in the table's dtype."""
    import numpy as np
    import torch

    from permon_tpu_torch.core.sell import gather_apply, kernel_launchers

    flush = torch.empty(1 << 28, dtype=torch.uint8, device=dev)
    rng = np.random.RandomState(12)
    for name, tab in tables.items():
        xt = torch.as_tensor(rng.standard_normal(tab.n_src), dtype=tab.vals.dtype, device=dev)
        plain = tab.replace(kernel=False)
        n0 = gather_apply.launches
        got, ref = tab.apply(xt), plain.apply(xt)
        torch.cuda.synchronize()
        if gather_apply.launches != n0 + 1 or not torch.equal(got, ref):
            raise AssertionError(f"dense table {name}: kernel != plain or not one launch")
        new, _ = kernel_launchers(tab, xt)
        t = turns_ms({"new": new[0]}, flush)["new"][0]
        k = kernel_only_ms(new[0], flush)
        call = cuda_ms(lambda: tab.apply(xt))
        plain_ms = cuda_ms(lambda: plain.apply(xt), reps=5, warmup=1, flush=flush)
        lib_ms, lib_y = library_spmv_ms(gather_table_csr(tab), xt, flush)
        lib_err = float((lib_y - got).abs().max() / got.abs().max().clamp(min=1e-300))
        nbytes, flops = gather_table_work(tab, xt, got)
        b_ms, b_by = bound_ms(nbytes, flops, str(tab.vals.dtype)[6:])
        log(f"[{tag}] table {name}: {tuple(tab.idx.shape)} {str(tab.vals.dtype)[6:]}"
            + ("" if tab.ov_idx is None else f" + overflow {tuple(tab.ov_idx.shape)}")
            + f", kernel = plain bitwise; one launch, cold L2 {t:.4f} ms, kernel alone "
            f"{fmt_ms(k)}, call period {call:.4f} ms, plain {plain_ms:.4f} ms, library "
            f"(torch.mv on the CSR) {lib_ms:.4f} ms (relative difference {lib_err:.1e}), bound "
            f"{b_ms:.4f} ms by {b_by} ({nbytes / 1e6:.2f} MB)")


def phase_dense(dev):
    """12: the dense TFETI path (feti_solve / FetiSolver on a FetiProblem,
    all_in_one, the MATIS entry), every B / B' / copy sum on the gather
    kernel.  Returns the gather_apply launches of 12a and 12b, and the row
    results that phase 13 holds the leaf path against ("12a": prob,
    x_global, iterations, ms per iteration; ("12b", pc): iterations, ms)."""
    import dataclasses

    import numpy as np
    import torch

    from permon_tpu_torch.core.convergence import Tolerances
    from permon_tpu_torch.core.sell import gather_apply
    from permon_tpu_torch.core.extension import copy_sum_table
    from permon_tpu_torch.feti.solve import FetiOptions, FetiSolver, _feti_solve_impl
    from permon_tpu_torch.problems import build_ex71

    tol = Tolerances(rtol=1e-5)
    launches, rows = 0, {}

    # -- 12a: 3-D Poisson at 262,144 dofs, FetiOptions() defaults ----------
    cells, grid = DENSE_POISSON
    t0 = time.perf_counter()
    prob = build_ex71(cells, grid)
    t_build = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    gather_apply.launches = 0  # count this path's launches only
    solver = FetiSolver(prob, FetiOptions(), device=dev)
    t0 = time.perf_counter()
    r1 = solver.solve(tol=tol)
    torch.cuda.synchronize(dev)
    t_first = time.perf_counter() - t0
    warm = []
    for c in (1.5, 0.5, 2.0):
        t0 = time.perf_counter()
        rw = solver.solve(b_loc=c * prob.b_loc, tol=tol)
        torch.cuda.synchronize(dev)
        warm.append((time.perf_counter() - t0, c, rw))
    n_a = gather_apply.launches
    launches += n_a
    peak = torch.cuda.max_memory_allocated(dev)
    t_warm = sorted(w[0] for w in warm)[1]
    its = r1.result.iterations
    resid = matis_residual(prob, r1.x_global)
    lin = max(np.abs(rw.x_global - c * r1.x_global).max() for _, c, rw in warm) / \
        np.abs(r1.x_global).max()
    tm = solver.timings
    qp, pf = solver.qp, solver._pf
    log(f"[dense] 12a ex71 {cells} on {grid}: {prob.n_global} dofs, {prob.ns} subdomains of "
        f"<= {prob.nl} dofs, {int((~solver._fixed_mask).sum())} floating, m {qp.BE.shape[0]} "
        f"(full gluing), k {qp.R.shape[1]}, G {type(pf.G).__name__}")
    log(f"[dense] 12a host build {t_build:.3f} s, assembly {tm['host_setup_s']:.3f} s, "
        f"floating detection (batched eigvalsh) {tm['floating_s']:.3f} s, K+ factorization "
        f"({prob.ns} batched Cholesky of {prob.nl}^2) {tm['factor_s']:.3f} s")
    log(f"[dense] 12a first solve {t_first:.3f} s, reason {r1.result.reason}, {its} dual CG "
        f"iterations; warm re-solves {', '.join(f'{w[0]:.3f}' for w in warm)} s (median "
        f"{t_warm:.3f} s, iterations {[w[2].result.iterations for w in warm]}); "
        f"{1e3 * t_warm / max(its, 1):.3f} ms per dual iteration")
    log(f"[dense] 12a assembled residual {resid:.3e} (limit {DENSE_RESID_LIMIT['poisson']:.1e}); "
        f"linearity of the re-solves {lin:.3e}; peak device memory {peak / 2**30:.3f} GiB; "
        f"gather_apply launches {n_a}")
    if r1.result.reason != 2 or any(w[2].result.reason != 2 for w in warm):
        raise AssertionError("12a: a solve did not reach reason 2")
    if not resid <= DENSE_RESID_LIMIT["poisson"] or not lin <= 1e-6 or n_a <= 0:
        raise AssertionError(f"12a: residual {resid}, linearity {lin}, launches {n_a}")
    rows["12a"] = dict(prob=prob, x=r1.x_global, its=its, ms_per_it=1e3 * t_warm / max(its, 1))

    # one K+ apply against its bound: the lower triangles read twice
    v = qp.BE.rmv(torch.as_tensor(np.random.RandomState(1).standard_normal(qp.BE.shape[0]),
                                  device=dev))
    kp_ms = cuda_ms(lambda: solver.kplus.mv(v), reps=5, warmup=1)
    kp_dev = device_ms(lambda: solver.kplus.mv(v), reps=5)
    tri = prob.ns * prob.nl * (prob.nl + 1) // 2 * 8
    kb_ms, _ = bound_ms(2 * tri + 3 * v.numel() * 8, 2 * prob.ns * prob.nl ** 2)
    log(f"[dense] 12a one K+ apply (BlockDiagCholInv, 2 batched triangular solves): period "
        f"{kp_ms:.3f} ms, device {fmt_ms(kp_dev)}, bound {kb_ms:.3f} ms ({2 * tri / 1e9:.2f} GB: "
        f"the lower triangles read twice), bound / device "
        f"{kb_ms / kp_dev if kp_dev else float('nan'):.2f}")
    lam = torch.as_tensor(np.random.RandomState(2).standard_normal(qp.BE.shape[0]), device=dev)
    breakdown("dense", {"B' (rmv)": lambda: qp.BE.rmv(lam), "K+": lambda: solver.kplus.mv(v),
                        "B (mv)": lambda: qp.BE.mv(v), "P (coarse projector)":
                        lambda: r1.dual_qp.pf.apply_p(lam)})
    profile_solve("dense", lambda: solver.solve(b_loc=1.5 * prob.b_loc, tol=tol), warm[0][0])
    dense_tables_timed({"B": qp.BE.gB, "B'": qp.BE.gBt,
                        "copy sum": copy_sum_table(prob.l2g, prob.n_global, dev)}, dev)

    # the same factors with every table through the plain version
    opts_plain = FetiOptions(gather_kernel=False)
    n0 = gather_apply.launches
    rp = _feti_solve_impl(prob, opts_plain, tol, qp.replace(BE=qp.BE.with_kernel(False)),
                          solver.kplus, pf=pf)
    same = np.array_equal(rp.x_global, r1.x_global)
    log(f"[dense] 12a through the plain gather version: {rp.result.iterations} iterations, "
        f"x_global bitwise equal {same}, kernel launches {gather_apply.launches - n0}")
    if rp.result.iterations != its or not same or gather_apply.launches != n0:
        raise AssertionError("12a: the plain gather version differs from the kernel")
    del solver, r1, rp, warm, qp, pf, v, lam
    torch.cuda.empty_cache()

    # -- 12b: 3-D elasticity, nonred gluing, rigid body modes --------------
    cells, grid = DENSE_ELASTICITY
    t0 = time.perf_counter()
    prob = build_ex71(cells, grid, pde="elasticity")
    t_build = time.perf_counter() - t0
    gather_apply.launches = 0
    solver = FetiSolver(prob, FetiOptions(gluing="nonred", nullspace="rbm", pc_dual="lumped"),
                        device=dev)
    tm = solver.timings
    log(f"[dense] 12b ex71 elasticity {cells} on {grid}: {prob.n_global} dofs, {prob.ns} "
        f"subdomains of {prob.nl} dofs, m {solver.qp.BE.shape[0]}, k {solver.qp.R.shape[1]}; "
        f"host build {t_build:.3f} s, assembly {tm['host_setup_s']:.3f} s, floating detection "
        f"{tm['floating_s']:.3f} s, K+ factorization {tm['factor_s']:.3f} s")
    for pc in ("lumped", "none"):
        # the preconditioner is read per solve: the same factors serve both
        solver.opts = dataclasses.replace(solver.opts, pc_dual=pc)
        t0 = time.perf_counter()
        r = solver.solve(tol=tol)
        torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        rw = solver.solve(b_loc=2.0 * prob.b_loc, tol=tol)
        torch.cuda.synchronize(dev)
        t2 = time.perf_counter()
        resid = matis_residual(prob, r.x_global)
        lin = np.abs(rw.x_global - 2.0 * r.x_global).max() / np.abs(r.x_global).max()
        log(f"[dense] 12b pc_dual={pc}: reason {r.result.reason}, {r.result.iterations} dual "
            f"CG iterations, first solve {t1 - t0:.3f} s, warm re-solve {t2 - t1:.3f} s "
            f"({1e3 * (t2 - t1) / max(rw.result.iterations, 1):.3f} ms per iteration), "
            f"assembled residual {resid:.3e} (limit {DENSE_RESID_LIMIT['elasticity']:.1e}), "
            f"linearity {lin:.3e}")
        if r.result.reason != 2 or not resid <= DENSE_RESID_LIMIT["elasticity"] or \
                not lin <= 1e-6:
            raise AssertionError(f"12b {pc}: reason {r.result.reason}, residual {resid}")
        rows["12b", pc] = dict(its=r.result.iterations,
                               ms_per_it=1e3 * (t2 - t1) / max(rw.result.iterations, 1))
    n_b = gather_apply.launches
    launches += n_b
    log(f"[dense] 12b gather_apply launches {n_b}")
    if n_b <= 0:
        raise AssertionError("12b: the gather kernel was never launched")
    del solver, r, rw
    torch.cuda.empty_cache()
    phase_dense_reference(dev)
    return launches, rows


def phase_dense_reference(dev):
    """12c: the reference tutorials' own configurations on the card."""
    import numpy as np
    import torch

    import permon_tpu_torch as pt
    from permon_tpu_torch.core.convergence import Tolerances
    from permon_tpu_torch.feti.matis import MatIS, feti_problem_from_matis
    from permon_tpu_torch.feti.solve import (FetiOptions, assemble_global_mean, assemble_qp,
                                             feti_solve, make_blockdiag_kplus)
    from permon_tpu_torch.problems import build_ex1, build_ex71, build_feti_contact, build_feti_ex1
    from permon_tpu_torch.qp.transforms import Solution, all_in_one
    from permon_tpu_torch.solvers.smalxe import SMALXEOptions

    def check(tag, got, want, band=0):
        log(f"[dense] 12c {tag}: {got} (reference {want}" + (f", band {band})" if band else ")"))
        if abs(got - want) > band:
            raise AssertionError(f"12c {tag}: {got} against {want}")

    ex71 = build_ex71()
    for gluing, want in (("nonred", 16), ("full", 9), ("orth", 9)):
        r = feti_solve(ex71, FetiOptions(gluing=gluing), device=dev)
        check(f"ex71 (7, 8, 9) on (1, 2, 3), gluing {gluing}, reason {r.result.reason}",
              r.result.iterations, want)
    for by_B in (True, False):
        r = feti_solve(build_feti_ex1(4, 7), FetiOptions(dirichlet_by_B=by_B), device=dev)
        check(f"ex1, Dirichlet {'by B' if by_B else 'in the Hessian'}", r.result.iterations, 1)
    el = build_ex71((8, 6, 4), (7, 1, 1), pde="elasticity")
    for pc, want in (("none", 64), ("lumped", 26)):
        r = feti_solve(el, FetiOptions(gluing="nonred", pc_dual=pc, nullspace="numeric",
                                       deterministic=True), tol=Tolerances(rtol=1e-6),
                       device=dev)
        check(f"elasticity (8, 6, 4) on (7, 1, 1), numeric nullspace, deterministic, "
              f"pc_dual={pc}", r.result.iterations, want, band=2)
    sm = FetiOptions(project=False, orth_G="gs", smalxe=SMALXEOptions(rho=1e1, inject_maxeig=True))
    got, cpu = (feti_solve(build_feti_ex1(4, 7), sm, device=d).result for d in (dev, "cpu"))
    check("ex1 SMALXE project=False orth_G='gs', outer iterations", got.iterations,
          cpu.iterations)
    check("ex1 SMALXE project=False orth_G='gs', inner iterations", got.inner_iterations,
          cpu.inner_iterations, band=2)

    # contact: the 1-D obstacle on 16 subdomains of 64 elements, both entries
    prob, BI, cI, lb = build_feti_contact(16, 64)
    A, b, lbv = build_ex1(prob.n_global)
    ref = pt.solve(pt.QP.create(A, b, lb=lbv, device=dev), tol=Tolerances(rtol=1e-10)).x
    ref = ref.cpu().numpy()
    opts = FetiOptions(gluing="nonred")
    qp, K, fixed, nb = assemble_qp(prob, opts, device=dev)
    qp = qp.replace(BI=BI.with_gather_apply(dev), cI=torch.as_tensor(cI, device=dev))
    child, post = all_in_one(qp, dual=True, project=True,
                             kplus=make_blockdiag_kplus(K, fixed, prob, nb))
    # rtol 1e-9: at 1e-8 the dual stop leaves 3.2e-6 (CPU), past the limit
    # that tests/test_feti.py holds the 101-node twin to at 1e-8
    res = pt.solve(child, tol=Tolerances(rtol=1e-9))
    sol = post(Solution(x=res.x, Bt_lambda=getattr(res, "Bt_lambda", None)))
    x_a = assemble_global_mean(sol.x.cpu().numpy().reshape(prob.ns, prob.nl), prob.l2g,
                               prob.n_global)
    r = feti_solve(prob, opts, tol=Tolerances(rtol=1e-9), BI=BI, cI=cI, device=dev)
    for tag, x, lam in (("all_in_one", x_a, sol.lambda_I), ("feti_solve(BI=, cI=)", r.x_global,
                                                            r.solution.lambda_I)):
        err = float(np.abs(x - ref).max())
        active = int((x - lb < 1e-8).sum())
        lam_min = float(lam.min())
        log(f"[dense] 12c contact {prob.ns} x {prob.nl - 1} elements through {tag}: "
            f"max |x - x_serial| {err:.3e} (limit 1e-6), {active} active, least lambda_I "
            f"{lam_min:.3e}")
        if not err <= 1e-6 or active < 1 or not lam_min >= -1e-10:
            raise AssertionError(f"12c contact {tag}: error {err}, active {active}")

    # the MATIS entry: ex71 through feti_problem_from_matis
    A = MatIS.create(ex71.K_blocks, ex71.l2g, device=dev)
    mprob, mpost, _ = feti_problem_from_matis(A, np.ones(ex71.n_global), coords=ex71.coords)
    for gluing in ("nonred", "full"):
        rm = feti_solve(mprob, FetiOptions(gluing=gluing), device=dev)
        rd = feti_solve(ex71, FetiOptions(gluing=gluing), device=dev)
        x_post = mpost(Solution(x=rm.u_decomposed)).x.cpu().numpy()  # checks ||Ax - b||
        same = np.array_equal(rm.x_global, rd.x_global)
        log(f"[dense] 12c MATIS entry, gluing {gluing}: {rm.result.iterations} iterations "
            f"against {rd.result.iterations} through the FetiProblem entry, x_global bitwise "
            f"equal {same}, post-solve reassembly against x_global "
            f"{np.abs(x_post - rm.x_global).max():.1e}")
        if rm.result.iterations != rd.result.iterations or not same:
            raise AssertionError("12c: the MATIS entry differs from the FetiProblem entry")


#: phase 13: 'mixed' leaf counts within this many iterations of f64
#: (tests/test_precision.py:142-160), and the f64 leaf count within this many
#: of the row path's on the card (equal on the CPU: tests/test_torch_leaf.py;
#: the explicit-inverse GEMV rounds differently from the triangular solves)
LEAF_MIXED_BAND, LEAF_ROW_BAND = 4, 1
#: 13a: 'mixed' x within this much of max |x_f64| (tests/test_precision.py
#: holds 5e-4 absolute at max |x| = 48.5)
LEAF_MIXED_DX = 1e-5
#: 13b: the elasticity counts within this many of 12b's (the band of the
#: elasticity counts across devices, tests/test_torch_feti_dense_elastic.py)
LEAF_ELASTIC_BAND = 2
#: 13c: the 1-D obstacle on 16 subdomains of 64 elements (bench.py:324-380);
#: there the row and leaf counts differ in both packages (JAX, CPU: 134 / 300
#: against 135 / 316 outer / inner), so the equal counts are held on the
#: tests' 4 x 25
LEAF_CONTACT = (16, 64)
#: 13c: 'mixed' (rtol 1e-6) x within this of the serial solution: the f64 dual
#: stopped at rtol 1e-6 leaves 4.2e-4 there, the f32 state 7.8e-4 (CPU)
LEAF_CONTACT_MIXED_DX = 2e-3
#: 13d: SVC on data of the shape of LIBSVM's a9a (32,561 x 123), linear and
#: rbf on its first rows.  Cut: SMALXE's inner MPRGP has a 10,000-iteration
#: budget, which the linear fit reaches from ~4,000 rows on (the expansion
#: step is ~1 / ||Q||, and ||Q|| grows with n: 32,561 rows on an H100 gave
#: reason -5 after 1 outer / 10,001 inner; n = 4,096 on the CPU 5 / 10,001 in
#: both packages), so the linear fit takes 32,561 halved four times; the rbf
#: fit needs ~2 inner iterations a row (7,981 at 4,096): 8,192 halved once
SVM_A9A = (32561, 123)
SVM_LINEAR_N = 32561 // 16
SVM_RBF_N = 4096
#: 13d: FetiSolver.save / load of this ex71 Poisson solver
CKPT_POISSON = ((31,) * 3, (4,) * 3)


def leaf_apply_work(op):
    """Bytes and flops of one leaf F apply: blk read twice and the explicit
    inverses once (the two batched products against blk, the batched GEMV),
    the (ns, k) input and output and the (ns, nl) intermediates once."""
    ns, k, nl = op.blk.shape
    es = op.blk.element_size()
    nbytes = 2 * _nbytes(op.blk) + _nbytes(op.invs) + es * (2 * ns * k + 2 * ns * nl)
    return nbytes, 4 * ns * k * nl + 2 * ns * nl * nl


def row_poisson_12a(dev, tol):
    """12a's row-path solve, for ``--only=13`` (the default run takes it
    from phase 12)."""
    import torch

    from permon_tpu_torch.feti.solve import FetiOptions, FetiSolver
    from permon_tpu_torch.problems import build_ex71

    prob = build_ex71(*DENSE_POISSON)
    solver = FetiSolver(prob, FetiOptions(), device=dev)
    r = solver.solve(tol=tol)
    rw, t = timed_call(lambda: solver.solve(b_loc=1.5 * prob.b_loc, tol=tol))
    out = dict(prob=prob, x=r.x_global, its=r.result.iterations,
               ms_per_it=1e3 * t / max(rw.result.iterations, 1))
    del solver, r, rw
    torch.cuda.empty_cache()
    return out


def phase_leaf(dev, rows=None, jb_rcm=None, qp_its=None):
    """13: the leaf path (FetiOptions(throughput=True): explicit K+
    inverses, dense extension blocks, the dual iteration in the scaled-leaf
    space with its partner combine on the gather kernel) and the user-side
    modules, against phase 12's ``rows`` and phase 7's ``jb_rcm`` /
    ``qp_its`` (made here when not given).  Returns (gather_apply launches,
    sell_mv launches, 13a's count and x_global for phase 14c)."""
    rows = {} if rows is None else rows
    launches, leaf_13a = phase_leaf_poisson(dev, rows.get("12a"))
    launches += phase_leaf_elastic(dev, rows)
    launches += phase_leaf_contact(dev)
    g, sell_launches = phase_user(dev, jb_rcm, qp_its, leaf_13a)
    r13a = leaf_13a[1]
    return launches + g, sell_launches, dict(its=r13a.result.iterations, x=r13a.x_global)


def phase_leaf_poisson(dev, row=None):
    """13a: 12a's problem (ex71 (63,)^3 on (8,)^3, 262,144 dofs, full
    gluing) on the leaf path, against 12a's ``row`` result.  Returns the
    launches and (solver, first result, tol) for 13d's Timer."""
    import numpy as np
    import torch

    from permon_tpu_torch.core.convergence import Tolerances
    from permon_tpu_torch.core.sell import gather_apply
    from permon_tpu_torch.feti.solve import FetiOptions, FetiSolver, _feti_solve_impl

    tol = Tolerances(rtol=1e-5)
    row = row or row_poisson_12a(dev, tol)
    prob = row["prob"]
    torch.cuda.reset_peak_memory_stats(dev)
    gather_apply.launches = 0
    solver, t_setup = timed_call(lambda: FetiSolver(prob, FetiOptions(throughput=True),
                                                    device=dev))
    r1, t_first = timed_call(lambda: solver.solve(tol=tol))
    warm = []
    for c in (1.5, 0.5, 2.0):
        rw, t = timed_call(lambda: solver.solve(b_loc=c * prob.b_loc, tol=tol))
        warm.append((t, c, rw))
    n_a = gather_apply.launches
    peak = torch.cuda.max_memory_allocated(dev)
    t_warm = sorted(w[0] for w in warm)[1]
    its = r1.result.iterations
    resid = matis_residual(prob, r1.x_global)
    xs = np.abs(row["x"]).max()
    dx = float(np.abs(r1.x_global - row["x"]).max() / xs)
    lin = max(np.abs(rw.x_global - c * r1.x_global).max() for _, c, rw in warm) / \
        np.abs(r1.x_global).max()
    leaf = solver._leaf["leaf"]
    op, sls = leaf.A.op, leaf.A.sp
    log(f"[leaf] 13a ex71 {DENSE_POISSON[0]} on {DENSE_POISSON[1]}: {prob.n_global} dofs, "
        f"leaves {tuple(sls.s.shape)} ({sls.nleaf} flat), deg_max {op.space.comb.idx.shape[0]}, "
        f"blk {tuple(op.blk.shape)} {_nbytes(op.blk) / 1e9:.2f} GB, inverses "
        f"{_nbytes(op.invs) / 1e9:.2f} GB, Gl {tuple(leaf.BE.Gl.shape)} "
        f"{_nbytes(leaf.BE.Gl) / 1e9:.2f} GB; FetiSolver (assembly, blocks, explicit K+) "
        f"{t_setup:.3f} s")
    log(f"[leaf] 13a first solve {t_first:.3f} s (leaf operators built in it), reason "
        f"{r1.result.reason}, {its} dual CG iterations (12a row path: {row['its']}); warm "
        f"re-solves {', '.join(f'{w[0]:.3f}' for w in warm)} s (median {t_warm:.3f} s, "
        f"iterations {[w[2].result.iterations for w in warm]}); {1e3 * t_warm / max(its, 1):.3f} "
        f"ms per dual iteration (12a row path: {row['ms_per_it']:.3f})")
    log(f"[leaf] 13a assembled residual {resid:.3e} (limit {DENSE_RESID_LIMIT['poisson']:.1e}); "
        f"max |x - x_12a| / max |x_12a| {dx:.3e} (limit 1e-4); linearity {lin:.3e}; peak device "
        f"memory {peak / 2**30:.3f} GiB; gather_apply launches {n_a}")
    if r1.result.reason != 2 or any(w[2].result.reason != 2 for w in warm):
        raise AssertionError("13a: a solve did not reach reason 2")
    if abs(its - row["its"]) > LEAF_ROW_BAND or not resid <= DENSE_RESID_LIMIT["poisson"] \
            or not dx <= 1e-4 or not lin <= 1e-6 or n_a <= 0:
        raise AssertionError(f"13a: {its} iterations against {row['its']}, residual {resid}, "
                             f"dx {dx}, linearity {lin}, launches {n_a}")

    # the parts of an iteration against their bounds
    rng = np.random.RandomState(13)
    Lam = sls.space.lift(torch.as_tensor(rng.standard_normal(sls.space.m_dual), device=dev))
    xt = (Lam * sls.s).reshape(-1)
    u = torch.as_tensor(rng.standard_normal(op.invs.shape[:2] + (1,)), device=dev)
    G = leaf.BE.scaled_rows(torch.float64)
    parts = {
        "leaf F apply": (lambda: op.apply(Lam), leaf_apply_work(op)),
        "explicit K+ GEMV": (lambda: torch.bmm(op.invs, u),
                             (_nbytes(op.invs) + 2 * _nbytes(u), 2 * op.invs.numel())),
        "P (LeafG, mv + rmv)": (lambda: leaf.pf.apply_p(xt),
                                (_nbytes(G, leaf.BE.Gl) + 4 * _nbytes(xt),
                                 2 * G.numel() + 2 * leaf.BE.Gl.numel())),
    }
    for name, (fn, (nbytes, flops)) in parts.items():
        per = cuda_ms(fn, reps=5, warmup=1)
        dev_t = device_ms(fn, reps=5)
        b_ms, b_by = bound_ms(nbytes, flops)
        log(f"[leaf] 13a one {name}: period {per:.3f} ms, device {fmt_ms(dev_t)}, bound "
            f"{b_ms:.3f} ms by {b_by} ({nbytes / 1e9:.2f} GB), bound / device "
            f"{b_ms / dev_t if dev_t else float('nan'):.2f}")
    profile_solve("leaf", lambda: solver.solve(b_loc=1.5 * prob.b_loc, tol=tol), warm[0][0])
    sp_ = op.space
    dense_tables_timed({"leaf combine": sp_.comb, "leaf restrict": sp_.restr,
                        "leaf lift": sp_.lift_tab}, dev, tag="leaf")

    # the same factors with every table through the plain version
    n0 = gather_apply.launches
    qp_plain = solver.qp.replace(BE=solver.qp.BE.with_kernel(False))
    rp = _feti_solve_impl(prob, FetiOptions(throughput=True, gather_kernel=False), tol, qp_plain,
                          solver.kplus, pf=solver._pf, leaf_cache={})
    same = np.array_equal(rp.x_global, r1.x_global)
    log(f"[leaf] 13a through the plain gather version: {rp.result.iterations} iterations, "
        f"x_global bitwise equal {same}, kernel launches {gather_apply.launches - n0}")
    if rp.result.iterations != its or not same or gather_apply.launches != n0:
        raise AssertionError("13a: the plain gather version differs from the kernel")
    del rp, qp_plain

    # 'mixed': f32 leaf state with f64 dots, the projector and estimates f64
    n0 = gather_apply.launches
    opts_m = FetiOptions(throughput=True, precision="mixed")
    rm, t_m1 = timed_call(lambda: _feti_solve_impl(prob, opts_m, tol, solver.qp, solver.kplus,
                                                   pf=solver._pf, leaf_cache=solver._leaf))
    rm2, t_m2 = timed_call(lambda: _feti_solve_impl(
        prob, opts_m, tol, solver.qp.replace(b=1.5 * solver.qp.b), solver.kplus, pf=solver._pf,
        leaf_cache=solver._leaf))
    n_m = gather_apply.launches - n0
    dxm = float(np.abs(rm.x_global - r1.x_global).max() / np.abs(r1.x_global).max())
    log(f"[leaf] 13a precision='mixed': reason {rm.result.reason}, {rm.result.iterations} "
        f"iterations (f64: {its}, band {LEAF_MIXED_BAND}), max |x - x_f64| / max |x_f64| "
        f"{dxm:.3e} (limit {LEAF_MIXED_DX:.0e}), first {t_m1:.3f} s (f32 copies "
        f"made), warm {t_m2:.3f} s ({1e3 * t_m2 / max(rm2.result.iterations, 1):.3f} ms per "
        f"iteration), gather_apply launches {n_m}")
    if rm.result.reason != 2 or abs(rm.result.iterations - its) > LEAF_MIXED_BAND \
            or not dxm <= LEAF_MIXED_DX:
        raise AssertionError(f"13a mixed: reason {rm.result.reason}, {rm.result.iterations} "
                             f"iterations, dx {dxm}")
    # the main path's launches: the solves (not the timings, which compare
    # with the plain version and the library)
    return n_a + n_m, (solver, r1, tol)


def phase_leaf_elastic(dev, rows):
    """13b: 12b's elasticity problem on the leaf path (nonred, rbm, lumped
    and none), against 12b's counts in ``rows`` (made here when missing)."""
    import dataclasses

    import numpy as np
    import torch

    from permon_tpu_torch.core.convergence import Tolerances
    from permon_tpu_torch.core.sell import gather_apply
    from permon_tpu_torch.feti.solve import FetiOptions, FetiSolver
    from permon_tpu_torch.problems import build_ex71

    tol = Tolerances(rtol=1e-5)
    prob = build_ex71(*DENSE_ELASTICITY, pde="elasticity")
    base = FetiOptions(gluing="nonred", nullspace="rbm", pc_dual="lumped")
    if ("12b", "lumped") not in rows:  # --only=13: 12b's counts first
        row = FetiSolver(prob, base, device=dev)
        for pc in ("lumped", "none"):
            row.opts = dataclasses.replace(row.opts, pc_dual=pc)
            rows["12b", pc] = dict(its=row.solve(tol=tol).result.iterations,
                                   ms_per_it=float("nan"))
        del row
        torch.cuda.empty_cache()
    gather_apply.launches = 0
    solver, t_setup = timed_call(lambda: FetiSolver(
        prob, dataclasses.replace(base, throughput=True), device=dev))
    for pc in ("lumped", "none"):
        solver.opts = dataclasses.replace(solver.opts, pc_dual=pc)
        r, t1 = timed_call(lambda: solver.solve(tol=tol))
        rw, t2 = timed_call(lambda: solver.solve(b_loc=2.0 * prob.b_loc, tol=tol))
        resid = matis_residual(prob, r.x_global)
        lin = np.abs(rw.x_global - 2.0 * r.x_global).max() / np.abs(r.x_global).max()
        row = rows["12b", pc]
        log(f"[leaf] 13b elasticity {DENSE_ELASTICITY[0]} on {DENSE_ELASTICITY[1]} pc_dual={pc}: "
            f"reason {r.result.reason}, {r.result.iterations} iterations (12b row path: "
            f"{row['its']}), first solve {t1:.3f} s, warm {t2:.3f} s "
            f"({1e3 * t2 / max(rw.result.iterations, 1):.3f} ms per iteration; 12b row path "
            f"{row['ms_per_it']:.3f}), assembled residual {resid:.3e} (limit "
            f"{DENSE_RESID_LIMIT['elasticity']:.1e}), linearity {lin:.3e}; FetiSolver "
            f"{t_setup:.3f} s")
        if r.result.reason != 2 or abs(r.result.iterations - row["its"]) > LEAF_ELASTIC_BAND \
                or not resid <= DENSE_RESID_LIMIT["elasticity"] or not lin <= 1e-6:
            raise AssertionError(f"13b {pc}: reason {r.result.reason}, "
                                 f"{r.result.iterations} iterations, residual {resid}")
    n_b = gather_apply.launches
    log(f"[leaf] 13b gather_apply launches {n_b}")
    if n_b <= 0:
        raise AssertionError("13b: the gather kernel was never launched")
    del solver, r, rw
    torch.cuda.empty_cache()
    return n_b


def phase_leaf_contact(dev):
    """13c: contact on the leaf path: (i) the pins of tests/test_leafqp.py
    (4 x 25 elements, projected and project=False): leaf counts equal to
    the row path's; (ii) bench.py:324-380's configuration (16 x 64, the
    default rtol) through prepare_contact_children + smalxe, row f64, leaf
    f64 and leaf 'mixed', f64 against feti_solve; (iii) x against the serial
    solution."""
    import numpy as np

    import permon_tpu_torch as pt
    from permon_tpu_torch.core.convergence import Tolerances
    from permon_tpu_torch.core.sell import gather_apply
    from permon_tpu_torch.feti.solve import FetiOptions, feti_solve, prepare_contact_children
    from permon_tpu_torch.problems import build_ex1, build_feti_contact
    from permon_tpu_torch.solvers.smalxe import smalxe
    from permon_tpu_torch.viewers import view_convergence_smalxe

    def counts(r):
        return (r.reason, r.iterations, r.inner_iterations)

    gather_apply.launches = 0
    prob, BI, cI, lb = build_feti_contact(4, 25)
    for project in (True, False):
        row, leaf = (feti_solve(prob, FetiOptions(gluing="nonred", project=project,
                                                  throughput=thr), BI=BI, cI=cI, device=dev)
                     for thr in (False, True))
        log(f"[leaf] 13c contact 4 x 25, project={project}: row {counts(row.result)}, leaf "
            f"{counts(leaf.result)} (equal on the CPU, in both packages)")
        if counts(row.result) != counts(leaf.result) or row.result.reason != 2:
            raise AssertionError(f"13c 4 x 25 project={project}: row and leaf counts differ")

    prob, BI, cI, lb = build_feti_contact(*LEAF_CONTACT)
    res_leaf = None
    for name, opts in (("row f64", FetiOptions(gluing="nonred")),
                       ("leaf f64", FetiOptions(gluing="nonred", throughput=True)),
                       ("leaf mixed", FetiOptions(gluing="nonred", throughput=True,
                                                  precision="mixed"))):
        qp, sm, sls = prepare_contact_children(prob, opts, BI, cI, device=dev)
        res, t = timed_call(lambda: smalxe(qp, opts=sm))
        log(f"[leaf] 13c contact {prob.ns} x {prob.nl - 1} elements, {name}: smalxe on "
            f"prepare_contact_children {t:.3f} s, reason / outer / inner {counts(res)}"
            + ("" if sls is None else f"; state {str(qp.b.dtype)[6:]}, dots {qp.dots_dtype}"))
        if res.reason != 2:
            raise AssertionError(f"13c {name}: reason {res.reason}")
        if opts.precision == "f64":
            # the same iteration as feti_solve (solve.py:567-623); under
            # 'mixed' the f32 state is projected after its cast in feti_solve
            # and before it here (as in the JAX package)
            r = feti_solve(prob, opts, BI=BI, cI=cI, device=dev)
            if counts(r.result) != counts(res):
                raise AssertionError(f"13c {name}: prepare_contact_children + smalxe gave "
                                     f"{counts(res)}, feti_solve {counts(r.result)}")
        if name == "leaf f64":
            res_leaf = res
    log("[leaf] 13c view_convergence_smalxe of the leaf f64 solve:\n"
        + view_convergence_smalxe(res_leaf))

    A, b, lbv = build_ex1(prob.n_global)
    ref = pt.solve(pt.QP.create(A, b, lb=lbv, device=dev), tol=Tolerances(rtol=1e-10)).x
    ref = ref.cpu().numpy()
    for name, opts, rtol, limit in (
            ("leaf f64", FetiOptions(gluing="nonred", throughput=True), 1e-9, 1e-6),
            ("leaf mixed", FetiOptions(gluing="nonred", throughput=True, precision="mixed"),
             1e-6, LEAF_CONTACT_MIXED_DX)):
        r = feti_solve(prob, opts, tol=Tolerances(rtol=rtol), BI=BI, cI=cI, device=dev)
        err = float(np.abs(r.x_global - ref).max())
        low = float((r.x_global - lb).min())
        log(f"[leaf] 13c {name} at rtol {rtol:.0e}: {counts(r.result)}, max |x - x_serial| "
            f"{err:.3e} (limit {limit:.0e}), least x - lb {low:.3e} (limit -5e-4), "
            f"{int((r.x_global - lb < 1e-8).sum())} active")
        if r.result.reason != 2 or not err <= limit or not low >= -5e-4:
            raise AssertionError(f"13c {name}: reason {r.result.reason}, error {err}")
    log(f"[leaf] 13c gather_apply launches {gather_apply.launches}")
    if gather_apply.launches <= 0:
        raise AssertionError("13c: the gather kernel was never launched")
    return gather_apply.launches


def phase_user(dev, jb_rcm=None, qp_its=None, leaf_13a=None):
    """13d: the user side: solve_from_options on phase 7's QP, a Timer on
    13a's leaf operator (``leaf_13a``: its solver, first result and tol),
    FetiSolver.save / load, SVC."""
    import numpy as np
    import torch

    import permon_tpu_torch as pt
    from permon_tpu_torch.core.sell import gather_apply, sell_mv
    from permon_tpu_torch.feti.leafqp import leaf_dual_qp
    from permon_tpu_torch.feti.solve import FetiOptions, FetiSolver
    from permon_tpu_torch.problems import build_ex71, build_jbearing, make_a9a_like, rcm_permuted
    from permon_tpu_torch.qp.transforms import enforce_eq_by_projector, homogenize_eq
    from permon_tpu_torch.solvers.cg import cg
    from permon_tpu_torch.svm import SVC
    from permon_tpu_torch.sys import tracing
    from permon_tpu_torch.utils import checkpoint

    gather_apply.launches = 0
    # solve_from_options on the QP of phase 7
    if jb_rcm is None:
        jb_rcm = rcm_permuted(*build_jbearing(*JBEARING))
    Ap, bp, lbp, ubp, _ = jb_rcm
    opts = pt.Options.from_args(["-qps_type", "mprgp", "-qps_rtol", "1e-6"], rc=False)
    qp = pt.QP.create(Ap, bp, lb=lbp, ub=ubp, device=dev)
    if qp_its is None:  # --only=13: phase 7's solve
        qp_its = pt.solve(qp, tol=pt.Tolerances(rtol=1e-6, atol=1e-8)).iterations
    sell_mv.launches = 0
    res, t = timed_call(lambda: pt.solve_from_options(qp, opts))
    n_sell = sell_mv.launches
    log(f"[user] 13d solve_from_options({opts.db}) on the jbearing {JBEARING} QP: reason "
        f"{res.reason}, {res.iterations} iterations (phase 7: {qp_its}), {t:.3f} s, sell_mv "
        f"launches {n_sell} (Hessian products {res.nmv})")
    if res.reason != 2 or res.iterations != qp_its or n_sell < res.nmv:
        raise AssertionError(f"13d options: reason {res.reason}, {res.iterations} iterations")
    del qp, res

    # a Timer around 13a's leaf operator, driven by cg on the leaf QP
    if leaf_13a is not None:
        solver, r1, tol = leaf_13a
        leaf_13a = None
        lq, _ = leaf_dual_qp(r1.dual_qp, None, None, reuse=solver._leaf["leaf"])
        lq = lq.replace(A=pt.Timer(inner=lq.A, name="leaf_F"))
        lq, _ = homogenize_eq(lq)
        lq, _ = enforce_eq_by_projector(lq)
        tracing.reset()
        with tracing.trace("leaf cg"):
            rc = cg(lq, tol=tol)
            torch.cuda.synchronize()
        n_t = tracing.op_counts[("leaf_F", "mv")]
        log(f"[user] 13d Timer around the leaf operator: cg on the leaf QP of leaf_dual_qp, "
            f"reason {rc.reason}, {rc.iterations} iterations (13a: {r1.result.iterations}), "
            f"nmv {rc.nmv}, Timer count {n_t}; tracing.event_report():\n"
            + tracing.event_report())
        if n_t != rc.nmv or rc.reason != 2:
            raise AssertionError(f"13d Timer: {n_t} applications against nmv {rc.nmv}")
        del solver, r1, lq, rc
        torch.cuda.empty_cache()

    # FetiSolver.save / checkpoint.load
    prob = build_ex71(*CKPT_POISSON)
    opts = FetiOptions(gluing="nonred")
    solver = FetiSolver(prob, opts, device=dev)
    solver.solve()
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_checkpoint.npz")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    _, t_save = timed_call(lambda: solver.save(path))
    loaded, t_load = timed_call(lambda: FetiSolver.load(path, prob, opts, device=dev))
    b_new = 0.5 * prob.b_loc + 0.1
    live, again = solver.solve(b_loc=b_new), loaded.solve(b_loc=b_new)
    same = np.array_equal(live.x_global, again.x_global)
    log(f"[user] 13d FetiSolver.save / load of ex71 {CKPT_POISSON[0]} on {CKPT_POISSON[1]}: "
        f"{os.path.getsize(path) / 1e6:.1f} MB, save {t_save:.3f} s, load {t_load:.3f} s; a new "
        f"load: {again.result.iterations} iterations (live {live.result.iterations}), x_global "
        f"bitwise equal {same}")
    os.remove(path)
    if not same or again.result.iterations != live.result.iterations:
        raise AssertionError("13d: the loaded solver differs from the live one")
    del solver, loaded, live, again

    # SVC on data of the shape of a9a, linear; rbf on its first rows
    X, y = make_a9a_like(*SVM_A9A)
    for kernel, n in (("linear", SVM_LINEAR_N), ("rbf", SVM_RBF_N)):
        clf, t = timed_call(lambda: SVC(kernel=kernel, C=1.0, device=dev).fit(X[:n], y[:n]))
        r, a = clf.result_, clf.alpha_
        ya = abs(float(a @ y[:n]))
        eq_tol = clf.rtol * np.sqrt(n)  # rtol_E ||b|| with b = ones: where SMALXE stops
        score = clf.score(X[:n], y[:n])
        log(f"[user] 13d SVC(kernel={kernel!r}) on {n} x {X.shape[1]}: fit {t:.3f} s, reason "
            f"{r.reason}, SMALXE {r.iterations} outer / {r.inner_iterations} inner iterations, "
            f"{len(clf.support_)} support vectors, alpha in [{a.min():.3e}, {a.max():.3e}] "
            f"(C 1), |y'alpha| {ya:.3e} (SMALXE's ||B u|| {r.normBu:.3e}, tolerance "
            f"{eq_tol:.3e}), training score {score:.4f}")
        if r.reason != 2 or a.min() < 0.0 or a.max() > 1.0 or not ya <= 1.001 * eq_tol \
                or not score > 0.5:
            raise AssertionError(f"13d SVC {kernel}: reason {r.reason}, |y'a| {ya}")
        del clf
    torch.cuda.empty_cache()
    return gather_apply.launches, n_sell


def random_sparse(m, n, nnz, rng):
    """Random (m, n) CSR matrix of about nnz normal entries at uniform places."""
    import scipy.sparse as sp

    return sp.csr_matrix((rng.standard_normal(nnz), (rng.randint(0, m, nnz),
                                                     rng.randint(0, n, nnz))), shape=(m, n))


def skewed_matrix(n=20000, seed=0):
    """SpMV matrix (c): unstructured, with a dense row, a dense column and
    64 empty rows."""
    import numpy as np
    import scipy.sparse as sp

    rng = np.random.RandomState(seed)
    a = random_sparse(n, n, 5 * n, rng)
    row = sp.csr_matrix((rng.standard_normal(n), (np.full(n, 17), np.arange(n))), shape=(n, n))
    col = sp.csr_matrix((rng.standard_normal(n), (np.arange(n), np.full(n, 5))), shape=(n, n))
    keep = np.ones(n)
    keep[100:164] = 0.0
    return (sp.diags(keep) @ (a + row + col)).tocsr()


def library_spmv_ms(a, x, flush):
    """Time of the one PyTorch call that computes the same function: a CSR
    tensor times a vector (cuSPARSE).  A yardstick only.  No PyTorch call
    takes bf16 values with an f32 x: for that pair ``a`` holds the values
    widened to f32, so the call moves 8 bytes a slot where the kernel
    moves 6."""
    import torch

    A = torch.sparse_csr_tensor(torch.as_tensor(a.indptr, dtype=torch.int32, device=x.device),
                                torch.as_tensor(a.indices, dtype=torch.int32, device=x.device),
                                torch.as_tensor(a.data, dtype=x.dtype, device=x.device),
                                size=a.shape, check_invariants=False)
    ref = torch.mv(A, x)
    return cuda_ms(lambda: torch.mv(A, x), flush=flush), ref


def spmv_work(op, x):
    """Bytes the product must move (every stored index and value of a real
    nonzero, the row lengths and slice offsets, x and y once each) and its
    flops (2 per nonzero)."""
    m, n = op.shape
    nbytes = (op.nnz * (4 + op.vals.element_size()) + 4 * m + 4 * op.slice_ptr.numel()
              + (m + n) * x.element_size())
    return nbytes, 2 * op.nnz


def phase_spmv(mats, dev):
    """sell_mv against sell_mv_plain (bitwise) and scipy on the main path's
    Hessian, matrices (a), (b), (c) and a rectangular one; returns the JSON
    record fields, taken at the main path's Hessian in f64 with a cold L2
    (between two products the solver loop streams several times the L2's
    size of vectors)."""
    import numpy as np
    import scipy.sparse as sp
    import torch

    from permon_tpu_torch.core import sell
    from permon_tpu_torch.core.sell import SEll, kernel_launchers

    bf16 = torch.bfloat16
    pairs = ((torch.float64, torch.float64), (torch.float32, torch.float32),
             (torch.float32, torch.float64), (torch.float64, torch.float32),
             (bf16, torch.float32), (bf16, torch.float64), (bf16, bf16))
    max_err, record, bf16_record = 0.0, None, {}
    flush = torch.empty(1 << 28, dtype=torch.uint8, device=dev)  # 256 MB > the 50 MB L2
    # what one launch costs whatever it moves: the kernel on a 32 x 32 identity
    tiny = SEll.from_scipy(sp.identity(32, format="csr"), device=dev)
    one = torch.ones(32, dtype=torch.float64, device=dev)
    (fn,), _ = kernel_launchers(tiny, one)
    tiny.mv(one)
    # what a call costs the host, on an operator whose kernel takes no time
    log("[spmv] host cost of one sell_mv call, us: "
        f"check_x {host_us(lambda: sell.check_x(one, 32, one.device)):.2f}, new_empty "
        f"{host_us(lambda: one.new_empty(32)):.2f}, stream lookup "
        f"{host_us(lambda: sell.current_raw_stream(0)):.2f}, the ctypes call with the launch "
        f"{host_us(fn):.2f}, the whole wrapper {host_us(lambda: tiny.mv(one)):.2f}; one "
        f"torch.add for scale {host_us(lambda: torch.add(one, one)):.2f}")
    floor_ms = cuda_ms(fn, flush=flush)
    log(f"[spmv] launch floor (32 x 32 identity, one launch between two events): "
        f"{floor_ms:.4f} ms after the flush, {cuda_ms(fn, reps=200):.4f} ms back to back, "
        f"{fmt_ms(kernel_only_ms(fn, flush))} the kernel alone")
    for name, a in mats.items():
        t0 = time.perf_counter()
        rect = a.shape[0] != a.shape[1]
        op64 = SEll.from_scipy(a, with_transpose=rect, device=dev)
        log(f"[spmv] {name}: {a.shape[0]} x {a.shape[1]}, nnz {a.nnz}, slots {op64.nslots} "
            f"(padding ratio {op64.nslots / max(a.nnz, 1):.4f}), SELL build "
            f"{time.perf_counter() - t0:.2f} s")
        rng = np.random.RandomState(1)
        for vdt, xdt in pairs:
            # the replaced kernel has no bf16 pair; (bf16, f32), the pair
            # 'bf16_mixed' runs, is timed at the main path's shape and (b)
            versions = ("new",) if vdt == bf16 else ("v1", "new")
            timed = vdt != bf16 or (xdt == torch.float32 and name.startswith(("(main)", "(b)")))
            op = op64.replace(vals=op64.vals.to(vdt))
            dirs = [("mv", op, a, a.shape[1])]
            if rect:
                dirs.append(("rmv", op64.t_plan.replace(vals=op64.t_plan.vals.to(vdt)),
                             a.T.tocsr(), a.shape[0]))
            for dname, plan, mat, nx in dirs:
                x = torch.as_tensor(rng.standard_normal(nx), dtype=xdt, device=dev)
                plain = plan.replace(kernel=False)
                got, ref = plan.mv(x), plain.mv(x)
                torch.cuda.synchronize()
                err = float((got.double() - ref.double()).abs().max())
                max_err = max(max_err, err)
                if got.dtype != xdt or not torch.equal(got, ref):
                    raise AssertionError(f"sell_mv != plain on {name} {dname} vals {vdt} "
                                         f"x {xdt}: max abs err {err}")
                key = f"{name} {dname} vals={str(vdt)[6:]} x={str(xdt)[6:]}"
                if vdt == xdt == torch.float64:
                    y = mat @ x.cpu().numpy()
                    rel = float(np.abs(got.cpu().numpy() - y).max() / max(np.abs(y).max(), 1e-300))
                    if not rel <= 1e-12:
                        raise AssertionError(f"sell_mv vs scipy on {key}: {rel}")
                    key += f" (scipy rel err {rel:.1e})"
                fns = {}
                for version in versions:
                    (fn,), out = kernel_launchers(plan, x, version=version)
                    fn()
                    torch.cuda.synchronize()
                    if not torch.equal(out, ref):
                        raise AssertionError(f"sell_mv {version} != plain on {key}")
                    fns[version] = fn
                if mat.nnz < 1e6 or not timed:
                    log(f"[spmv] {key}: all kernels = plain, bitwise")
                    continue
                t = turns_ms(fns, flush)
                tc = turns_ms(fns, flush, clean=True)
                k_new = kernel_only_ms(fns["new"], flush)
                k_old = kernel_only_ms(fns["v1"], flush) if "v1" in fns else None
                log(f"[spmv] {key}: the kernels alone (profiler records, cold L2): new "
                    f"{fmt_ms(k_new)}, v1 {fmt_ms(k_old)}; between events after the buffer was "
                    "read, not rewritten: " + ", ".join(f"{k} {v[0]:.4f} ms" for k, v in tc.items()))
                k_ms = t["new"][0]
                call_ms = cuda_ms(lambda: plan.mv(x))
                p_ms = cuda_ms(lambda: plain.mv(x), reps=5, warmup=1, flush=flush)
                l_ms, lref = None, None
                if vdt == bf16:  # the values widened to f32: the same products
                    wide = mat.copy()
                    wide.data = torch.as_tensor(mat.data).to(bf16).float().numpy()
                    l_ms, lref = library_spmv_ms(wide, x, flush)
                elif vdt == xdt:
                    l_ms, lref = library_spmv_ms(mat.astype(np.dtype(str(vdt)[6:])), x, flush)
                if lref is not None and not torch.allclose(lref, got, rtol=1e-5, atol=1e-5):
                    raise AssertionError(f"torch.mv on the CSR tensor disagrees on {key}")
                nbytes, flops = spmv_work(plan, x)
                b_ms, b_by = bound_ms(nbytes, flops, str(xdt)[6:])
                log(f"[spmv] {key}: all kernels = plain, bitwise; one launch, cold L2: "
                    + ", ".join(f"{k} {v[0]:.4f} ms ({v[1]:.4f}, {v[2]:.4f})"
                                for k, v in t.items())
                    + f"; new: {mat.nnz / k_ms / 1e6:.1f} GnnZ/s, {nbytes / k_ms / 1e6:.0f} GB/s, "
                    f"bound / new {b_ms / k_ms:.2f}; call period back to back {call_ms:.4f} ms; "
                    f"plain {p_ms:.3f} ms, torch.mv(CSR) "
                    f"{'not timed' if l_ms is None else f'{l_ms:.4f} ms'}, bound {b_ms:.4f} ms "
                    f"by {b_by} ({nbytes / 1e6:.1f} MB)")
                if name.startswith("(main)") and vdt == xdt == torch.float64:
                    record = dict(ms=k_ms, v1_ms=t["v1"][0], call_ms=call_ms,
                                  kernel_only_ms=k_new, v1_kernel_only_ms=k_old, plain_ms=p_ms,
                                  bound_ms=b_ms, bound_by=b_by, library_ms=l_ms)
                if name.startswith("(main)") and vdt == bf16:
                    bf16_record = dict(bf16_f32_ms=k_ms, bf16_f32_kernel_only_ms=k_new,
                                       bf16_f32_call_ms=call_ms, bf16_f32_plain_ms=p_ms,
                                       bf16_f32_bound_ms=b_ms, bf16_f32_library_ms=l_ms)
    record.update(max_abs_err=max_err, floor_ms=floor_ms, **bf16_record)
    return record


def host_projected_gradient(A, b, lb, ub, x, astol):
    """||gP|| of x for min 1/2 x'Ax - b'x, lb <= x <= ub, in scipy f64."""
    import numpy as np

    g = A @ x - b
    at_lb = np.abs(x - lb) <= astol
    at_ub = ~at_lb & (np.abs(x - ub) <= astol)
    gP = np.where(at_lb, np.minimum(g, 0.0), np.where(at_ub, np.maximum(g, 0.0), g))
    return float(np.linalg.norm(gP))


def qp_counts(r):
    """(iterations, nmv, ncg, nexp, nprop) of an MPRGP solve."""
    return (r.iterations, r.nmv, r.ncg, r.nexp, r.nprop)


def timed_call(fn):
    """(fn(), seconds), the card synchronized before and after."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_qp(jb, jb_rcm, t_host, dev):
    """The general QP path at full width through the normal entry points."""
    import numpy as np
    import torch

    import permon_tpu_torch as pt
    from permon_tpu_torch.core.dia import Dia
    from permon_tpu_torch.core.eig import max_eigenvalue
    from permon_tpu_torch.core.sell import SEll, gather_apply, sell_mv

    A, rhs, lb, ub = jb
    Ap, bp, lbp, ubp, perm = jb_rcm
    tol = pt.Tolerances(rtol=1e-6, atol=1e-8)

    def timed_solve(qp):
        return timed_call(lambda: pt.solve(qp, tol=tol))

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    qp = pt.QP.create(Ap, bp, lb=lbp, ub=ubp)  # nothing but the default device
    t_create = time.perf_counter() - t0
    sym = (Ap != Ap.T).nnz == 0
    if not isinstance(qp.A, SEll) or qp.b.device.type != dev.type or qp.A.symmetric != sym:
        raise AssertionError(f"QP.create gave {type(qp.A).__name__} on {qp.b.device}, "
                             f"symmetric {getattr(qp.A, 'symmetric', None)} (matrix: {sym})")
    log(f"[qp] jbearing {JBEARING} RCM-ordered: {Ap.shape[0]} unknowns, nnz {Ap.nnz}; "
        f"make_operator chose SEll (symmetric={qp.A.symmetric}, transpose plan "
        f"{qp.A.t_plan is not None}: |A - A'|/|A| = "
        f"{abs(Ap - Ap.T).max() / abs(Ap).max():.1e}), padding ratio "
        f"{qp.A.nslots / Ap.nnz:.4f}; host setup {t_host + t_create:.3f} s "
        f"(build {t_host:.3f} s incl. RCM, QP.create {t_create:.3f} s)")

    # the power method's products, counted on their own
    sell_mv.launches = 0
    max_eigenvalue(qp.A, v0=torch.ones(qp.n, dtype=torch.float64, device=dev))
    n_eig = sell_mv.launches

    pt.solve(qp, tol=pt.Tolerances(rtol=1e-6, atol=1e-8, max_it=20))  # warm up
    gather_apply.launches = sell_mv.launches = 0  # count the main path's launches only
    res, t_solve = timed_solve(qp)
    launches = sell_mv.launches
    peak = torch.cuda.max_memory_allocated()
    log(f"[qp] f64 solve: reason {res.reason}, iterations/nmv/ncg/nexp/nprop {qp_counts(res)}, "
        f"{t_solve:.3f} s, {1e3 * t_solve / max(res.iterations, 1):.4f} ms per iteration, "
        f"sell_mv launches {launches} (= nmv {res.nmv} + power method {n_eig}), peak device "
        f"memory {peak / 2**30:.3f} GiB")
    if res.reason != 2:
        raise AssertionError(f"QP main path: reason {res.reason}, not CONVERGED_RTOL")
    if launches <= 0 or launches != res.nmv + n_eig:
        raise AssertionError(f"sell_mv launches {launches} != nmv {res.nmv} + {n_eig}")
    x = res.x.cpu().numpy()
    if not ((x >= lbp).all() and (x <= ubp).all()):
        raise AssertionError("QP main path: the iterate left the box")
    ttol = max(tol.rtol * np.linalg.norm(bp), tol.atol)
    gp = host_projected_gradient(Ap, bp, lbp, ubp, x, qp.box.astol)
    # slack 2: the solver's gradient is a recurrence (g -= a Ap) over
    # thousands of steps, the host recomputes A x - b from x
    log(f"[qp] KKT on the host (scipy f64): ||gP|| {gp:.3e} (solver {res.rnorm:.3e}), "
        f"tolerance {ttol:.3e}, slack 2; active at lb {int((x == lbp).sum())}, at ub "
        f"{int((x == ubp).sum())}")
    if not gp <= 2 * ttol:
        raise AssertionError(f"QP main path: host ||gP|| {gp} > 2 * {ttol}")

    # the same solve through the plain version: equal counts, bitwise equal x
    plain_A = qp.A.replace(kernel=False, t_plan=None if qp.A.t_plan is None
                           else qp.A.t_plan.replace(kernel=False))
    res_p, t_plain = timed_solve(qp.replace(A=plain_A))
    if sell_mv.launches != launches:
        raise AssertionError("SEll(kernel=False) launched the kernel")
    if qp_counts(res_p) != qp_counts(res) or not torch.equal(res_p.x, res.x):
        raise AssertionError(f"kernel and plain solves differ: {qp_counts(res)} vs "
                             f"{qp_counts(res_p)}")
    log(f"[qp] SEll(kernel=False): same counts, bitwise equal x; {t_plain:.3f} s, "
        f"{1e3 * t_plain / max(res_p.iterations, 1):.4f} ms per iteration")

    # the unpermuted problem through Dia.  Both solves stop at
    # ||gP|| <= 1e-6 ||b||; the error of each is that residual amplified by
    # up to 1/lambda_min(A) (~1e4 here), so the iterates agree to ~1e-6
    # relative, not to round-off; 1e-4 leaves room for that estimate
    qd = pt.QP.create(A, rhs, lb=lb, ub=ub)
    if not isinstance(qd.A, Dia):
        raise AssertionError(f"unpermuted jbearing went to {type(qd.A).__name__}")
    res_d, t_dia = timed_solve(qd)
    rel = float(np.linalg.norm(res_d.x.cpu().numpy()[perm] - x) / np.linalg.norm(x))
    log(f"[qp] unpermuted through Dia: reason {res_d.reason}, counts {qp_counts(res_d)}, "
        f"{t_dia:.3f} s; |x_dia[perm] - x_sell| / |x_sell| = {rel:.3e} (limit 1e-4)")
    if res_d.reason != 2 or not rel <= 1e-4:
        raise AssertionError(f"Dia run disagrees: reason {res_d.reason}, rel {rel}")

    # once more in 'mixed' (f32 operator and iterates, f64 dots): reported
    res_m, t_mixed = timed_solve(qp.with_precision("mixed"))
    xm = res_m.x.double().cpu().numpy()
    log(f"[qp] mixed: reason {res_m.reason}, counts {qp_counts(res_m)} (f64: {qp_counts(res)}), "
        f"{t_mixed:.3f} s, {1e3 * t_mixed / max(res_m.iterations, 1):.4f} ms per iteration; "
        f"host ||gP|| {host_projected_gradient(Ap, bp, lbp, ubp, xm, qp.box.astol):.3e}, "
        f"|x_mixed - x_f64| / |x_f64| = {np.linalg.norm(xm - x) / np.linalg.norm(x):.3e}")

    # where an iteration's time goes: device time of a profiled window
    from torch.profiler import ProfilerActivity, profile

    n_prof = 200
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        n_prof = pt.solve(qp, tol=pt.Tolerances(rtol=1e-6, atol=1e-8,
                                                max_it=n_prof)).iterations
        torch.cuda.synchronize()
    # kernel events only: an operator's event repeats its kernels' device time
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3
    if dev_ms <= 0:
        log("[qp] profile: no device time reported; idle share not measured")
    else:
        per_it = dev_ms / n_prof
        log(f"[qp] profile of {n_prof} iterations: device time {per_it:.4f} ms per iteration "
            f"against {1e3 * t_solve / res.iterations:.4f} ms wall (unprofiled): device idle "
            f"share {1 - per_it / (1e3 * t_solve / res.iterations):.3f}")
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
            log(f"[qp] profile   {e.self_device_time_total / 1e3 / n_prof:.4f} ms/it "
                f"x{e.count / n_prof:.1f}  {e.key[:90]}")
    return launches, res, t_solve


def eigs_near_zero(A, k=1, bf16=False):
    """The k eigenvalues of the symmetric sparse A nearest 0, ascending, by
    scipy's shift-invert Lanczos in f64.  With ``bf16`` A's values are
    first rounded to bf16 as 'bf16_mixed' stores them (round to nearest
    even, straight from f64) and widened back exactly."""
    import numpy as np
    import torch
    from scipy.sparse.linalg import eigsh

    A = A.tocsc(copy=True)
    if bf16:
        A.data = torch.from_numpy(A.data).to(torch.bfloat16).double().numpy()
    return np.sort(eigsh(A, k=k, sigma=0, which="LM", return_eigenvectors=False))


def check_tao(tag, r, t, launched, want_launches, problem, x_ref, tol):
    """Gates of a TAO-analog solve on a journal-bearing problem: reason 2,
    every product on the SpMV kernel, ||gP|| of its x recomputed on the
    host (scipy f64) within 10 max(rtol ||b||, atol), and x within
    (||gP|| + ||gP_ref||) / lambda_min(A) of the MPRGP solution x_ref."""
    import numpy as np

    A, b, lb, ub = problem
    lim = 10.0 * max(tol.rtol * np.linalg.norm(b), tol.atol)
    x = r.x.cpu().numpy()
    gp = host_projected_gradient(A, b, lb, ub, x, 0.0)
    gp_ref = host_projected_gradient(A, b, lb, ub, x_ref, 0.0)
    lam_min = float(eigs_near_zero(A)[0])
    bound = (gp + gp_ref) / lam_min
    dx = float(np.linalg.norm(x - x_ref))
    extra = (f", CG steps {r.ksp_its}, PG steps {r.pg_its}" if r.ksp_its else "")
    log(f"[qp11] {tag}: reason {r.reason}, iterations {r.iterations}, products {r.nmv}{extra}, "
        f"{t:.3f} s ({1e3 * t / max(r.nmv, 1):.4f} ms per product), sell_mv launches "
        f"{launched}; host ||gP|| {gp:.3e} (limit {lim:.3e}); |x - x_MPRGP| {dx:.3e} (the "
        f"oracles' limit {lim:.3e}; (||gP|| + ||gP_MPRGP|| {gp_ref:.3e}) / lambda_min "
        f"{lam_min:.3e} = {bound:.3e})")
    if r.reason != 2 or launched != want_launches or not gp <= lim or not dx <= bound:
        raise AssertionError(f"{tag}: reason {r.reason}, launches {launched} (want "
                             f"{want_launches}), gP {gp}, dx {dx}")


def phase_qp_rest(jb_rcm, res64, t64, dev):
    """11: the rest of the general QP path through the normal entries:
    (a) 'bf16_mixed' on the main path's problem, on the kernel's (bf16,
    f32) pair; (b) the TAO analog, GPCG on the same problem and L-BFGS-B
    on a smaller grid, held to the QP solution; (c) the dense inequality
    branch: tutorial ex3 through dualize (K+ by make_inv on the card) and
    PCPG on the same Hessian with equality rows.  Returns the sell_mv
    launches."""
    import numpy as np
    import torch

    import permon_tpu_torch as pt
    from permon_tpu_torch.core.eig import max_eigenvalue
    from permon_tpu_torch.core.sell import SEll, sell_mv
    from permon_tpu_torch.problems import build_jbearing, rcm_permuted
    from permon_tpu_torch.solvers.tao import blmvm

    Ap, bp, lbp, ubp, _ = jb_rcm
    tol = pt.Tolerances(rtol=1e-6, atol=1e-8)
    x64 = res64.x.cpu().numpy()

    launches = 0
    # (a) 'bf16_mixed': the Hessian in bf16 behind CastTo(float32), f32
    # vectors, f64 dots
    qp = pt.QP.create(Ap, bp, lb=lbp, ub=ubp).with_precision("bf16_mixed")
    inner = qp.A.inner
    if not isinstance(inner, SEll) or inner.vals.dtype != torch.bfloat16 \
            or inner.vals.device != qp.b.device or qp.b.dtype != torch.float32:
        raise AssertionError(f"bf16_mixed gave {type(inner).__name__} "
                             f"{getattr(inner, 'vals', qp.b).dtype} on {qp.b.device}")
    # MPRGP must converge where the stored (bf16-rounded) Hessian is
    # positive definite; where the rounding has made it indefinite, the
    # quadratic has no minimum over the box's free directions
    lam_64, lam_16 = eigs_near_zero(Ap, k=4), eigs_near_zero(Ap, k=4, bf16=True)
    sell_mv.launches = 0
    max_eigenvalue(qp.A, v0=torch.ones(qp.n, dtype=torch.float32, device=dev))
    n_eig = sell_mv.launches
    sell_mv.launches = 0
    res, t_b = timed_call(lambda: pt.solve(qp, tol=tol))
    n_a = sell_mv.launches
    if n_a != res.nmv + n_eig:
        raise AssertionError(f"bf16_mixed: sell_mv launches {n_a} != nmv {res.nmv} + {n_eig}")
    plain = qp.replace(A=qp.A.replace(inner=inner.replace(kernel=False)))
    res_p, t_p = timed_call(lambda: pt.solve(plain, tol=tol))
    if sell_mv.launches != n_a or qp_counts(res_p) != qp_counts(res) \
            or not torch.equal(res_p.x, res.x):
        raise AssertionError(f"bf16_mixed kernel and plain solves differ: {qp_counts(res)} vs "
                             f"{qp_counts(res_p)}")
    launches += n_a
    xb = res.x.double().cpu().numpy()
    log(f"[qp11] 11a bf16_mixed on {JBEARING} RCM: reason {res.reason}, counts {qp_counts(res)} "
        f"(f64: {qp_counts(res64)}), {t_b:.3f} s with its power method and first-call setup; "
        f"sell_mv (bf16, f32) launches {n_a} = nmv + power method {n_eig}; "
        f"SEll(kernel=False): same counts, bitwise equal x, {t_p:.3f} s; host ||gP|| "
        f"{host_projected_gradient(Ap, bp, lbp, ubp, xb, 0.0):.3e} (f64 tolerance "
        f"{max(tol.rtol * np.linalg.norm(bp), tol.atol):.3e}); |x_bf16 - x_f64| / |x_f64| = "
        f"{np.linalg.norm(xb - x64) / np.linalg.norm(x64):.3e}; eigenvalues nearest 0 (scipy "
        f"f64) of the bf16-rounded Hessian {', '.join(f'{v:.3e}' for v in lam_16)}, of the f64 "
        f"one {', '.join(f'{v:.3e}' for v in lam_64)}")
    if lam_16[0] > 0 and res.reason != 2:
        raise AssertionError(f"bf16_mixed: reason {res.reason} on a positive definite bf16 "
                             f"Hessian (eigenvalues nearest 0: {lam_16})")

    # (b) the TAO analog in f64: GPCG on the main path's problem.  Each
    # solution is held to its KKT on the host, 10 max(rtol ||b||, atol) as
    # the jbearing2 oracles do; two solutions that stop at ||gP|| <= g_a and
    # g_b can stand (g_a + g_b) / lambda_min(A) apart, which on this grid is
    # far more than that limit (the oracles' grids are 8x12 to 30x30)
    q64 = pt.QP.create(Ap, bp, lb=lbp, ub=ubp)
    sell_mv.launches = 0
    rg, t_g = timed_call(lambda: pt.solve(q64, qps_type="tao", tol=tol))
    n_g = sell_mv.launches
    launches += n_g
    check_tao("11b GPCG", rg, t_g, n_g, rg.nmv + 1, (Ap, bp, lbp, ubp), x64, tol)
    # 'bf16_mixed' against f64 MPRGP where the bf16 Hessian is positive
    # definite: both solves warm, each with its power method
    jb_s = rcm_permuted(*build_jbearing(*BF16_JBEARING))[:4]
    qs = pt.QP.create(*jb_s[:2], lb=jb_s[2], ub=jb_s[3])
    qsf = qs.with_precision("bf16_mixed")
    warm = pt.Tolerances(rtol=1e-6, atol=1e-8, max_it=20)
    pt.solve(qs, tol=warm), pt.solve(qsf, tol=warm)  # first-call setup, untimed
    rs, t_s = timed_call(lambda: pt.solve(qs, tol=tol))
    rbf, t_f = timed_call(lambda: pt.solve(qsf, tol=tol))
    rel = torch.linalg.vector_norm(rbf.x.double() - rs.x) / torch.linalg.vector_norm(rs.x)
    lam_s = eigs_near_zero(jb_s[0], bf16=True)[0]
    log(f"[qp11] 11b on {BF16_JBEARING} RCM ({qs.n} unknowns), MPRGP f64: {qp_counts(rs)}, "
        f"{t_s:.3f} s, {1e3 * t_s / max(rs.iterations, 1):.4f} ms per iteration; "
        f"'bf16_mixed' (bf16 lambda_min {lam_s:.3e}): reason {rbf.reason}, {qp_counts(rbf)}, "
        f"{t_f:.3f} s, {1e3 * t_f / max(rbf.iterations, 1):.4f} ms per iteration, "
        f"|x_bf16 - x| / |x| {float(rel):.3e}")
    if lam_s > 0 and rbf.reason != 2:
        raise AssertionError(f"bf16_mixed on {BF16_JBEARING}: reason {rbf.reason}")
    # L-BFGS-B keeps its iterate on the host: one product each way per
    # evaluation (BLMVM_JBEARING says why this grid)
    jb_b = rcm_permuted(*build_jbearing(*BLMVM_JBEARING))[:4]
    qb = pt.QP.create(*jb_b[:2], lb=jb_b[2], ub=jb_b[3])
    ref, t_r = timed_call(lambda: pt.solve(qb, tol=tol))
    log(f"[qp11] 11b on {BLMVM_JBEARING} RCM ({qb.n} unknowns), MPRGP f64: reason {ref.reason}, "
        f"{qp_counts(ref)}, {t_r:.3f} s")
    sell_mv.launches = 0
    rb, t_l = timed_call(lambda: blmvm(qb, tol=tol))
    n_l = sell_mv.launches
    launches += n_l
    check_tao("11b L-BFGS-B", rb, t_l, n_l, rb.nmv, jb_b, ref.x.cpu().numpy(), tol)

    phase_ex3(EX3_N, dev)
    return launches


def phase_ex3(n, dev):
    """11c: the dense inequality branch at n unknowns: tutorial ex3 ->
    dualize (K+ by make_inv on the card) -> MPRGP -> post, and PCPG on the
    same Hessian with equality rows."""
    import numpy as np
    import torch

    import permon_tpu_torch as pt
    from permon_tpu_torch.core.factor import CholInv, make_inv
    from permon_tpu_torch.problems import build_ex3
    from permon_tpu_torch.qp.transforms import Solution, dualize

    A, b, BI, cI = build_ex3(n)
    obst = -cI
    (qp3, dual, post), t_set = timed_call(lambda: (lambda q: (q, *dualize(q)))(
        pt.QP.create(A, b, BI=BI, cI=cI)))
    kplus = dual.A.ops[1]
    if not isinstance(kplus, CholInv) or kplus.chol.device != dual.b.device:
        raise AssertionError(f"dualize built {type(kplus).__name__} on the host")
    tol3 = pt.Tolerances(rtol=1e-12)
    r3, t3 = timed_call(lambda: pt.solve(dual, tol=tol3))
    sol = post(Solution(x=r3.x, g=r3.g))
    x, lam = sol.x.cpu().numpy(), sol.lambda_I.cpu().numpy()
    viol = float((obst - x).max())
    stat = float(np.linalg.norm(A @ x - b - lam) / np.linalg.norm(b))
    comp = float(abs(lam @ (x - obst)) / (np.linalg.norm(lam) * np.linalg.norm(obst)))
    log(f"[qp11] 11c ex3 at n = {n}: QP.create + dualize (dense Cholesky K+ of "
        f"{n}^2 on the card) {t_set:.3f} s; dual MPRGP at rtol 1e-12: reason {r3.reason}, "
        f"counts {qp_counts(r3)}, {t3:.3f} s, {1e3 * t3 / max(r3.nmv, 1):.3f} ms per product; "
        f"primal on the host (scipy f64): max(obst - x) {viol:.3e} (limit "
        f"{1e-10 * np.abs(obst).max():.3e}), ||A x - b - lambda|| / ||b|| {stat:.3e} (limit "
        f"1e-6), min lambda {lam.min():.3e}, |lambda'(x - obst)| / (|lambda| |obst|) {comp:.3e} "
        f"(limit 1e-6)")
    if r3.reason != 2 or not viol <= 1e-10 * np.abs(obst).max() or not stat <= 1e-6 \
            or lam.min() < 0 or not comp <= 1e-6:
        raise AssertionError(f"ex3: reason {r3.reason}, viol {viol}, stat {stat}, comp {comp}")
    del qp3, dual, post, kplus
    # PCPG on the same Hessian with 8 dense equality rows and cE != 0,
    # preconditioned by the dense Cholesky inverse of A (make_inv)
    rng = np.random.RandomState(11)
    BE, cE = rng.standard_normal((8, n)), rng.standard_normal(8)
    qe = pt.QP.create(A, b, BE=BE, cE=cE)
    M = make_inv(qe.A)
    re, te = timed_call(lambda: pt.solve(qe, qps_type="pcpg", precond=M.mv))
    feas = float(np.linalg.norm(BE @ re.x.cpu().numpy() - cE) / np.linalg.norm(cE))
    log(f"[qp11] 11c PCPG at n = {n}, 8 equality rows, cE != 0, M = make_inv(A): reason "
        f"{re.reason}, iterations {re.iterations}, {te:.3f} s; |BE x - cE| / |cE| {feas:.3e} "
        f"(limit 1e-10)")
    if re.reason <= 0 or not feas <= 1e-10:
        raise AssertionError(f"PCPG: reason {re.reason}, |BE x - cE| / |cE| {feas}")


def phase_blmvm_grids(grids, dev):
    """Development (``--only=11l --blmvm-grids=96,128,192``): L-BFGS-B on
    each jbearing grid, timed three ways in this process: ``blmvm`` (the
    product on the card, the iterate on the host); scipy's L-BFGS-B with
    blmvm's options and the product on the host (scipy CSR), which is
    scipy's own cost; and the port's product with its two copies, alone.
    Stops after a grid whose blmvm run took over 60 s."""
    import numpy as np
    import scipy
    import torch
    from scipy.optimize import minimize

    import permon_tpu_torch as pt
    from permon_tpu_torch.problems import build_jbearing, rcm_permuted
    from permon_tpu_torch.solvers.tao import blmvm

    env = {k: os.environ.get(k) for k in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS")}
    try:
        from threadpoolctl import threadpool_info
        pools = [(p["internal_api"], p["num_threads"]) for p in threadpool_info()]
    except ImportError:
        pools = "not read (no threadpoolctl)"
    log(f"[qp11l] scipy {scipy.__version__}, numpy {np.__version__}, {os.cpu_count()} cores, "
        f"torch threads {torch.get_num_threads()}, {env}, BLAS thread pools {pools}")
    tol = pt.Tolerances(rtol=1e-6, atol=1e-8)
    for g in grids:
        A, b, lb, ub = rcm_permuted(*build_jbearing(g, g))[:4]
        qp = pt.QP.create(A, b, lb=lb, ub=ub)
        rb, t_b = timed_call(lambda: blmvm(qp, tol=tol))

        def fg(x):
            Ax = A @ x
            return 0.5 * x @ Ax - b @ x, Ax - b

        ttol = max(tol.rtol * np.linalg.norm(b), tol.atol)
        t0 = time.perf_counter()
        rs = minimize(fg, np.clip(np.zeros_like(b), lb, ub), jac=True, method="L-BFGS-B",
                      bounds=list(zip(lb, ub)), options={
                          "maxiter": tol.max_it, "gtol": ttol / np.sqrt(b.shape[0]), "ftol": 0.0})
        t_s = time.perf_counter() - t0
        x = np.random.RandomState(0).rand(b.shape[0])

        def product():
            return qp.A.mv(torch.as_tensor(x, device=dev)).double().cpu().numpy()

        product()
        t0 = time.perf_counter()
        for _ in range(200):
            product()
        t_p = (time.perf_counter() - t0) / 200
        log(f"[qp11l] {g}x{g} ({b.shape[0]} unknowns): blmvm reason {rb.reason}, "
            f"{rb.iterations} iterations, {rb.nmv} products, {t_b:.3f} s "
            f"({1e3 * t_b / max(rb.nmv, 1):.4f} ms per product); scipy alone (host product) "
            f"{rs.nit} iterations, {rs.nfev} evaluations, {t_s:.3f} s "
            f"({1e3 * t_s / max(rs.nfev, 1):.4f} ms each); the port's product with its copies "
            f"{1e3 * t_p:.4f} ms")
        if t_b > 60:
            log(f"[qp11l] {g}x{g} took over 60 s: the sweep stops")
            break


def phase_qp_only(dev):
    """Phase 7 alone, for ``--only=11``: (jb_rcm, its f64 result, seconds)."""
    from permon_tpu_torch.problems import build_jbearing, rcm_permuted

    t0 = time.perf_counter()
    jb = build_jbearing(*JBEARING)
    jb_rcm = rcm_permuted(*jb)
    _, res64, t64 = phase_qp(jb, jb_rcm, time.perf_counter() - t0, dev)
    return jb_rcm, res64, t64, dev


# -------------------------------------------------------------- phase 14

#: phase 14b's problem: the north star on the (2, 2) mesh (TWIN if 14a-d
#: together pass ~150 s; PERF.md says which was run)
REDUNDANCY_PROBLEM = NORTH_STAR
#: 14b's x_global with redundancy groups against the same mesh's run with
#: the coarse factor replicated, and against 14a's (K+ in calls of 32),
#: relative to max |x|: about ten times the readings (7.1e-12 and 8.3e-11;
#: PERF.md, Findings)
X_14B_RED = 1e-10
X_14B_14A = 1e-9
#: 13a's count, which 14c must reach over ranks (PERF.md)
LEAF_ITS = 23
#: seconds a run of ranks may take before it is killed
RANKS_TIMEOUT_S = 300
#: what a run of ranks writes: one .npz per rank (listed in .gitignore)
RANKS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "phase14")


def run_ranks(tag, nproc):
    """Run ``nproc`` ranks of this script's worker ``tag`` on the card
    (``python -m torch.distributed.run --standalone``), relay their log
    lines, and return each rank's saved arrays.  The whole process group of
    the launcher is killed on a timeout; a rank that fails fails the run."""
    import signal
    import shutil

    import numpy as np

    out = os.path.join(RANKS_DIR, tag)
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={nproc}", os.path.abspath(__file__), f"--rank-worker={tag}",
           f"--out={out}"]
    env = dict(os.environ, OMP_NUM_THREADS=str(max(1, (os.cpu_count() or 8) // nproc)))
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, start_new_session=True)
    try:
        text, _ = proc.communicate(timeout=RANKS_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        text, _ = proc.communicate()
        log(text[-6000:])
        raise AssertionError(f"{tag}: the ranks passed {RANKS_TIMEOUT_S} s and were killed")
    for line in text.splitlines():
        if line.startswith(f"[{tag}"):
            log(line)
    if proc.returncode != 0:
        log(text[-8000:])
        raise AssertionError(f"{tag}: the ranks exited with {proc.returncode}")
    log(f"[{tag}] {nproc} ranks ran in {time.perf_counter() - t0:.1f} s (launch included)")
    return [dict(np.load(os.path.join(out, f"rank{r}.npz"))) for r in range(nproc)]


def _same(ranks, key):
    """The value of ``key``, which every rank must hold bitwise equal."""
    import numpy as np

    for r in ranks[1:]:
        if not np.array_equal(r[key], ranks[0][key]):
            raise AssertionError(f"ranks disagree on {key}")
    return ranks[0][key]


def _rank_lines(tag, ranks):
    for r in ranks:
        log(f"[{tag}] rank {int(r['rank'])}: backend {r['backend']}, staged "
            f"({r['staged']}), peak device memory {float(r['peak']) / 2**30:.3f} GiB, "
            f"gather_apply launches {int(r['launches'])}")


def blocked_kplus(kp, block):
    """The band K+ ``kp`` applied ``block`` subdomains at a time, each block
    through its own ``shard_band``: on one device, the batched GEMV calls
    that the ranks of a mesh make (cuBLAS picks its batched GEMV by the
    batch count, so the apply rounds by the subdomains a call covers; 14k
    shows it).  Only phase 14's one-device references use it."""
    import dataclasses

    import torch

    from permon_tpu_torch.core.linop import LinearOperator
    from permon_tpu_torch.parallel.dist import shard_band

    @dataclasses.dataclass
    class BlockedKplus(LinearOperator):
        shape: tuple
        parts: tuple

        def mv(self, x):
            n = self.parts[0].shape[0]
            return torch.cat([p.mv(x[i * n:(i + 1) * n]) for i, p in enumerate(self.parts)])

        rmv = mv

    ns = kp.Dinv.shape[1]
    return BlockedKplus(shape=kp.shape, parts=tuple(
        shard_band(kp, lo, lo + block) for lo in range(0, ns, block)))


def sparse_main_path(mesh, dev, cells_grid, redundancy=False, block=None):
    """The main path over ranks (or one device): FetiSolverSparse with
    phase 6's recipe on ``cells_grid``, a first solve and two warm
    re-solves; ``block``: K+ applied that many subdomains a call
    (:func:`blocked_kplus`, a one-device run that makes the ranks' calls)."""
    import torch

    from permon_tpu_torch.core.convergence import Tolerances
    from permon_tpu_torch.core.sell import gather_apply
    from permon_tpu_torch.feti.large import FetiSolverSparse
    from permon_tpu_torch.feti.solve import FetiOptions
    from permon_tpu_torch.problems import build_sparse

    prob = build_sparse(*cells_grid)
    tol = Tolerances(rtol=1e-5)
    torch.cuda.reset_peak_memory_stats(dev)
    gather_apply.launches = 0  # the main path's launches only
    opts = FetiOptions(gluing="nonred", deterministic=True, coarse="sparse", mesh=mesh,
                       qppf_redundancy=redundancy)
    solver, t_setup = timed_call(lambda: FetiSolverSparse(
        prob, opts, kplus_dtype=torch.float32, kplus_refine=2, primal_refine=1, device=dev))
    if block is not None:
        post = blocked_kplus(solver.kplus_post, block)  # the factors shared, as in the solver
        solver.kplus_post = post
        solver.kplus = post.replace(parts=tuple(p.replace(refine=0) for p in post.parts))
    r1, t1 = timed_call(lambda: solver.solve(tol=tol))
    r2, t2 = timed_call(lambda: solver.solve(b_loc=1.5 * prob.b_loc, tol=tol))
    r3, t3 = timed_call(lambda: solver.solve(b_loc=0.5 * prob.b_loc, tol=tol))
    out = dict(launches=gather_apply.launches, peak=torch.cuda.max_memory_allocated(dev),
               its1=[r.iterations for r in r1.results], its2=[r.iterations for r in r2.results],
               its3=[r.iterations for r in r3.results],
               reasons=[r.reason for r in r1.results + r2.results + r3.results],
               x1=r1.x_global, x2=r2.x_global, t_setup=t_setup, t_first=t1, t_warm=[t2, t3],
               host_setup=solver.timings["host_setup_s"], factor=solver.timings["factor_s"],
               ns_loc=solver.qp.A.ns, m=solver.qp.BE.shape[0])
    return solver, out


def worker_14a(mesh, dev):
    import numpy as np
    import torch

    from permon_tpu_torch.core.sell import gather_apply, _table_plain
    from permon_tpu_torch.parallel.dist import all_reduce_sum

    solver, out = sparse_main_path(mesh, dev, NORTH_STAR)
    qp = solver.qp
    # one F apply's all_reduce: the m-vector of f64, 20 times after 3 warm-ups
    v = torch.as_tensor(np.random.RandomState(14).standard_normal(out["m"]), device=dev)
    times = []
    for i in range(23):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        all_reduce_sum(v, mesh)
        torch.cuda.synchronize(dev)
        if i >= 3:
            times.append(1e3 * (time.perf_counter() - t0))
    # the rank's tables through the kernel against the plain version
    rng = np.random.RandomState(mesh.rank)
    xp = torch.as_tensor(rng.standard_normal(qp.BE.shape[1]), device=dev)
    xd = torch.as_tensor(rng.standard_normal(qp.BE.shape[0]), device=dev)
    copies = solver._tables.copies  # over the gathered blocks of every rank
    xc = torch.as_tensor(rng.standard_normal(copies.n_src), device=dev)
    eq = [torch.equal(gather_apply(t, x), _table_plain(t, x)) for t, x in (
        (qp.BE.gB, xp), (qp.BE.gBt, xd), (copies, xc))]
    out.update(allreduce_ms=sorted(times)[len(times) // 2], tables_equal=eq)
    return out


def worker_14b(mesh, dev):
    import numpy as np
    import scipy.linalg
    import torch

    from permon_tpu_torch.qp.transforms import _sparse_coarse

    # the same mesh with the coarse factor replicated: what redundancy moves
    solver, plain = sparse_main_path(mesh, dev, REDUNDANCY_PROBLEM)
    del solver
    torch.cuda.empty_cache()
    solver, out = sparse_main_path(mesh, dev, REDUNDANCY_PROBLEM, redundancy=True)
    out.update({f"plain_{k}": plain[k] for k in ("its1", "its2", "reasons", "x1", "launches")})
    cp = solver._pf.cp_dist
    _, gram = _sparse_coarse(solver.qp.R, solver.qp.BE)
    v = np.random.RandomState(14).standard_normal(cp.kc)
    got = cp.mv(torch.as_tensor(v, device=dev)).cpu().numpy()
    ref = scipy.linalg.cho_solve(scipy.linalg.cho_factor(gram.toarray()), v)
    out.update(cp_err=np.abs(got - ref).max() / np.abs(ref).max(), kc=cp.kc, kb=cp.kb)
    return out


def worker_14c(mesh, dev):
    import numpy as np
    import torch

    from permon_tpu_torch.core.convergence import Tolerances
    from permon_tpu_torch.core.sell import gather_apply
    from permon_tpu_torch.feti.leaf import LeafDualOperator
    from permon_tpu_torch.feti.solve import FetiOptions, FetiSolver
    from permon_tpu_torch.problems import build_ex71

    prob = build_ex71(*DENSE_POISSON)
    tol = Tolerances(rtol=1e-5)
    torch.cuda.reset_peak_memory_stats(dev)
    gather_apply.launches = 0
    solver, t_setup = timed_call(lambda: FetiSolver(
        prob, FetiOptions(throughput=True, mesh=mesh), device=dev))
    r1, t1 = timed_call(lambda: solver.solve(tol=tol))
    rw, t2 = timed_call(lambda: solver.solve(b_loc=1.5 * prob.b_loc, tol=tol))
    out = dict(launches=gather_apply.launches, peak=torch.cuda.max_memory_allocated(dev),
               its=r1.result.iterations, its_warm=rw.result.iterations,
               reasons=[r1.result.reason, rw.result.reason], x1=r1.x_global,
               t_setup=t_setup, t_first=t1, t_warm=t2)
    ovl = solver._leaf["leaf"].A.op
    flat = LeafDualOperator(blk=solver._leaf["B_full"].blk, invs=solver.kplus.invs,
                            space=ovl.space)
    Lam = ovl.space.lift(torch.as_tensor(np.random.RandomState(14).standard_normal(
        ovl.space.m_dual), device=dev))
    y_o, y_f = ovl.apply(Lam), flat.apply(Lam)
    out.update(apply_err=float((y_o - y_f).abs().max() / y_f.abs().max()),
               apply_ms=cuda_ms(lambda: ovl.apply(Lam), reps=5, warmup=1),
               offsets=len(ovl.plan.offsets), nb=ovl.plan.nb, ns_loc=ovl.plan.ns_loc)
    return out


def worker_14d(mesh, dev):
    import numpy as np
    import torch

    from permon_tpu_torch.core.convergence import Tolerances
    from permon_tpu_torch.core.sell import gather_apply
    from permon_tpu_torch.feti.large import feti_solve_sparse
    from permon_tpu_torch.feti.solve import FetiOptions
    from permon_tpu_torch.problems import assembled_system, build_sparse

    cells, grid = TWIN
    torch.cuda.reset_peak_memory_stats(dev)
    gather_apply.launches = 0
    res = feti_solve_sparse(build_sparse(cells, grid), FetiOptions(gluing="nonred", mesh=mesh),
                            tol=Tolerances(rtol=1e-5), kplus_dtype=torch.float32,
                            kplus_refine=2, primal_refine=1, device=dev)
    A, b = assembled_system(cells)
    return dict(launches=gather_apply.launches, peak=torch.cuda.max_memory_allocated(dev),
                its=[r.iterations for r in res.results], reason=res.result.reason,
                resid=np.linalg.norm(A @ res.x_global - b) / np.linalg.norm(b))


def phase_kplus_batches(dev):
    """14k (``--only=14k``, no part of the default run): why phase 14's
    one-device references apply K+ in the ranks' blocks.  On the north
    star's factors (f32 and f64): the factors of a block of subdomains made
    alone against the same block of the one-call factorization, and a
    block's apply against the same subdomains of the one-call apply,
    bitwise; the apply's time by the subdomains a call covers."""
    import numpy as np
    import torch

    from permon_tpu_torch.core.band import BandCholInv
    from permon_tpu_torch.feti.large import assemble_qp_sparse
    from permon_tpu_torch.feti.solve import FetiOptions
    from permon_tpu_torch.parallel.dist import shard_band
    from permon_tpu_torch.problems import build_sparse

    prob = build_sparse(*NORTH_STAR)
    for dt in (torch.float32, torch.float64):
        qp, kp, NB, _ = assemble_qp_sparse(prob, FetiOptions(gluing="nonred"), kplus_dtype=dt,
                                           kplus_refine=2, device=dev)
        kp = kp.replace(refine=0)
        ns, nlp = qp.A.ns, qp.A.nlp
        x = torch.as_tensor(np.random.RandomState(0).standard_normal(ns * nlp), device=dev)
        y = kp.mv(x)
        for lo, hi in ((0, ns // 2), (ns // 2, ns), (ns // 4, ns // 2)):
            part = shard_band(kp, lo, hi)
            alone = BandCholInv.from_blockdia(part.op, NB, dtype=dt)
            ys = part.mv(x[lo * nlp:hi * nlp])
            log(f"[14k] {dt} subdomains [{lo}, {hi}): factors alone bitwise "
                f"{torch.equal(alone.Dinv, part.Dinv) and torch.equal(alone.F, part.F)}; "
                f"apply in one call of {hi - lo} against the one call of {ns}: bitwise "
                f"{torch.equal(ys, y[lo * nlp:hi * nlp])}, max abs diff "
                f"{float((ys - y[lo * nlp:hi * nlp]).abs().max()):.3e}")
        t = {b: cuda_ms(lambda: (kp if b == ns else blocked_kplus(kp, b)).mv(x), reps=10)
             for b in (ns, ns // 2, ns // 4)}
        log(f"[14k] {dt} K+ apply: {t[ns]:.3f} ms in calls of {ns}, {t[ns // 2]:.3f} of "
            f"{ns // 2}, {t[ns // 4]:.3f} of {ns // 4}")


def rank_worker(tag, out_dir):
    """One rank of phase 14's run ``tag`` (started by :func:`run_ranks`):
    14a-c on gloo, several ranks time-sharing the one card ('duplicate
    GPU': NCCL takes one rank per card), 14d on NCCL with one rank."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from permon_tpu_torch.parallel import make_mesh, make_mesh2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]) % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    if tag != "14d":
        dist.init_process_group("cuda:gloo,cpu:gloo")
    mesh = make_mesh2((2, 2), device=dev) if tag == "14b" else make_mesh(device=dev)
    out = {"14a": worker_14a, "14b": worker_14b, "14c": worker_14c, "14d": worker_14d}[tag](
        mesh, dev)
    out.update(rank=mesh.rank, backend=mesh.backend, staged=",".join(mesh.staged))
    np.savez(os.path.join(out_dir, f"rank{mesh.rank}.npz"),
             **{k: np.asarray(v) for k, v in out.items()})
    dist.barrier()
    dist.destroy_process_group()
    return 0


def phase_ranks(dev, main_ref=None, leaf_ref=None, twin_its=None):
    """14: the multi-device layer (permon_tpu_torch.parallel) with its ranks
    on the one card: (a) the north star sharded over 2 ranks, (b) on the
    (2, 2) mesh with the coarse factor on redundancy groups, (c) 12a's
    problem on the leaf path over 2 ranks with the overlapped exchange,
    (d) the twin on NCCL with one rank.  (a) and (b) are held against
    one-device runs made here whose K+ makes the ranks' calls (phase 14k
    says why), (a) compared with phase 6 (``main_ref``, when given); (c) and (d) are held
    against 13a and phase 5 (``leaf_ref``: run here when not given;
    ``twin_its``).  Returns the ranks' gather_apply launches."""
    import numpy as np
    import torch

    from permon_tpu_torch.problems import assembled_system

    def one_device(cells_grid, nranks):
        """The one-device run of 14a's options whose K+ makes the calls of
        one of ``nranks`` ranks (cuBLAS picks its batched GEMV by the
        batch count, so phase 6's 64-subdomain calls round otherwise)."""
        torch.cuda.empty_cache()
        solver, out = sparse_main_path(None, dev, cells_grid,
                                       block=int(np.prod(cells_grid[1])) // nranks)
        del solver
        torch.cuda.empty_cache()
        return dict(its1=[int(i) for i in out["its1"]], its2=[int(i) for i in out["its2"]],
                    x1=out["x1"], ms_per_it=1e3 * out["t_warm"][0] / sum(out["its2"]))

    ref = one_device(NORTH_STAR, 2)
    launches = 0

    # -- 14a: the north star over 2 ranks ------------------------------
    ranks = run_ranks("14a", 2)
    _rank_lines("14a", ranks)
    r0 = ranks[0]
    its1, its2, its3 = ([int(i) for i in _same(ranks, k)] for k in ("its1", "its2", "its3"))
    x1 = _same(ranks, "x1")
    A, b = assembled_system(NORTH_STAR[0])
    resid = np.linalg.norm(A @ x1 - b) / np.linalg.norm(b)
    dx = np.abs(x1 - ref["x1"]).max() / np.abs(ref["x1"]).max()
    t_warm = min(float(t) for t in r0["t_warm"])
    ms_it = 1e3 * float(r0["t_warm"][0]) / sum(its2)
    ar_ms = ", ".join(f"{float(r['allreduce_ms']):.3f}" for r in ranks)
    log(f"[14a] north star {NORTH_STAR[0]} on {NORTH_STAR[1]} over 2 ranks ({int(r0['ns_loc'])} "
        f"subdomains each): iterations {its1} / {its2} / {its3} (one device, K+ in the "
        f"ranks' batches: {ref['its1']} / {ref['its2']}), max |x - x_1dev| / max |x_1dev| "
        f"{dx:.3e}, assembled residual {resid:.3e}")
    if main_ref is not None:  # phase 6: one K+ call over all 64 subdomains
        d6 = np.abs(x1 - main_ref["x1"]).max() / np.abs(main_ref["x1"]).max()
        log(f"[14a] against phase 6 (K+ in one batch of 64): iterations {main_ref['its1']} / "
            f"{main_ref['its2']}, max |x - x_6| / max |x_6| {d6:.3e} (reported, not held)")
    log(f"[14a] host setup {float(r0['host_setup']):.3f} s, factorization "
        f"{float(r0['factor']):.3f} s, first solve {float(r0['t_first']):.3f} s, warm re-solves "
        f"{', '.join(f'{float(t):.3f}' for t in r0['t_warm'])} s; {ms_it:.3f} ms per dual "
        f"iteration (one device: {ref['ms_per_it']:.3f}); one F apply's all_reduce of "
        f"m = {int(r0['m'])} f64: {ar_ms} ms (median per rank); the two ranks time-share one "
        f"card: collective overhead and "
        f"correctness, not scaling")
    if not all(int(x) == 2 for x in _same(ranks, "reasons")):
        raise AssertionError("14a: a dual solve did not reach reason 2")
    if its1 != list(ref["its1"]) or its2 != list(ref["its2"]):
        raise AssertionError(f"14a: counts {its1} / {its2} against {ref['its1']} / "
                             f"{ref['its2']}")
    if not dx <= 1e-12 or not resid <= 1e-6:
        raise AssertionError(f"14a: x differs by {dx}, residual {resid}")
    if not all(r["tables_equal"].all() for r in ranks):
        raise AssertionError("14a: a rank's table differs from gather_apply_plain")
    log(f"[14a] each rank's B, B' and copy-sum tables through the kernel: bitwise equal to "
        f"gather_apply_plain; warm re-solve {t_warm:.3f} s")
    launches += sum(int(r["launches"]) for r in ranks)

    # -- 14b: redundancy groups on the (2, 2) mesh ---------------------
    # the ranks call K+ with 16 subdomains (14a: 32): the one-device run
    # that makes those calls holds the mesh's run with the coarse factor
    # replicated, and that run holds the one with redundancy groups
    refb = one_device(REDUNDANCY_PROBLEM, 4)
    ranks = run_ranks("14b", 4)
    _rank_lines("14b", ranks)
    pits1, pits2 = ([int(i) for i in _same(ranks, f"plain_{k}")] for k in ("its1", "its2"))
    its1b, its2b = ([int(i) for i in _same(ranks, k)] for k in ("its1", "its2"))
    err = max(float(r["cp_err"]) for r in ranks)
    xp, xb = _same(ranks, "plain_x1"), _same(ranks, "x1")
    A, b = assembled_system(REDUNDANCY_PROBLEM[0])
    residb = np.linalg.norm(A @ xb - b) / np.linalg.norm(b)
    dxp = np.abs(xp - refb["x1"]).max() / np.abs(refb["x1"]).max()
    dxr = np.abs(xb - xp).max() / np.abs(xp).max()
    log(f"[14b] {'north star' if REDUNDANCY_PROBLEM == NORTH_STAR else 'twin'} "
        f"{REDUNDANCY_PROBLEM[0]} on the (2, 2) mesh, coarse factor replicated: iterations "
        f"{pits1} / {pits2} (one device, K+ in the ranks' calls of 16: {refb['its1']} / "
        f"{refb['its2']}), max |x - x_1dev| / max |x_1dev| {dxp:.3e}")
    log(f"[14b] with qppf_redundancy: iterations {its1b} / {its2b}, max |x - x_replicated| / "
        f"max |x_replicated| {dxr:.3e}; RedundantCoarse (kc {int(ranks[0]['kc'])}, "
        f"{int(ranks[0]['kb'])} rows a rank) against cho_solve: max rel. error {err:.3e}; "
        f"assembled residual {residb:.3e}; warm re-solve {float(ranks[0]['t_warm'][0]):.3f} s")
    dxb = 0.0
    if REDUNDANCY_PROBLEM == NORTH_STAR:
        dxb = np.abs(xb - x1).max() / np.abs(x1).max()
        log(f"[14b] against 14a (K+ in calls of 32): iterations {its1} / {its2}, max |x - x_14a| "
            f"/ max |x_14a| {dxb:.3e}")
    if not all(int(x) == 2 for x in _same(ranks, "reasons")) or not all(
            int(x) == 2 for x in _same(ranks, "plain_reasons")) or not err <= 1e-12 \
            or not residb <= 1e-6:
        raise AssertionError(f"14b: reasons {_same(ranks, 'reasons')}, coarse error {err}, "
                             f"residual {residb}")
    if pits1 != refb["its1"] or pits2 != refb["its2"] or not dxp <= 1e-12:
        raise AssertionError(f"14b, coarse factor replicated: counts {pits1} / {pits2} against "
                             f"{refb['its1']} / {refb['its2']}, x {dxp} from the one-device run")
    # the redundancy groups' blocked substitution rounds otherwise than the
    # replicated cho_solve: the first solve and each first pass count alike,
    # a re-solve's defect pass within one (readings in PERF.md)
    if its1b != pits1 or its2b[0] != pits2[0] or abs(its2b[1] - pits2[1]) > 1 \
            or not dxr <= X_14B_RED or not dxb <= X_14B_14A:
        raise AssertionError(f"14b: counts {its1b} / {its2b} against {pits1} / {pits2} "
                             f"replicated, x {dxr} from it, {dxb} from 14a")
    launches += sum(int(r["launches"]) + int(r["plain_launches"]) for r in ranks)

    # -- 14c: the overlapped leaf exchange over 2 ranks ----------------
    if leaf_ref is None:  # --only=14: 13a's single-device run
        from permon_tpu_torch.core.convergence import Tolerances
        from permon_tpu_torch.feti.solve import FetiOptions, FetiSolver
        from permon_tpu_torch.problems import build_ex71

        prob = build_ex71(*DENSE_POISSON)
        r = FetiSolver(prob, FetiOptions(throughput=True), device=dev).solve(
            tol=Tolerances(rtol=1e-5))
        leaf_ref = dict(its=r.result.iterations, x=r.x_global)
        del prob, r
        torch.cuda.empty_cache()
    ranks = run_ranks("14c", 2)
    _rank_lines("14c", ranks)
    r0 = ranks[0]
    its = int(_same(ranks, "its"))
    x1 = _same(ranks, "x1")
    dxc = np.abs(x1 - leaf_ref["x"]).max() / np.abs(leaf_ref["x"]).max()
    errc = max(float(r["apply_err"]) for r in ranks)
    apply_ms = ", ".join(f"{float(r['apply_ms']):.3f}" for r in ranks)
    log(f"[14c] 12a's problem on the leaf path over 2 ranks ({int(r0['ns_loc'])} subdomains, "
        f"{int(r0['nb'])} boundary, {int(r0['offsets'])} offset(s) each): {its} iterations "
        f"(13a: {leaf_ref['its']}), max |x - x_13a| / max |x_13a| {dxc:.3e}; overlapped apply "
        f"against the flat one {errc:.3e}, {apply_ms} ms an apply; first solve "
        f"{float(r0['t_first']):.3f} s, warm {float(r0['t_warm']):.3f} s")
    if not all(int(x) == 2 for x in _same(ranks, "reasons")):
        raise AssertionError("14c: a solve did not reach reason 2")
    if its != LEAF_ITS or its != leaf_ref["its"] or not dxc <= 1e-10 or not errc <= 1e-12:
        raise AssertionError(f"14c: {its} iterations (13a {leaf_ref['its']}), dx {dxc}, "
                             f"apply error {errc}")
    launches += sum(int(r["launches"]) for r in ranks)

    # -- 14d: NCCL, one rank -------------------------------------------
    ranks = run_ranks("14d", 1)
    _rank_lines("14d", ranks)
    its_d = [int(i) for i in ranks[0]["its"]]
    log(f"[14d] twin {TWIN[0]} on NCCL, one rank: iterations {its_d} (phase 5: {twin_its}), "
        f"reason {int(ranks[0]['reason'])}, assembled residual {float(ranks[0]['resid']):.3e}")
    if ranks[0]["backend"] != "nccl" or int(ranks[0]["reason"]) != 2 or not float(
            ranks[0]["resid"]) < 1e-8:
        raise AssertionError("14d: the NCCL run failed")
    if twin_its is not None and its_d != list(twin_its):
        raise AssertionError(f"14d: counts {its_d} against phase 5's {twin_its}")
    if twin_its is None and not 22 <= its_d[0] <= 24:
        raise AssertionError(f"14d: {its_d} iterations")
    launches += int(ranks[0]["launches"])
    return launches


# -------------------------------------------------------------- phase 15

#: phase 15: the JAX examples' counts on the CPU, beside which each port example's
#: are printed and held: (what is counted, the counts).  Sources: the
#: reference oracles the JAX package's tests pin (tests/test_mprgp_ex1.py,
#: tests/test_jbearing.py, tests/test_transforms.py, tests/test_feti.py) and,
#: for feti_contact and svm, what `python examples/feti_contact.py` and
#: `python examples/svm.py` print (tests/test_torch_examples.py holds the
#: port's CPU counts equal to them)
EXAMPLE_REFERENCE = {
    "ex1": ("iterations / products / CG / expansion / proportioning", (181, 200, 156, 18, 7)),
    "ex2": ("iterations / products / CG / expansion / proportioning", (197, 209, 179, 11, 7)),
    "ex3": ("iterations / products / CG / expansion / proportioning", (44, 71, 17, 26, 1)),
    "jbearing2": ("iterations / products / CG / expansion / proportioning", (23, 24, 21, 0, 2)),
    "feti_ex1": ("iterations", (1,)),
    "feti_contact": ("outer / inner / products", (29, 72, 126)),
    "feti_ex71": ("iterations", (9,)),
    "feti_ex71 elasticity": ("iterations", (64,)),
    "svm": ("outer / inner / reason", (9, 488, 2)),
}
#: 15: feti_large's main at the north star, (ncells, g): the problem of phases 5-6
EXAMPLE_LARGE = (NORTH_STAR[0][0], NORTH_STAR[1][0])
#: 15: a count on the card within this many of the CPU's (phase 12c holds the
#: same elasticity tutorial within 2: its dual CG rounds otherwise on the card)
EXAMPLE_BAND = {"feti_ex71 elasticity": 2}


def phase_examples(dev, main_its=None):
    """15: every command-line example of the port (permon_tpu_torch/examples/)
    through its ``main`` on the card (``device=`` the card, as None would
    pick it), at its JAX twin's default arguments: ex1, ex2, ex3,
    jbearing2, feti_ex1, feti_contact, feti_ex71 (and its main_elasticity),
    svm, and feti_large at the north star (``main(100, 4)``: the problem of
    phases 5-6, built again by the example) and its main_elasticity at the
    example's default size.  Each example's printed lines are logged; its
    counts are held beside the JAX example's (EXAMPLE_REFERENCE) and every
    solve to reason > 0; the kernels' launches under each example are counted
    from 0.  The FETI examples must launch the gather kernel (B, B' and the
    reassembly); ex1, ex2 and jbearing2 run their Hessian on ``Dia`` (the
    banded rule of ``make_operator``, as the JAX package picks it), ex3 and
    svm on dense operators, so none of them reaches a kernel.  feti_large's
    residual is held as phase 6 holds it (1e-6).  Every FETI example's solve
    is run again through the plain gather version
    (``FetiOptions(gather_kernel=False)``), as phases 8a, 9b, 12a and 13a do,
    and must give the same counts and a bitwise equal x_global with no
    kernel launch: through the example's own ``main`` where it passes
    FetiOptions' keywords on (feti_ex1, feti_ex71, and feti_ex71's
    ``main_elasticity`` as the ``main`` call it makes), else the example's
    recipe from its problem function (feti_contact's ``build``; feti_large's
    ``build_sparse`` / ``build_sparse_elasticity`` with its factors and
    passes).  Returns (gather_apply, sell_mv) launches under the examples'
    own runs."""
    import contextlib
    import importlib
    import io

    import numpy as np
    import torch

    from permon_tpu_torch.core.convergence import Tolerances
    from permon_tpu_torch.core.dia import Dia
    from permon_tpu_torch.core.sell import gather_apply, sell_mv
    from permon_tpu_torch.feti.large import FetiSolverSparse, feti_solve_sparse
    from permon_tpu_torch.feti.solve import FetiOptions, feti_solve
    from permon_tpu_torch.problems import build_sparse, build_sparse_elasticity

    def qp_counts_of(i):
        def of(ret, text):
            r = ret[i]
            return r.reason, (r.iterations, r.nmv, r.ncg, r.nexp, r.nprop)
        return of

    def contact_counts(ret, text):
        r = ret[1]
        return r.reason, (r.iterations, r.inner_iterations, r.nmv)

    def feti_counts(ret, text):
        r = ret[1].result
        return r.reason, (r.iterations,)

    def large_counts(res):  # every dual solve: the first pass and the defect passes
        return res.result.reason, tuple(p.iterations for p in res.results)

    def svm_counts(ret, text):  # main returns the accuracy: the counts from its line
        got = tuple(int(text.split(k + "=")[1].split()[0])
                    for k in ("outer_its", "inner_its", "reason"))
        return got[2], got

    failures = []
    n_gather = n_sell = 0
    # (tag, example module, its call, (reason, counts) from its return and printed text)
    runs = [(name, name, lambda m: m.main(device=dev), of) for name, of in (
        ("ex1", qp_counts_of(1)), ("ex2", qp_counts_of(1)), ("ex3", qp_counts_of(2)),
        ("jbearing2", qp_counts_of(1)), ("feti_ex1", feti_counts),
        ("feti_contact", contact_counts), ("feti_ex71", feti_counts), ("svm", svm_counts))]
    runs += [("feti_ex71 elasticity", "feti_ex71", lambda m: m.main_elasticity(device=dev),
              feti_counts),
             ("feti_large", "feti_large", lambda m: m.main(*EXAMPLE_LARGE, device=dev),
              lambda ret, text: large_counts(ret[0])),
             ("feti_large elasticity", "feti_large", lambda m: m.main_elasticity(device=dev),
              lambda ret, text: large_counts(ret))]
    # each FETI example's solve through the plain gather version: (the call,
    # returning what the example's call returns; x_global of such a return)
    f32 = dict(kplus_dtype=torch.float32, kplus_refine=2)

    def contact_plain(m):  # feti_contact.main's solve
        prob, BI, cI, _ = m.build()
        r = feti_solve(prob, FetiOptions(gluing="nonred", gather_kernel=False), BI=BI, cI=cI,
                       device=dev)
        return r.x_global, r.result, r.solution

    def large_plain(m):  # feti_large.main(*EXAMPLE_LARGE)'s solve
        ncells, g = EXAMPLE_LARGE
        prob = build_sparse((ncells,) * 3, (g,) * 3)
        return feti_solve_sparse(prob, FetiOptions(gluing="nonred", gather_kernel=False),
                                 tol=Tolerances(rtol=1e-5), device=dev, primal_refine=1,
                                 **f32), None

    def large_elastic_plain(m):  # feti_large.main_elasticity()'s solve, at its defaults
        prob = build_sparse_elasticity((16,) * 3, (2,) * 3)
        return FetiSolverSparse(
            prob, FetiOptions(gluing="nonred", nullspace="rbm", dirichlet_by_B=False,
                              gather_kernel=False),
            primal_refine=1, device=dev, **f32).solve(tol=Tolerances(rtol=1e-5))

    plain = {
        "feti_ex1": (lambda m: m.main(device=dev, gather_kernel=False),
                     lambda r: r[1].x_global),
        "feti_ex71": (lambda m: m.main(device=dev, gather_kernel=False),
                      lambda r: r[1].x_global),
        "feti_ex71 elasticity": (lambda m: m.main(  # what main_elasticity() calls
            cells=(8, 6, 4), grid=(7, 1, 1), pde="elasticity", gluing="nonred", pc_dual="none",
            nullspace="numeric", rtol=1e-6, device=dev, gather_kernel=False),
            lambda r: r[1].x_global),
        "feti_contact": (contact_plain, lambda r: r[0]),
        "feti_large": (large_plain, lambda r: r[0].x_global),
        "feti_large elasticity": (large_elastic_plain, lambda r: r.x_global),
    }
    t_all = time.perf_counter()
    for tag, module, call, counts in runs:
        mod = importlib.import_module(f"permon_tpu_torch.examples.{module}")
        gather_apply.launches = sell_mv.launches = 0
        out = io.StringIO()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            ret = call(mod)
        torch.cuda.synchronize(dev)
        t = time.perf_counter() - t0
        g, sv = gather_apply.launches, sell_mv.launches
        n_gather, n_sell = n_gather + g, n_sell + sv
        for line in out.getvalue().splitlines():
            log(f"[examples] {tag}: {line}")
        reason, got = counts(ret, out.getvalue())
        got = tuple(int(v) for v in got)
        ref = EXAMPLE_REFERENCE.get(tag)
        band = EXAMPLE_BAND.get(tag, 0)
        line = (f"[examples] {tag}: {t:.3f} s on the card, reason {reason}, "
                + (f"{ref[0]} {got} (JAX example {ref[1]}"
                   + (f", band {band})" if band else ")") if ref else f"counts {got}")
                + f"; launches: gather_apply {g}, sell_mv {sv}")
        log(line)
        if not int(reason) > 0:
            failures.append(f"{tag}: reason {reason}")
        if ref and any(abs(a - b) > band for a, b in zip(got, ref[1])):
            failures.append(f"{tag}: {got} against the JAX example's {ref[1]}")
        if module.startswith("feti") and g <= 0:
            failures.append(f"{tag}: the gather kernel was never launched")
        if tag in plain:
            call_plain, x_of = plain[tag]
            gather_apply.launches = 0
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                pret = call_plain(mod)
            torch.cuda.synchronize(dev)
            tp = time.perf_counter() - t0
            preason, pgot = counts(pret, "")
            pgot = tuple(int(v) for v in pgot)
            same = np.array_equal(np.asarray(x_of(pret)), np.asarray(x_of(ret)))
            log(f"[examples] {tag}: through the plain gather version (gather_kernel=False) "
                f"{tp:.3f} s, reason {preason}, counts {pgot}, x_global bitwise equal {same}, "
                f"kernel launches {gather_apply.launches}")
            if (int(preason), pgot) != (int(reason), got) or not same or gather_apply.launches:
                failures.append(f"{tag}: the plain gather version gives reason {preason}, "
                                f"{pgot}, x bitwise equal {same}, {gather_apply.launches} "
                                f"launches against the kernel's {reason}, {got}")
            del pret
        if module in ("ex1", "ex2", "jbearing2"):
            op = ret[0].A
            log(f"[examples] {tag}: Hessian on {type(op).__name__} (the banded rule of "
                f"make_operator), {'as' if isinstance(op, Dia) else 'NOT as'} the JAX package "
                f"picks it")
            if not isinstance(op, Dia):
                failures.append(f"{tag}: Hessian on {type(op).__name__}")
        if tag == "feti_large":
            resid = ret[1]
            log(f"[examples] feti_large: assembled residual {resid:.3e} (limit 1e-6, as phase 6)"
                + (f"; phase 6's first solve (deterministic=True) {main_its}" if main_its else ""))
            if not resid <= 1e-6:
                failures.append(f"feti_large: residual {resid}")
    log(f"[examples] all examples {time.perf_counter() - t_all:.1f} s; launches under the "
        f"examples: gather_apply {n_gather}, sell_mv {n_sell}")
    if failures:
        raise AssertionError("phase 15: " + "; ".join(failures))
    return n_gather, n_sell


def phase_api(dev, jb_rcm=None, qp_ref=None, kreg=None, twin_its=None):
    """16: the JAX package's public names on the card, through
    ``import permon_tpu_torch as pt`` alone, on problems earlier phases
    built: (a) ``__graft_entry__.entry``'s recipe (the ex1 obstacle QP at
    n = 1024 on ``pt.Dia``, ``pt.mprgp`` capped at 200 iterations) against
    the same calls on CPU tensors; (b) phase 7's jbearing-RCM QP through
    ``pt.make_operator`` -> SEll and ``pt.mprgp`` directly: its count and x
    bitwise those of phase 7's ``pt.solve`` (``qp_ref``), and
    ``pt.Scaled(..., 2.0).diagonal()`` of the unpermuted problem's ``pt.Dia``
    twice scipy's diagonal (SEll has no diagonal in either package); (c) the
    north star's ``RegularizedBlockDia`` (phase 6's K, ``kreg``: the operator
    and the host diagonal of its blocks): ``diagonal()`` on the card bitwise
    that of CPU tensors and of the host's scipy blocks with the fixing-dof
    correction added; (d) the twin's dual (phase 5's problem and recipe,
    through the transform chain) by ``cg(..., monitor=True)``: one printed
    line per convergence test (iterations + 1), counts and x bitwise those of
    ``monitor=False``, the period per iteration of both (five runs of each,
    alternated after a warm-up) and one line's host cost alone; the same
    dual on the plain gather tables: counts and x bitwise, no launch.  The
    kernels' launches are counted from 0."""
    import contextlib
    import io

    import numpy as np
    import scipy.sparse as sp
    import torch

    import permon_tpu_torch as pt
    from permon_tpu_torch.core.sell import SEll, gather_apply, sell_mv
    from permon_tpu_torch.examples import ex1
    from permon_tpu_torch.feti.large import assemble_qp_sparse
    from permon_tpu_torch.problems import build_jbearing, build_sparse, rcm_permuted
    from permon_tpu_torch.qp.transforms import dualize, enforce_eq_by_projector, homogenize_eq
    from permon_tpu_torch.solvers.cg import cg

    failures = []
    t_all = time.perf_counter()
    gather_apply.launches = sell_mv.launches = 0  # count this phase's launches only

    # (a) the graft entry's recipe
    A, b, lb = ex1.build(1024)
    runs = {}
    for where in ("cuda", "cpu"):
        kw = {} if where == "cuda" else dict(device="cpu")  # the card: nothing but the default
        op = pt.Dia.from_scipy(sp.csr_matrix(A), **kw)
        t0 = time.perf_counter()
        res = pt.mprgp(pt.QP.create(op, b, lb=lb, **kw), tol=pt.Tolerances(max_it=200))
        torch.cuda.synchronize(dev)
        runs[where] = (res, time.perf_counter() - t0)
    (rg, tg), (rc, _) = runs["cuda"], runs["cpu"]
    xg = rg.x.cpu().numpy()
    dx = float(np.abs(xg - rc.x.numpy()).max())
    log(f"[api] (a) pt.Dia + pt.mprgp (n = 1024, max_it 200) on {rg.x.device}: reason "
        f"{rg.reason}, {rg.iterations} iterations, rnorm {rg.rnorm:.6e} ({tg:.3f} s, {CARD}); "
        f"CPU tensors: {rc.iterations} iterations, rnorm {rc.rnorm:.6e}; max |x_card - x_cpu| "
        f"{dx:.3e}")
    if (rg.x.device.type != "cuda" or rg.iterations != rc.iterations or not dx <= 1e-9
            or not np.isfinite(rg.rnorm) or not (xg >= lb).all()):
        failures.append(f"(a): {rg.iterations} vs {rc.iterations} iterations, dx {dx}")

    # (b) jbearing-RCM through make_operator -> SEll, pt.mprgp against pt.solve
    if jb_rcm is None:
        jb_rcm = rcm_permuted(*build_jbearing(*JBEARING))
    Ap, bp, lbp, ubp, _ = jb_rcm
    tol = pt.Tolerances(rtol=1e-6, atol=1e-8)  # phase 7's
    qp = pt.QP.create(pt.make_operator(Ap), bp, lb=lbp, ub=ubp)
    if not isinstance(qp.A, SEll):
        failures.append(f"(b): make_operator gave {type(qp.A).__name__}")
    if qp_ref is None:  # --only=16: phase 7's pt.solve, here
        qp_ref = pt.solve(pt.QP.create(Ap, bp, lb=lbp, ub=ubp), tol=tol)
    n0 = sell_mv.launches
    rm, tm = timed_call(lambda: pt.mprgp(qp, tol=tol))
    same = torch.equal(rm.x, qp_ref.x)
    log(f"[api] (b) pt.mprgp on pt.make_operator's {type(qp.A).__name__}: reason {rm.reason}, "
        f"counts {qp_counts(rm)} ({tm:.3f} s, {CARD}; {sell_mv.launches - n0} sell_mv launches); "
        f"phase 7's pt.solve {qp_counts(qp_ref)}; x bitwise equal {same}")
    if rm.reason != 2 or qp_counts(rm) != qp_counts(qp_ref) or not same:
        failures.append(f"(b): mprgp {qp_counts(rm)} reason {rm.reason} against solve "
                        f"{qp_counts(qp_ref)}, x bitwise {same}")
    Aj = build_jbearing(*JBEARING)[0]
    dj = pt.Scaled(pt.Dia.from_scipy(Aj), 2.0).diagonal().cpu().numpy()
    same_d = np.array_equal(dj, 2.0 * Aj.diagonal())
    log(f"[api] (b) pt.Scaled(pt.Dia (unpermuted jbearing), 2.0).diagonal() = 2 x scipy's "
        f"diagonal, bitwise: {same_d}")
    if not same_d:
        failures.append("(b): Scaled(Dia).diagonal() != 2 x scipy's diagonal")

    # (c) the north star's regularized K
    if kreg is None:  # --only=16: phase 6's operator, built here (f32 factors as there)
        prob = build_sparse(*NORTH_STAR)
        _, kp, _, _ = assemble_qp_sparse(prob, pt.FetiOptions(gluing="nonred"),
                                         kplus_dtype=torch.float32, kplus_refine=2, device=dev)
        kreg = (kp.op, north_star_host_diagonal(prob, kp.op.base.nlp))
        del prob, kp
    op, host_k = kreg
    t0 = time.perf_counter()
    dg = op.diagonal()
    torch.cuda.synchronize(dev)
    t_d = time.perf_counter() - t0
    cpu_op = op.replace(base=op.base.replace(data=op.base.data.cpu()), idx=op.idx.cpu(),
                        q=op.q.cpu(), bi=op.bi.cpu())
    dc = cpu_op.diagonal()
    ns, nlp = host_k.shape
    idx, q, bi = op.idx.cpu().numpy(), op.q.cpu().numpy(), op.bi.cpu().numpy()
    kf = idx.shape[1]
    host = host_k.copy()
    for s in range(ns):  # diag(K_s + the correction scattered into the block)
        g = bi[s] * op.NB + idx[s]
        host[s] += sp.coo_matrix((q[s].ravel(), (np.repeat(g, kf), np.tile(g, kf))),
                                 shape=(nlp, nlp)).diagonal()
    dgh = dg.cpu()
    same_c, same_h = torch.equal(dgh, dc), np.array_equal(dgh.numpy(), host.reshape(-1))
    n_corr = int((host.reshape(-1) != host_k.reshape(-1)).sum())
    log(f"[api] (c) RegularizedBlockDia.diagonal() of the north star ({ns} x {nlp}, {n_corr} "
        f"corrected dofs) on the card {1e3 * t_d:.3f} ms ({CARD}): bitwise the CPU tensors' "
        f"{same_c}, bitwise the host scipy blocks' with the fixing-dof correction {same_h}")
    if not (same_c and same_h and n_corr > 0):
        failures.append(f"(c): card = CPU {same_c}, card = host {same_h}, corrected {n_corr}")
    d2 = pt.Scaled(op, 2.0).diagonal()
    if not torch.equal(d2, 2.0 * dg):
        failures.append("(c): Scaled(RegularizedBlockDia).diagonal() != 2 x its diagonal")
    del dg, dc, cpu_op, d2

    # (d) the twin's dual by cg(monitor=True), and once more on plain tables
    qt, kp, _, _ = assemble_qp_sparse(build_sparse(*TWIN), pt.FetiOptions(gluing="nonred"),
                                      kplus_dtype=torch.float32, kplus_refine=2, device=dev)

    def twin_dual(q):
        dual, _ = dualize(q, kplus=kp.replace(refine=0))
        if dual.cE is not None:
            dual, _ = homogenize_eq(dual)
        return enforce_eq_by_projector(dual)[0], dual.pf.apply_p

    proj, apply_p = twin_dual(qt)
    ttol = pt.Tolerances(rtol=1e-5)

    def run(monitor):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            res, t = timed_call(lambda: cg(proj, tol=ttol, project=apply_p, monitor=monitor))
        lines = [ln for ln in out.getvalue().splitlines() if " CG ||Pr||=" in ln]
        return res, t / max(res.iterations, 1), lines

    n0 = gather_apply.launches
    quiet, _, _ = run(False)  # warm-up
    n_g = gather_apply.launches - n0
    periods = {False: [], True: []}
    same, lines = True, []
    for monitor in (False, True) * 5:  # alternated, so that run order lands on neither side
        res, per, ln = run(monitor)
        periods[monitor].append(per)
        if monitor:
            lines = ln
            same &= len(ln) == res.iterations + 1
        same &= (res.iterations, res.reason) == (quiet.iterations, quiet.reason) and torch.equal(
            res.x, quiet.x)
    for ln in (lines[:2] + ["..."] + lines[-1:]) if len(lines) > 3 else lines:
        log(f"[api] (d)   {ln}")
    p_loud, p_quiet = (float(np.median(periods[m])) for m in (True, False))
    m_loud, m_quiet = (min(periods[m]) for m in (True, False))
    buf = io.StringIO()  # the monitor's own host cost: its line, formatted and printed
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        for it in range(1000):
            print(f"{it:>3} CG ||Pr||={quiet.rnorm:.10e}")
    t_line = (time.perf_counter() - t0) / 1000
    log(f"[api] (d) the twin's dual cg: reason {quiet.reason}, {quiet.iterations} iterations "
        f"(phase 5's first pass {twin_its[0] if twin_its else 'not run'}), {n_g} gather_apply "
        f"launches a run; 5 monitor=True runs alternated with 5 monitor=False: {len(lines)} lines "
        f"a loud run, counts and x bitwise equal {same}; period per iteration (median, least) "
        f"{1e3 * p_loud:.3f}, {1e3 * m_loud:.3f} ms with the monitor, {1e3 * p_quiet:.3f}, "
        f"{1e3 * m_quiet:.3f} ms without; one monitor line alone {1e6 * t_line:.2f} us on the "
        f"host ({CARD})")
    if quiet.reason != 2 or len(lines) != quiet.iterations + 1 or not same or n_g <= 0:
        failures.append(f"(d): reason {quiet.reason}, {len(lines)} lines for "
                        f"{quiet.iterations} iterations, bitwise {same}, launches {n_g}")
    proj_p, apply_pp = twin_dual(qt.replace(BE=qt.BE.with_kernel(False)))
    n0 = gather_apply.launches
    plain = cg(proj_p, tol=ttol, project=apply_pp)
    n_p = gather_apply.launches - n0
    same_p = (plain.iterations, plain.reason) == (quiet.iterations, quiet.reason) and torch.equal(
        plain.x, quiet.x)
    log(f"[api] (d) the twin's dual on the plain gather version: {plain.iterations} iterations, "
        f"x bitwise equal {same_p}, kernel launches {n_p}")
    if not same_p or n_p:
        failures.append(f"(d): plain tables {plain.iterations} iterations, x bitwise {same_p}, "
                        f"launches {n_p}")
    n_gather, n_sell = gather_apply.launches, sell_mv.launches
    log(f"[api] phase 16 {time.perf_counter() - t_all:.1f} s; launches: gather_apply "
        f"{n_gather}, sell_mv {n_sell}")
    if n_gather <= 0 or n_sell <= 0:
        failures.append(f"launches gather_apply {n_gather}, sell_mv {n_sell}")
    if failures:
        raise AssertionError("phase 16: " + "; ".join(failures))
    return n_gather, n_sell


def north_star_host_diagonal(prob, nlp):
    """(ns, nlp) diagonals of the north star's subdomain blocks on the host
    (scipy), padding rows 1 as ``BlockDia.from_scipy_blocks`` pads them."""
    import numpy as np

    out = np.ones((prob.ns, nlp))
    for s, K in enumerate(prob.K_blocks):
        out[s, : K.shape[0]] = K.diagonal()
    return out


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    opts = dict(a.split("=", 1) for a in sys.argv[1:] if "=" in a)
    if "--rank-worker" in opts:  # one rank of phase 14 (run_ranks)
        return rank_worker(opts["--rank-worker"], opts["--out"])
    from permon_tpu_torch.core import sell
    from permon_tpu_torch.problems import build_sparse

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    global CARD
    CARD = smi.stdout.strip().splitlines()[0]
    log(f"[device] {CARD}")
    log(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    sell.build_all(force=True)
    log(f"[build] {', '.join(n + '.cu' for n in sell.SOURCES)} built together in "
        f"{time.perf_counter() - t0:.2f} s")
    for name in sell.SOURCES:
        for line in sell.BUILD_INFO[name]["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    from permon_tpu_torch.problems import (build_jbearing, build_obstacle_elasticity,
                                           laplacian_3d_rcm, rcm_permuted)

    def build_elastic():
        t0 = time.perf_counter()
        bundle = build_obstacle_elasticity(*ELASTICITY)
        return bundle, time.perf_counter() - t0

    if "--only" in opts:  # development: the named phases alone
        for name, run in (("9", lambda: phase_elasticity(*build_elastic(), dev)),
                          ("9c", lambda: phase_elastic_smalbe(
                              dev, "--9c-f64" in sys.argv[1:],
                              float(opts.get("--9c-rtol-E", 0.1)),
                              int(opts.get("--9c-inner-max-it", 10000)))),
                          ("9t", lambda: phase_elastic_tolerances(build_elastic()[0], dev)),
                          ("10", lambda: phase_band_coarse(dev)),
                          ("12", lambda: phase_dense(dev)),
                          ("12c", lambda: phase_dense_reference(dev)),
                          ("13", lambda: phase_leaf(dev)),
                          ("14", lambda: phase_ranks(dev)),
                          ("14k", lambda: phase_kplus_batches(dev)),
                          ("15", lambda: phase_examples(dev)),
                          ("16", lambda: phase_api(dev)),
                          ("11", lambda: phase_qp_rest(*phase_qp_only(dev))),
                          ("11c", lambda: [phase_ex3(int(n), dev)
                                           for n in opts.get("--ex3-n", str(EX3_N)).split(",")]),
                          ("11l", lambda: phase_blmvm_grids(
                              [int(g) for g in opts.get("--blmvm-grids", "96,128,192").split(",")],
                              dev))):
            if name in opts["--only"].split(","):
                run()
        return 0
    t0 = time.perf_counter()
    prob = build_sparse(*NORTH_STAR)
    t_host_prob = time.perf_counter() - t0
    elastic, t_host_elastic = build_elastic()
    gather_rec = phase_kernel(prob, elastic[0], elastic[1], dev)

    t0 = time.perf_counter()
    jb = build_jbearing(*JBEARING)
    jb_rcm = rcm_permuted(*jb)
    t_host_jb = time.perf_counter() - t0
    t0 = time.perf_counter()
    jb_a = rcm_permuted(*build_jbearing(*SPMV_JBEARING))[0]
    lap = laplacian_3d_rcm(LAPLACIAN_NX)
    log(f"[spmv] host build of matrices (a) and (b) {time.perf_counter() - t0:.2f} s")
    spmv_rec = phase_spmv({
        f"(main) jbearing {JBEARING[0]}x{JBEARING[1]} rcm": jb_rcm[0],
        f"(a) jbearing {SPMV_JBEARING[0]}x{SPMV_JBEARING[1]} rcm": jb_a,
        f"(b) laplacian {LAPLACIAN_NX}^3 rcm": lap,
        "(c) skewed 20000": skewed_matrix(),
        "(c) rectangular 3000x20000": random_sparse(3000, 20000, 120000,
                                                    np.random.RandomState(3)),
    }, dev)
    del lap, jb_a
    gather_rec["floor_ms"] = spmv_rec["floor_ms"]  # one floor for every "ms" of the line
    tree_rec = phase_tree(dev)
    if "--kernels-only" in sys.argv[1:]:  # development: stop after the kernel phases
        return 0

    twin_its = phase_twin(dev)
    launches, main_ref, kreg, tree_launches = phase_main(prob, t_host_prob, dev)
    del prob
    sell_launches, res64, t64 = phase_qp(jb, jb_rcm, t_host_jb, dev)
    sell_launches += phase_qp_rest(jb_rcm, res64, t64, dev)
    qp_its = res64.iterations
    del jb
    launches += phase_contact(dev)
    launches += phase_elasticity(elastic, t_host_elastic, dev)
    del elastic
    launches += phase_band_coarse(dev)
    n12, rows = phase_dense(dev)
    launches += n12
    g13, s13, leaf_ref = phase_leaf(dev, rows, jb_rcm, qp_its)
    del rows
    launches += g13
    sell_launches += s13
    launches += phase_ranks(dev, main_ref, leaf_ref, twin_its)
    examples_gather, examples_sell = phase_examples(dev, main_ref and main_ref["its1"])
    launches += examples_gather
    sell_launches += examples_sell
    api_gather, api_sell = phase_api(dev, jb_rcm, res64, kreg, twin_its)
    del res64, kreg
    launches += api_gather
    sell_launches += api_sell

    print(json.dumps({"kernels": [
        {"name": "gather_apply", "route": "cuda",
         "source": "permon_tpu_torch/csrc/gather_apply.cu",
         "replaces": "permon_tpu/core/sell.py:417", "launches": launches,
         "launches_examples": examples_gather, "launches_api": api_gather, **gather_rec},
        {"name": "sell_mv", "route": "cuda",
         "source": "permon_tpu_torch/csrc/sell_mv.cu",
         "replaces": "permon_tpu/core/sell.py:504", "launches": sell_launches,
         "launches_examples": examples_sell, "launches_api": api_sell, **spmv_rec},
        {"name": "det_sum", "route": "cuda", "source": "permon_tpu_torch/csrc/det_sum.cu",
         "replaces": "permon_tpu/core/detred.py:64", "launches": tree_launches, **tree_rec},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
