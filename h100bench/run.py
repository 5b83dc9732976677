#!/usr/bin/env python3
"""The benchmark of permon_tpu_torch on NVIDIA H100 cards.

    python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  One run builds the cell's system, warms
it up, drives load steps for ``--seconds`` in a closed loop, checks the
answers against the plain reference, and prints as the last line of its
standard output one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics; with ``--trace 1`` its
per-layer metrics from a traced run), ``device``, with ``--trace 1``
``breakdown``, and last ``checks`` (each number compared, with its limit;
the same as the last lines of standard error).

It exits with another code than 0, and prints no result, without a CUDA
card (or with fewer than the cell asks for), and when JAX or the JAX
package is loaded.  Every cache of the program's kernels stays in the
checkout's ``build/`` directory.
"""

import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "build", "h100bench")
# fixed directories inside the checkout: a later run of the cell finds every
# kernel built (the port's own nvcc libraries go to <checkout>/build/permon_tpu_torch)
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE, "cuda")
os.environ["USE_FLAX"] = "0"
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "4"
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    import argparse
    import json

    from h100bench.harness import banned_modules, log, read_spec, resolve, run_cell

    found = banned_modules()
    if found:
        log(f"[h100bench] loaded at start: {found}; the benchmark runs without them")
        return 3
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = read_spec(ROOT)
    cell = resolve(ROOT, args.workload, spec)
    seconds = spec["run_seconds"] if args.seconds is None else args.seconds

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"[h100bench] {cell.name} needs {cell.chips} CUDA card(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[h100bench] {torch.cuda.get_device_name(0)}, power limit {power_limit()}, "
        f"torch {torch.__version__} (CUDA {torch.version.cuda})")
    result = run_cell(cell, args.seed, seconds, bool(args.trace), torch.device("cuda", 0),
                      T_START)
    found = banned_modules()
    if found:
        log(f"[h100bench] loaded by the run: {found}; no result")
        return 3
    for k, c in result["checks"].items():  # the numbers compared, last on standard error
        log(f"check {k} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


def power_limit() -> str:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({e})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"


if __name__ == "__main__":
    sys.exit(main())
