#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the card, in one
process (the benchmark's own runs never run this).

    python3 h100bench/control.py --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 [--out FILE]

For each of ``--seeds`` the sound program (the configuration's recipe)
solves the first ``check_sample`` loads of that seed's traffic, as many as
a run compares, and the reference judges each answer; then each control of
the configuration (``controls``: the recipe with one precision stepped
down) does the same on ``--control-seeds``, and so does each step of
``also_read`` (a lower precision read for the record, not held to fail).  Every seed sends the same pool
of loads (its generator), so each distinct load is solved once per program and
its reading serves every seed that checks it.  It prints, per number
compared, the worst reading of every seed: the lower reading is the largest
of the sound seeds', the upper the smallest of a control's.
"""

import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def readings(cell, seeds, device, overrides=None, system_factory=None):
    """{seed: {number: worst reading over the seed's checked loads}} and
    the solves that did not converge."""
    from h100bench import harness

    make = system_factory or harness.make_system
    system = make(cell, device) if overrides is None else make(cell, device, overrides)
    gen = harness.generator(cell)
    ref = harness.load_module(harness.HERE / "reference" / f"{cell.config['reference']}.py")
    ref = ref.Reference(cell.config)
    out, failed, seen = {}, 0, {}
    for seed in seeds:
        worst = {}
        for step in gen.steps(cell.mix, cell.config, seed)[: int(cell.mix["check_sample"])]:
            if step not in seen:
                f = gen.load(cell.mix, cell.config, step)
                ans = system.solve(system.to_input(f))
                failed += not ans.ok
                seen[step] = ref.check(f, ans.x)
                harness.log(f"[control] load {step}: {seen[step]} {ans.counts}")
            for k, v in seen[step].items():
                worst[k] = max(worst.get(k, 0.0), v)
        out[seed] = worst
        harness.log(f"[control] {cell.name} {overrides or 'sound'} seed {seed}: {worst}")
    system.close()
    return out, failed


def main(argv=None) -> int:
    import argparse

    import torch

    from h100bench import harness

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        harness.log("[control] no CUDA card")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cell = harness.resolve(ROOT, args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    cseeds = [int(s) for s in args.control_seeds.split(",")]
    steps = {**cell.config.get("also_read", {}), **cell.config["controls"]}
    t0 = time.perf_counter()
    sound, failed = readings(cell, seeds, dev)
    report = {"workload": cell.name, "card": torch.cuda.get_device_name(0),
              "sound": sound, "sound_failed": failed, "controls": {}}
    for name in steps:
        gc.collect()
        torch.cuda.empty_cache()
        try:
            got, nf = readings(cell, cseeds, dev, steps[name])
            report["controls"][name] = {"readings": got, "failed": nf}
        except Exception as e:  # a control that crashes has failed and sets no upper end
            harness.log(f"[control] {name} raised {e!r}")
            report["controls"][name] = {"raised": repr(e)[:400]}
    for k in cell.config["limits"]:
        lower = max(r[k] for r in sound.values())
        uppers = {n: min(r[k] for r in c["readings"].values())
                  for n, c in report["controls"].items() if "readings" in c}
        report.setdefault("summary", {})[k] = {"lower": lower, "upper_by_control": uppers}
        harness.log(f"[control] {k}: lower reading {lower!r}, upper by control {uppers}")
    report["seconds"] = time.perf_counter() - t0
    text = json.dumps(report)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
