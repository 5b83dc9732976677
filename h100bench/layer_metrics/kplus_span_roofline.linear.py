"""The K+ apply's share of its roofline in the solve's own passes: the
least time of one pass (counts.kplus_apply_work: every subdomain's band
Cholesky factor in its natural ordering, read once at the recipe's factor
precision, over the published H100 peaks) over the device seconds of the
kernels launched under one ``kplus.solve`` span, by the profiler's own
attribution of kernels to ranges, in a profiled pass of the first of the
probe's steps (program_spans.py). Every pass the solve runs counts: the dual CG's, the
dualization's and the refined post chain's."""

from h100bench import counts, peaks, program_spans


def read(ctx):
    sp = program_spans.read(ctx)
    if sp is None or sp.kplus_device_s is None:
        return None
    p, dt = ctx.cell.config["problem"], ctx.cell.config["recipe"]["kplus_dtype"]
    nbytes, flops = counts.kplus_apply_work(p["cells"], p["grid"], dt)
    return 100.0 * peaks.least_seconds(nbytes, flops, dt) / sp.kplus_device_s
