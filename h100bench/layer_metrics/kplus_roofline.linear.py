"""The K+ apply's share of its roofline: the least time of one apply
(counts.kplus_apply_work: every subdomain's band Cholesky factor in its
natural ordering, read once at the recipe's factor precision, over the
published H100 peaks) over the device time of one apply of the cell's own
unrefined K+ (the one in every F apply), the union of its records in the
profiler's trace, after the window."""

from h100bench import counts, peaks


def read(ctx):
    t = ctx.device_seconds_per_call("kplus", ctx.system.kplus_apply, reps=20)
    if t is None:
        return None
    p = ctx.cell.config["problem"]
    nbytes, flops = counts.kplus_apply_work(p["cells"], p["grid"],
                                            ctx.cell.config["recipe"]["kplus_dtype"])
    return 100.0 * peaks.least_seconds(nbytes, flops, ctx.cell.config["recipe"]["kplus_dtype"]) / t
