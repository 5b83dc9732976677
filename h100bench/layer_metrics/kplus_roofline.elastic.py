"""The K+ apply's share of its roofline in the elasticity cell (NB 384
blocks, three dofs a node): the least time of one apply
(counts_elastic.kplus_apply_work: every subdomain's band Cholesky factor
in its natural node-major ordering, read once at the recipe's factor
precision, the f64 vector read and written once, over the published H100
peaks) over the device time of one apply of the cell's own unrefined K+
(the one in every F apply), the union of its records in the profiler's
trace, after the window."""

from h100bench import counts_elastic, peaks


def read(ctx):
    t = ctx.device_seconds_per_call("kplus", ctx.system.kplus_apply, reps=20)
    if t is None:
        return None
    p, dt = ctx.cell.config["problem"], ctx.cell.config["recipe"]["kplus_dtype"]
    nbytes, flops = counts_elastic.kplus_apply_work(p["cells"], p["grid"], dt)
    return 100.0 * peaks.least_seconds(nbytes, flops, dt) / t
