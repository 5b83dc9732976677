"""The gather kernel's share of its roofline on the F apply's two gathers
(B' then B, the gluing rows): the least time of the pair
(counts.gather_f_apply_work) over the device time of the kernel records
named gather_apply in the profiler's trace, per pair, after the window."""

from h100bench import counts, peaks


def read(ctx):
    t = ctx.device_seconds_per_call("gather", ctx.system.gather_applies, reps=50,
                                    pattern="gather_apply")
    if t is None:
        return None
    p = ctx.cell.config["problem"]
    nbytes, flops = counts.gather_f_apply_work(p["cells"], p["grid"])
    return 100.0 * peaks.least_seconds(nbytes, flops, "float64") / t
