"""The coarse projector's share of its roofline in the elasticity cell
(G = R'B' a BlockCoarse, k = 540): the least time of one P apply
(counts_elastic.projector_apply_work: B' and B of the gluing rows, the
rigid-body bases read in G and in G', the coarse inverse, the dual vector
in and out, over the published H100 peaks in f64) over the device time of
one ``apply_p`` of the cell's own projector on a dual vector, as the dual
CG applies it, the union of its records in the profiler's trace, after
the window."""

from h100bench import counts_elastic, peaks


def read(ctx):
    t = ctx.device_seconds_per_call("projector", ctx.system.projector_apply, reps=20)
    if t is None:
        return None
    p = ctx.cell.config["problem"]
    nbytes, flops = counts_elastic.projector_apply_work(p["cells"], p["grid"])
    return 100.0 * peaks.least_seconds(nbytes, flops, "float64") / t
