"""Host set-up seconds: the benchmark's span around the problem build plus
the program's own synchronised span of its host set-up
(FetiSolverSparse.timings['host_setup_s'])."""


def read(ctx):
    if "host_setup_s" not in ctx.timings:
        return None
    return ctx.spans.get("problem_build_s", 0.0) + ctx.timings["host_setup_s"]
