"""Seconds of the K+ factorization, the program's own synchronised span
(FetiSolverSparse.timings['factor_s'])."""


def read(ctx):
    return ctx.timings.get("factor_s")
