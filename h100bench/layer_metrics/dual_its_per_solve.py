"""Dual CG iterations per load step (both passes), from the solver's counts."""


def read(ctx):
    its = ctx.total("dual_its")
    return its / len(ctx.steps) if its else None
