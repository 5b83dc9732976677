"""Seconds per linear load step: the window over the steps completed in it."""


def read(ctx):
    return ctx.window_s / len(ctx.steps) if ctx.steps else None
