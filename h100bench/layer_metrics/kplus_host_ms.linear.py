"""Milliseconds of the host's time in one pass of K+'s block loop (one
forward and one backward substitution): the mean ``kplus.solve`` span over
the probe's steps (program_spans.py). The span is not synchronised, so it
is the time the host takes to launch the pass; its device time is what
the K+ rooflines read."""

from h100bench import program_spans


def read(ctx):
    sp = program_spans.read(ctx)
    if sp is None or not sp.count("kplus.solve"):
        return None
    return 1e3 * sp.seconds("kplus.solve") / sp.count("kplus.solve")
