"""Milliseconds of one turn of the dual CG loop, by the program's own
spans: the ``cg.iteration`` seconds over the iterations (each CG call turns
its loop iterations + 1 times: the last turn reads and tests only), over
the probe's steps (program_spans.py). A turn ends in the host's read of
the residual norm, so it holds the device's time of the turn."""

from h100bench import program_spans


def read(ctx):
    sp = program_spans.read(ctx)
    if sp is None:
        return None
    its = sp.count("cg.iteration") - sp.count("cg.solve")
    return 1e3 * sp.seconds("cg.iteration") / its if its > 0 else None
