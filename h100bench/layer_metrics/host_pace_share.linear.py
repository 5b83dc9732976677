"""The share of a load step in which the host is not waiting for the
device, in percent: 100 x (1 - the seconds of the program's device-to-host
reads, the ``cg.read`` and ``feti.to_host`` spans, over the wall of the
probe's steps) (program_spans.py). Near 100 the host paces the step; the
device then idles while Python launches."""

from h100bench import program_spans


def read(ctx):
    sp = program_spans.read(ctx)
    if sp is None or not sp.count("cg.read") or sp.wall_s <= 0:
        return None
    waits = sp.seconds("cg.read") + sp.seconds("feti.to_host")
    return 100.0 * (1.0 - waits / sp.wall_s)
