"""The share of K+ passes, in percent, that run as the replay of a CUDA
graph: 100 x the ``kplus.replay`` spans over the ``kplus.solve`` spans of
the probe's steps (program_spans.py). It reads 100 where every pass is
one replay, and 0 where every pass is launched op by op (on the CPU, or a
program without the graph)."""

from h100bench import program_spans


def read(ctx):
    sp = program_spans.read(ctx)
    if sp is None or not sp.count("kplus.solve"):
        return None
    return 100.0 * sp.count("kplus.replay") / sp.count("kplus.solve")
