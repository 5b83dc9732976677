"""The share of fixed-tree reductions, in percent, that ran as the
hand-written kernel: 100 x the ``detred.kernel`` spans over the
``detred.sum`` spans of the probe's steps (program_spans.py). It reads 100
where every tree on the card launched the kernel (csrc/det_sum.cu), and
less where some tree ran as the plain loop of adds. None where no tree
opened a span (a program without them)."""

from h100bench import program_spans


def read(ctx):
    sp = program_spans.read(ctx)
    if sp is None or not sp.count("detred.sum"):
        return None
    return 100.0 * sp.count("detred.kernel") / sp.count("detred.sum")
