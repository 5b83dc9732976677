"""Host milliseconds of the BlockCoarse applies per dual CG turn: the
``coarse.g_mv`` and ``coarse.g_rmv`` spans (every G and G' apply of the
step: the projector's in the loop, and those of the dualization and the
post chain) over the turns of the probe's steps, counted as
dual_iter_ms.linear counts them (program_spans.py). The spans are not
synchronised: this is the host's time to launch the coarse operator's
work. None where no such span opened (a program without them, or a G
below the dense cutoff, which is a DenseTree)."""

from h100bench import program_spans


def read(ctx):
    sp = program_spans.read(ctx)
    if sp is None or not sp.count("coarse.g_mv"):
        return None
    its = sp.count("cg.iteration") - sp.count("cg.solve")
    if its <= 0:
        return None
    return 1e3 * (sp.seconds("coarse.g_mv") + sp.seconds("coarse.g_rmv")) / its
