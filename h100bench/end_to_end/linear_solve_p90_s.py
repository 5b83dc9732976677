"""The 90th percentile of the wall time of a load step, over every step of
the window (numpy's linear interpolation between order statistics)."""

import numpy as np


def read(ctx):
    return float(np.percentile([s.wall_s for s in ctx.steps], 90)) if ctx.steps else None
