"""Milliseconds of the whole solve per dual CG iteration: the window over
every dual iteration of its steps (the first pass and the defect pass).
It holds the solve entry's own work besides the iterations (lambda0, the
post chain, the reassembly, the defect residual, x_global to the host), so
it is the whole solve's rate, not the dual iteration's alone."""


def read(ctx):
    its = ctx.total("dual_its")
    return 1e3 * ctx.window_s / its if its else None
