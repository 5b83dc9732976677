"""Set-up: from the process's start to the first timed step (imports, the
CUDA context, the problem build, the host set-up, the factorization, the
kernels' build where the checkout has none yet, and the warm-up solve)."""


def read(ctx):
    return ctx.setup_s
