"""Milliseconds a load step of the solve entry's own work, by the
program's own spans: ``feti.solve`` less ``cg.solve`` (the right-hand side,
dualize and lambda0, the post chain, the reassembly, the defect residual,
x_global to the host), per step of the probe (program_spans.py)."""

from h100bench import program_spans


def read(ctx):
    sp = program_spans.read(ctx)
    if sp is None or not sp.count("feti.solve"):
        return None
    return 1e3 * (sp.seconds("feti.solve") - sp.seconds("cg.solve")) / sp.steps
