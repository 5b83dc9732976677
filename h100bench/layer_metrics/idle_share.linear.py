"""The device's idle share of the traced window: 1 - the union of its
kernel, copy and set intervals over the window, in percent."""


def read(ctx):
    tr = ctx.trace
    if tr is None or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
