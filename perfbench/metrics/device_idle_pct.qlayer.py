"""The card's idle share of the profiled epoch: one minus the union of
its kernel, copy and set intervals over the traced window."""


def read(ctx):
    if not ctx.trace.device:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
