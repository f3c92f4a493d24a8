"""The card's idle share of the profiled epoch."""


def read(ctx):
    if not ctx.trace.device:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
