"""Kernel launches of a training step: the kernels that ran on the card
in the profiled epoch, over its steps."""


def read(ctx):
    kernels = ctx.trace.kernels()
    if not kernels or not ctx.unit["steps"]:
        return None
    return len(kernels) / ctx.unit["steps"]
