"""Kernel launches of the layer's training step: the launch calls made
inside the program's ``qkan.qlayer.step`` spans in the profiled epoch,
over those spans."""

STEP = "qkan.qlayer.step"


def read(ctx):
    spans = ctx.trace.annotations.get(STEP)
    if not spans:
        return None
    return ctx.trace.launches_within(STEP) / len(spans)
