"""Kernel launches of the optimizer a training step: the launch calls
made inside the program's ``qkan.train.adam`` spans in the profiled
epoch, over its ``qkan.train.step`` spans."""

ADAM, STEP = "qkan.train.adam", "qkan.train.step"


def read(ctx):
    spans = ctx.trace.annotations
    if not spans.get(ADAM) or not spans.get(STEP):
        return None
    return ctx.trace.launches_within(ADAM) / len(spans[STEP])
