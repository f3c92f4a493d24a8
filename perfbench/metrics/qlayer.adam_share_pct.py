"""The optimizer's share of the layer's training step: the time inside
the program's ``qkan.qlayer.adam`` spans over the time inside its
``qkan.qlayer.step`` spans, in the profiled epoch."""

ADAM, STEP = "qkan.qlayer.adam", "qkan.qlayer.step"


def read(ctx):
    spans = ctx.trace.annotations
    if not spans.get(ADAM) or not spans.get(STEP):
        return None
    adam = sum(b - a for a, b in spans[ADAM])
    step = sum(b - a for a, b in spans[STEP])
    return 100.0 * adam / step
