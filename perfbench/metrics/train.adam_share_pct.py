"""The optimizer's share of a training step: the time inside the
program's ``qkan.train.adam`` spans (clipping and Adam, every
``AdamGroup.step`` of a step) over the time inside its
``qkan.train.step`` spans, in the profiled epoch."""

ADAM, STEP = "qkan.train.adam", "qkan.train.step"


def read(ctx):
    spans = ctx.trace.annotations
    if not spans.get(ADAM) or not spans.get(STEP):
        return None
    adam = sum(b - a for a, b in spans[ADAM])
    step = sum(b - a for a, b in spans[STEP])
    return 100.0 * adam / step
