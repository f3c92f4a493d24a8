"""Prediction and scoring's share of a market trial: the time inside the
program's ``qkan.dopt.predict`` spans (``DegreeOptimizer.predict``) and
``qkan.metrics`` spans (``utils.metrics.compute_metrics``) over the
profiled trial's window."""

PREDICT, METRICS = "qkan.dopt.predict", "qkan.metrics"


def read(ctx):
    spans = ctx.trace.annotations
    if not spans.get(PREDICT) and not spans.get(METRICS):
        return None
    spent_ns = sum(b - a for name in (PREDICT, METRICS)
                   for a, b in spans.get(name, []))
    return 100.0 * spent_ns / 1e9 / ctx.trace.window_s
