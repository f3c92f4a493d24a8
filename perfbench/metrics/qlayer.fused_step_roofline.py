"""The fused train step's share of its roofline: the least time of one
step (``counts_qlayer.fused_step_bound_s``) times the traced epoch's
``qkan.qlayer.step`` spans, over the device time of the kernels that
carry the step (K5's, by ``fused_step`` in their names, and the
fixed-order dW pass, ``partial_sum``)."""

from perfbench import counts_qlayer

STEP = "qkan.qlayer.step"
NAMES = ("fused_step", "partial_sum")


def read(ctx):
    steps = len(ctx.trace.annotations.get(STEP, []))
    spent = sum(b - a for name, a, b, _ in ctx.trace.kernels()
                if any(n in name for n in NAMES)) / 1e9
    if not steps or spent <= 0:
        return None
    cfg = ctx.cell.config
    bound = counts_qlayer.fused_step_bound_s(
        ctx.window["batch"], cfg["N"], cfg["max_degree"], cfg["K"])
    return 100.0 * bound * steps / spent
