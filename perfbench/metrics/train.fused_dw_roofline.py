"""The fused layer kernels' share of their roofline in a training step:
the frozen least time of the fused forward and backward calls of the
profiled epoch's steps (``counts.fused_step_bound_s``), over the device
time of the kernels that carry them (the degree-wise forward, backward
and fixed-order partial-sum kernels, by name)."""

from perfbench import counts

NAMES = ("fused_dw_fwd", "fused_dw_bwd", "partial_sum")


def read(ctx):
    spent = sum(b - a for name, a, b, _ in ctx.trace.kernels()
                if any(n in name for n in NAMES)) / 1e9
    if spent <= 0:
        return None
    cfg = ctx.cell.config
    dims = counts.fixed_kan_dims(cfg["network_shape"], cfg["classes"])
    bound = counts.fused_step_bound_s(dims, cfg["max_degree"],
                                      ctx.window["batch"])
    return 100.0 * bound * ctx.unit["steps"] / spent
