"""The training step's share of the chip's float32 peak: the step's model
FLOPs (``counts.step_model_flops``) over the step time of the measured
window times the 3xTF32 tensor-core rate."""

from perfbench import counts


def read(ctx):
    cfg = ctx.cell.config
    dims = counts.fixed_kan_dims(cfg["network_shape"], cfg["classes"])
    flops = counts.step_model_flops(dims, cfg["max_degree"],
                                    ctx.window["batch"])
    return 100.0 * flops / (ctx.window["step_s"] * counts.F32_TC_FLOP_PER_S)
