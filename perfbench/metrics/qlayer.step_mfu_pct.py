"""The layer's training step's share of the chip's float32 peak: the
step's model FLOPs (``counts_qlayer.step_model_flops``) over the step
time of the measured window times the 3xTF32 tensor-core rate."""

from perfbench import counts, counts_qlayer


def read(ctx):
    cfg = ctx.cell.config
    flops = counts_qlayer.step_model_flops(
        ctx.window["batch"], cfg["N"], cfg["max_degree"], cfg["K"])
    return 100.0 * flops / (ctx.window["step_s"] * counts.F32_TC_FLOP_PER_S)
