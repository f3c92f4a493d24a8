"""The frozen counts against figures worked out by hand, and against the
parameter shapes the program's structure search makes."""

import numpy as np
import torch

from perfbench import counts, data

SHAPE = [784, 32, 16, 16, 10]


def test_dims_follow_the_model():
    # every layer maps to the 10-column target: 784 -> 10, then 10 -> 10
    assert counts.fixed_kan_dims(SHAPE, 10) == [(784, 10)] + [(10, 10)] * 3


def test_model_flops_by_hand():
    dims = counts.fixed_kan_dims(SHAPE, 10)
    # layer 0: 2 * 64 * 784 * 6 * 10; layers 1-3: 2 * 64 * 10 * 6 * 10
    assert 2 * 64 * 784 * 6 * 10 == 6_021_120
    assert counts.forward_model_flops(dims, 5, 64) == 6_021_120 + 3 * 76_800
    # forward, every weight gradient, the input gradient of layers 1-3
    assert counts.step_model_flops(dims, 5, 64) == 12_733_440


def test_fused_counts_by_hand():
    # layer 0's forward at batch 64: x, w2 [6*784, 10], out
    b, f = counts.fused_fwd_counts(64, 784, 5, 10)
    assert b == 4 * (64 * 784 + 6 * 784 * 10 + 64 * 10)
    assert f == 2 * 64 * 784 * 5 * 10
    # its backward without dx: x, g read, dW written, one product
    b, f = counts.fused_bwd_counts(64, 784, 5, 10, want_dx=False)
    assert (b, f) == (4 * (64 * 784 + 6 * 784 * 10 + 64 * 10),
                      2 * 64 * 784 * 5 * 10)
    # with dx: x, g, w2 read, dx, dW written, two products
    b, f = counts.fused_bwd_counts(64, 10, 5, 10, want_dx=True)
    assert (b, f) == (4 * (2 * 640 + 2 * 600 + 640), 2 * 2 * 64 * 10 * 5 * 10)


def test_step_bound_is_bytes_bound_at_batch_64():
    dims = counts.fixed_kan_dims(SHAPE, 10)
    t = counts.fused_step_bound_s(dims, 5, 64)
    by_bytes = sum(
        counts.fused_fwd_counts(64, n, 5, c)[0]
        + counts.fused_bwd_counts(64, n, 5, c, i > 0)[0]
        for i, (n, c) in enumerate(dims)) / counts.HBM_BYTES_PER_S
    assert np.isclose(t, by_bytes)


def test_dims_match_the_programs_parameters():
    from qkan_implementation_tpu_torch.models.fixed_kan import (
        FixedKAN, FixedKANConfig,
    )

    x, labels = data.digits_784(1500, 3)
    y = torch.nn.functional.one_hot(torch.from_numpy(labels), 10).float()
    kan = FixedKAN(FixedKANConfig.preset("recommended", SHAPE, 5,
                                         complexity_weight=0.001),
                   device="cpu")
    kan.optimize(torch.from_numpy(x), y, solver="exact")
    got = [tuple(lp["coefficients"].shape) for lp in kan.params]
    want = [(o, n, 6, t) for o, (n, t) in
            zip(SHAPE[1:], counts.fixed_kan_dims(SHAPE, 10))]
    assert got == want
