"""CUDA kernels of the torch port against their plain torch versions, on
the card.  Every test here needs a CUDA card and skips without one.

This file imports torch and numpy only, so it runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_cuda_kernels.py -q

Bars: max|kernel - plain| <= 1e-4 max|plain| + 1e-5 in every mode.
'high'/'default' are FP32 on both sides and differ only in the summation
order.  'bf16' rounds at the same points on both sides, so it differs
the same way (the card measured <= 1.2e-6 absolute at the flagship
shapes); the bar leaves room for a tanh one f32 ulp apart that flips a
bf16 rounding.  Control: where dp1 > 1, the 'bf16' output must differ
from the 'high' output on the same x by more than that bar, so a kernel
that skips the mode's rounding fails.
"""

import numpy as np
import pytest
import torch

from qkan_implementation_tpu_torch.ops.fused_layer import (
    kan_layer_fused_dw,
    kan_layer_fused_dw_reference,
)

pytestmark = pytest.mark.gpu

BARS = {"high": (1e-4, 1e-5), "default": (1e-4, 1e-5), "bf16": (1e-4, 1e-5)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(seed, b, n, dp1, t_dim, tanh, x_dtype, device):
    rng = np.random.default_rng(seed)
    lo, hi = (-2.0, 2.0) if tanh else (-0.95, 0.95)
    x = torch.from_numpy(rng.uniform(lo, hi, (b, n)).astype(np.float32))
    w2 = torch.from_numpy(
        rng.normal(0, 1 / np.sqrt(dp1 * n), (dp1 * n, t_dim))
        .astype(np.float32)
    )
    return x.to(device=device, dtype=x_dtype), w2.to(device)


def _bar(want, precision):
    rel, absl = BARS[precision]
    return rel * float(want.abs().max()) + absl


def _assert_close(got, want, precision):
    err = float((got - want).abs().max())
    assert err <= _bar(want, precision), (err, _bar(want, precision))


@pytest.mark.parametrize(
    "b,n,dp1,t_dim",
    [
        (1, 784, 6, 10),
        (33, 10, 6, 10),  # ragged last row tile
        (1000, 37, 8, 17),  # ragged feature chunk, odd T
        (64, 5, 1, 3),  # dp1 = 1: colsum(W_0) only
        (40, 1, 2, 1),
        (96, 24, 16, 64),  # widest T the kernel takes
        (129, 300, 32, 33),  # deepest dp1: smaller feature chunks
    ],
)
@pytest.mark.parametrize("precision", ["high", "default", "bf16"])
@pytest.mark.parametrize("tanh", [True, False])
def test_kernel_matches_plain(cuda, b, n, dp1, t_dim, precision, tanh):
    for x_dtype in (torch.float32, torch.bfloat16):
        x, w2 = _inputs(b * n + dp1, b, n, dp1, t_dim, tanh, x_dtype, cuda)
        got = kan_layer_fused_dw(x, w2, dp1, tanh, precision)
        want = kan_layer_fused_dw_reference(x, w2, dp1, tanh, precision)
        torch.cuda.synchronize()
        assert got.shape == (b, t_dim) and got.dtype == torch.float32
        _assert_close(got, want, precision)
        if precision == "bf16" and dp1 > 1:
            high = kan_layer_fused_dw(x, w2, dp1, tanh, "high")
            gap = float((got - high).abs().max())
            assert gap > _bar(want, precision), gap


def test_high_precision_refuses_tf32(cuda):
    from qkan_implementation_tpu_torch.models.fixed_kan import (
        kan_layer_apply,
    )

    rng = np.random.default_rng(0)
    lp = {
        "degrees": torch.tensor([1, 2], device=cuda),
        "coefficients": torch.from_numpy(
            rng.normal(size=(2, 3, 3, 4)).astype(np.float32)
        ).to(cuda),
        "horizontal_weights": torch.ones(2, device=cuda),
    }
    x = torch.zeros((5, 3), device=cuda)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="TF32"):
            kan_layer_apply(lp, x, 2, matmul_precision="high")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert kan_layer_apply(lp, x, 2, matmul_precision="high").shape == (5, 4)


def test_launch_counter_counts_kernel_launches(cuda):
    x, w2 = _inputs(0, 8, 16, 3, 4, True, torch.float32, cuda)
    before = kan_layer_fused_dw.launches
    kan_layer_fused_dw(x, w2, 3)
    kan_layer_fused_dw(x, w2, 3, precision="bf16")
    assert kan_layer_fused_dw.launches == before + 2


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x, w2 = _inputs(0, 8, 16, 3, 4, True, torch.float32, cuda)
    with pytest.raises(NotImplementedError, match="K2"):
        kan_layer_fused_dw(x.requires_grad_(), w2, 3)
    x = x.detach()
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        kan_layer_fused_dw(x.double(), w2, 3)
    with pytest.raises(ValueError, match="rows"):
        kan_layer_fused_dw(x, w2, 2)
    with pytest.raises(ValueError, match="contiguous"):
        kan_layer_fused_dw(x.t().contiguous().t(), w2, 3)
    with pytest.raises(ValueError, match="T <= 64"):
        kan_layer_fused_dw(x, torch.zeros(48, 65, device=cuda), 3)
    with pytest.raises(ValueError, match="on"):
        kan_layer_fused_dw(x, w2.cpu(), 3)
