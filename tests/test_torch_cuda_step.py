"""The fused train step's CUDA kernel (``qkan_fused_step`` and the
fixed-order dW pass) against its plain torch version, on the card.  Every
test here needs a CUDA card and skips without one.

This file imports torch and numpy only, so it runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_cuda_step.py -q

Bars: dW within 1e-4 max|plain dW| + 1e-5 (the bars of the other fused
kernels: FP32 on both sides, only the order of the sums differs; with a
bf16 x both sides round tanh, the recurrence and w2 at the same points),
the loss within rtol 1e-4.  The kernel sums in a fixed order and uses no
float atomics, so two runs on the same inputs give the same bits.
"""

import numpy as np
import pytest
import torch

from qkan_implementation_tpu_torch.ops.fused_layer import (
    fused_bwd_partial_sum,
    kan_train_step_fused,
    kan_train_step_fused_reference,
)

pytestmark = pytest.mark.gpu


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
    y = torch.from_numpy(rng.normal(size=(b, t_dim)).astype(np.float32))
    return x.to(device=device, dtype=x_dtype), w2.to(device), y.to(device)


def _assert_step_close(got, want):
    (loss, dw), (want_loss, want_dw) = got, want
    assert loss.shape == () and loss.dtype == torch.float32
    assert dw.shape == want_dw.shape and dw.dtype == torch.float32
    assert bool(torch.isfinite(dw).all()) and bool(torch.isfinite(loss))
    err = float((dw - want_dw).abs().max())
    bar = 1e-4 * float(want_dw.abs().max()) + 1e-5
    assert err <= bar, (err, bar)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-4)


@pytest.mark.parametrize("b", [1, 37, 64, 4096])
@pytest.mark.parametrize("n", [10, 16, 784])
@pytest.mark.parametrize("dp1", [1, 6, 8])
@pytest.mark.parametrize("t_dim", [10, 16, 64])
def test_step_kernel_matches_plain(cuda, b, n, dp1, t_dim):
    for loss in ("sumsq", "mse"):
        for tanh in (True, False):
            for x_dtype in (torch.float32, torch.bfloat16):
                x, w2, y = _inputs(b * n + dp1 + t_dim, b, n, dp1, t_dim,
                                   tanh, x_dtype, cuda)
                args = (x, w2, dp1, y if loss == "mse" else None, loss, tanh)
                got = kan_train_step_fused(*args)
                want = kan_train_step_fused_reference(*args)
                torch.cuda.synchronize()
                _assert_step_close(got, want)


@pytest.mark.parametrize("b,n,dp1,t_dim,tanh", [
    (262144, 16, 8, 16, False),  # the headline QKAN-layer step
    (4096, 784, 6, 10, True),    # the flagship's layer 0
    (129, 300, 32, 33, True),    # deepest dp1: one degree a chunk
    (1000, 1, 2, 1, False),
])
def test_step_kernel_main_shapes_and_same_bits(cuda, b, n, dp1, t_dim, tanh):
    x, w2, y = _inputs(7, b, n, dp1, t_dim, tanh, torch.float32, cuda)
    for loss in ("sumsq", "mse"):
        args = (x, w2, dp1, y if loss == "mse" else None, loss, tanh)
        got = kan_train_step_fused(*args)
        _assert_step_close(got, kan_train_step_fused_reference(*args))
        again = kan_train_step_fused(*args)
        assert all(torch.equal(a, c) for a, c in zip(got, again))


def test_step_counts_one_launch_a_call(cuda):
    x, w2, y = _inputs(0, 300, 16, 6, 10, True, torch.float32, cuda)
    before = (kan_train_step_fused.launches, fused_bwd_partial_sum.launches)
    kan_train_step_fused(x, w2, 6)
    kan_train_step_fused(x, w2, 6, y=y, loss="mse", tile_b=128)
    torch.cuda.synchronize()
    assert (kan_train_step_fused.launches - before[0],
            fused_bwd_partial_sum.launches - before[1]) == (2, 2)
    # the plain version launches nothing
    kan_train_step_fused_reference(x, w2, 6)
    assert kan_train_step_fused.launches - before[0] == 2


def test_sumsq_reads_no_targets(cuda):
    """'sumsq' passes the kernel a null y: targets given anyway change
    nothing."""
    x, w2, y = _inputs(1, 64, 16, 6, 10, True, torch.float32, cuda)
    got = kan_train_step_fused(x, w2, 6, y=y)
    want = kan_train_step_fused(x, w2, 6)
    assert all(torch.equal(a, c) for a, c in zip(got, want))


def test_step_rejects_what_the_kernel_does_not_take(cuda):
    x, w2, y = _inputs(0, 8, 16, 3, 4, True, torch.float32, cuda)
    with pytest.raises(ValueError, match="y must be"):
        kan_train_step_fused(x, w2, 3, y=y[:, :3], loss="mse")
    with pytest.raises(ValueError, match="y must be"):
        kan_train_step_fused(x, w2, 3, y=y.cpu(), loss="mse")
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        kan_train_step_fused(x.double(), w2, 3)
    with pytest.raises(ValueError, match="T <= 64"):
        kan_train_step_fused(x, torch.zeros(48, 65, device=cuda), 3)
    with pytest.raises(ValueError, match="rows"):
        kan_train_step_fused(x, w2, 2)
    with pytest.raises(ValueError, match="'high' or 'default'"):
        kan_train_step_fused(x, w2, 3, precision="bf16")
