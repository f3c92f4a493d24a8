"""The fused train step's CUDA kernel (``qkan_fused_step`` and the
fixed-order dW pass) against its plain torch version, on the card.  Every
test here needs a CUDA card and skips without one.

This file imports torch and numpy only, so it runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_cuda_step.py -q

Bars: dW within 1e-4 max|plain dW| + 1e-5 (the bars of the other fused
kernels: FP32 on both sides, only the order of the sums differs; with a
bf16 x both sides round tanh, the recurrence and w2 at the same points),
the loss within rtol 1e-4 (the tensor-core kernel's 3xTF32 products
are within 2^-20 of an f32 product, well inside both).  The kernel sums
in a fixed order and uses no float atomics, so two runs on the same
inputs give the same bits.  The C entries that fix the row blocks equal
their plain Python mirrors, which the CPU tests reach.
"""

import numpy as np
import pytest
import torch

from qkan_implementation_tpu_torch.ops._cuda_build import load_library
from qkan_implementation_tpu_torch.ops.fused_layer import (
    _step_pass,
    fused_bwd_fixed_order_reference,
    fused_bwd_layout,
    fused_bwd_partial_sum,
    fused_step_col_slice,
    fused_step_layout,
    fused_step_tensor_cores,
    kan_train_step_fused,
    kan_train_step_fused_reference,
    partial_sum_segments,
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


@pytest.mark.parametrize("b,n,dp1,t_dim,tanh", [
    (262144, 16, 8, 16, False),  # the headline step: 256 row blocks
    (4096, 784, 6, 10, True),    # layer 0: 128 row blocks (CUDA cores)
    (37, 10, 6, 10, True),       # one row block; dW stride 500
    (1000, 37, 8, 17, True),     # dW stride 4403, no multiple of 4
    (300, 16, 1, 10, True),      # dp1 = 1: colsum(g) alone
])
def test_one_call_step_equals_step_then_pass(cuda, b, n, dp1, t_dim, tanh):
    """The step's one library call gives the bits of K5 followed by the
    dW pass alone, which equal the plain sum in the kernel's order."""
    x, w2, y = _inputs(11, b, n, dp1, t_dim, tanh, torch.float32, cuda)
    loss, dw = kan_train_step_fused(x, w2, dp1, y=y, loss="mse",
                                    apply_tanh=tanh)
    loss2, ws, _ = _step_pass(x, w2, dp1, y, "mse", tanh)
    dw2 = fused_bwd_partial_sum(ws, b, n, dp1, t_dim, step=True)
    torch.cuda.synchronize()
    assert torch.equal(loss, loss2) and torch.equal(dw, dw2)
    assert torch.equal(
        fused_bwd_fixed_order_reference(ws, b, n, dp1, t_dim, step=True), dw)
    # the outputs own their memory: keeping them keeps no workspace
    assert loss.untyped_storage().nbytes() == 4
    assert dw.untyped_storage().nbytes() == 4 * dw.numel()


def test_kept_losses_and_grads_do_not_keep_the_workspace(cuda):
    """A loop that keeps each step's loss and dW on the card grows by those
    alone: the headline step's workspace (256 row blocks, ≈ 1.8 MB) is
    freed after each call."""
    x, w2, y = _inputs(5, 262144, 16, 8, 16, False, torch.float32, cuda)
    kan_train_step_fused(x, w2, 8, y=y, loss="mse")  # the library is built
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(cuda)
    kept = [kan_train_step_fused(x, w2, 8, y=y, loss="mse") for _ in range(4)]
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated(cuda) - before
    # the caching allocator rounds each block up to 512 bytes
    per_step = 512 + -(-4 * kept[0][1].numel() // 512) * 512
    assert grown <= len(kept) * per_step, (grown, per_step)


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
    with pytest.raises(ValueError, match="rows"):
        kan_train_step_fused(x, w2, 2)
    with pytest.raises(ValueError, match="'high' or 'default'"):
        kan_train_step_fused(x, w2, 3, precision="bf16")


# phase 12a's shapes (chip_smoke.py): the headline; the flagship's layer 0
# at B 1, 37, 64 and 4096; T 10 and 16; a bf16 x; dp1 1 and 2; in 1
PHASE_12A = [
    (262144, 16, 8, 16, False, torch.float32),
    (262144, 16, 8, 16, False, torch.bfloat16),
    *[(b, 784, 6, 10, True, torch.float32) for b in (1, 37, 64, 4096)],
    (4096, 784, 6, 10, True, torch.bfloat16),
    (4096, 16, 6, 10, True, torch.float32),
    (37, 10, 6, 16, True, torch.float32),
    (4096, 784, 1, 10, True, torch.float32),
    (300, 16, 2, 10, True, torch.float32),
    (1000, 1, 2, 16, False, torch.float32),
    (1000, 1, 8, 10, True, torch.bfloat16),
]


@pytest.mark.parametrize("b,n,dp1,t_dim,tanh,x_dtype", PHASE_12A)
def test_step_kernel_at_phase_12a_shapes(cuda, b, n, dp1, t_dim, tanh,
                                         x_dtype):
    """K5 (the tensor-core kernel or the CUDA-core one, as the rule picks)
    against the plain version, twice with the same bits, and its dW equal
    bit for bit to the plain fixed-order sum over its own workspace."""
    x, w2, y = _inputs(b + n + dp1, b, n, dp1, t_dim, tanh, x_dtype, cuda)
    for loss in ("sumsq", "mse"):
        args = (x, w2, dp1, y if loss == "mse" else None, loss, tanh)
        got = kan_train_step_fused(*args)
        _assert_step_close(got, kan_train_step_fused_reference(*args))
        again = kan_train_step_fused(*args)
        assert all(torch.equal(a, c) for a, c in zip(got, again))
        _, ws, _ = _step_pass(*args)
        torch.cuda.synchronize()
        assert torch.equal(
            fused_bwd_fixed_order_reference(ws, b, n, dp1, t_dim, step=True),
            got[1])


# past one launch: column slices of 64 (T > 64), and at dp1 > 32 slices
# narrow enough for the CUDA-core kernel's staging; these took a
# ValueError before the step took any width
WIDE = [
    (100, 24, 34, 96, True),
    (37, 16, 40, 130, True),
    (64, 784, 6, 65, True),
    (50, 3, 40, 130, False),   # in 3: the tensor cores take no slice
    (20, 16, 800, 10, True),   # one launch at a chunk of one feature
]


@pytest.mark.parametrize("b,n,dp1,t_dim,tanh", WIDE)
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_wide_step_matches_plain(cuda, b, n, dp1, t_dim, tanh, x_dtype):
    """The sliced step against the plain whole step, both losses, twice
    with the same bits; one step launch a slice and one pass a call."""
    x, w2, y = _inputs(b + dp1 + t_dim, b, n, dp1, t_dim, tanh, x_dtype,
                       cuda)
    width = fused_step_col_slice(n, dp1, t_dim)
    slices = -(-t_dim // width)
    for loss in ("sumsq", "mse"):
        args = (x, w2, dp1, y if loss == "mse" else None, loss, tanh)
        before = (kan_train_step_fused.launches,
                  fused_bwd_partial_sum.launches)
        got = kan_train_step_fused(*args)
        assert (kan_train_step_fused.launches - before[0],
                fused_bwd_partial_sum.launches - before[1]) == (slices, 1)
        _assert_step_close(got, kan_train_step_fused_reference(*args))
        again = kan_train_step_fused(*args)
        torch.cuda.synchronize()
        assert all(torch.equal(a, c) for a, c in zip(got, again))


def test_layout_entries_equal_their_python_mirrors(cuda):
    """The C entries that fix K5's and K2's row blocks, the step's path,
    its workspace and the pass's segments equal the plain functions the
    CPU tests reach, over a sweep of shapes."""
    lib = load_library()
    for b in (1, 37, 64, 100, 4096, 262144):
        for n in (1, 10, 16, 37, 300, 784):
            for dp1 in (1, 2, 6, 8, 32):
                for t_dim in (1, 10, 16, 17, 33, 64):
                    tc, _, nrb = fused_step_layout(b, n, dp1, t_dim)
                    assert lib.qkan_fused_step_tensor_cores(
                        n, dp1, t_dim) == int(tc) == int(
                            fused_step_tensor_cores(n, dp1, t_dim))
                    assert lib.qkan_fused_step_row_blocks(
                        b, n, dp1, t_dim) == nrb
                    assert lib.qkan_fused_step_workspace_bytes(
                        b, n, dp1, t_dim) == 4 * nrb * (
                            (dp1 - 1) * n * t_dim + t_dim + 1)
                    # K2's CUDA-core route (a bf16 x) keeps layout()
                    assert lib.qkan_fused_bwd_row_blocks(
                        b, n, dp1, t_dim, 1, 0) == fused_bwd_layout(
                            b, n, dp1, t_dim)[1]
    for n in (1, 3, 10, 16, 784):
        for dp1 in (1, 2, 6, 33, 40, 100, 800, 7000):
            for t_dim in (1, 10, 64, 65, 96, 130):
                assert lib.qkan_fused_step_col_slice(n, dp1, t_dim) == \
                    fused_step_col_slice(n, dp1, t_dim)
    for nblk in (1, 2, 26, 32, 33, 256, 264, 547, 1000):
        for per in (0, 1, 3, 1792, 2048, 39200, 47040):
            assert lib.qkan_partial_sum_segments(nblk, per) == \
                partial_sum_segments(nblk, per)
