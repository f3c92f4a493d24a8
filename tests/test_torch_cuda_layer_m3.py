"""The batched QKAN layer's CUDA kernels (``csrc/qkan_layer_m3.cu``: K12
forward, K13 backward with dx, K14 weight-only backward, and the
fixed-order dM pass) against their plain torch versions, on the card.
Every test here needs a CUDA card and skips without one.

This file imports torch and numpy only, so it runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_cuda_layer_m3.py -q

Bars: max|kernel - plain| <= 1e-4 max|plain| + 1e-5 (FP32 products and
sums on both sides, only their order differs; a bf16 x rounds the
recurrences at the same points on both).  out and dx of a bf16 x are the
f32 sum rounded to bf16 once, so where the two sums straddle a rounding
boundary an element may sit one bf16 step off: at most 1 in 1000.  The
kernels sum in a fixed order with no float atomics, so two runs on the
same inputs give the same bits.
"""

import numpy as np
import pytest
import torch

from qkan_implementation_tpu_torch.experimental import pallas_layer as pl
from qkan_implementation_tpu_torch.experimental.pallas_layer import (
    m3_dm_partial_sum,
    m3_dm_partial_sum_reference,
    qkan_layer_forward_batched_fused,
    qkan_layer_fused,
    qkan_layer_fused_bwd_reference,
    qkan_layer_fused_dw,
    qkan_layer_fused_reference,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(seed, b, n, k, dp1, x_dtype, device, lo=-1.0, hi=1.0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.uniform(lo, hi, (b, n)).astype(np.float32))
    m3 = torch.from_numpy(
        rng.normal(0, 1 / np.sqrt(dp1 * n), (dp1, n, k)).astype(np.float32)
    )
    g = torch.from_numpy(rng.normal(size=(b, k)).astype(np.float32))
    return (x.to(device, x_dtype), m3.to(device),
            g.to(device, x_dtype))


def _held(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    assert bool(torch.isfinite(got).all())
    if got.numel() == 0:
        return
    err = (got.float() - want.float()).abs()
    bar = 1e-4 * float(want.float().abs().max()) + 1e-5
    over = err > bar
    if got.dtype == torch.bfloat16 and bool(over.any()):
        steps = (got.view(torch.int16).int() - want.view(torch.int16).int())
        assert bool((steps.abs()[over] == 1).all())
        assert int(over.sum()) <= max(1, over.numel() // 1000)
        err = err.masked_fill(over, 0.0)
    assert float(err.max()) <= bar, (float(err.max()), bar)


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("dp1", [1, 2, 6, 8])
@pytest.mark.parametrize("n,k", [(3, 2), (4, 3), (8, 8), (16, 16), (16, 128)])
@pytest.mark.parametrize("b", [0, 1, 37, 100, 4096])
def test_kernels_match_plain_and_repeat_bits(cuda, b, n, k, dp1, x_dtype):
    x, m3, g = _inputs(b * 7 + n * k + dp1, b, n, k, dp1, x_dtype, cuda)
    out = qkan_layer_fused(x, m3)
    dx, dm = pl._launch_bwd(x, m3, g, True)
    none_dx, dm_only = pl._launch_bwd(x, m3, g, False)
    again = (qkan_layer_fused(x, m3), *pl._launch_bwd(x, m3, g, True),
             pl._launch_bwd(x, m3, g, False)[1])
    want_dx, want_dm = qkan_layer_fused_bwd_reference(x, m3, g, True)
    torch.cuda.synchronize()
    assert out.dtype == dx.dtype == x_dtype and dm.dtype == torch.float32
    assert none_dx is None
    _held(out, qkan_layer_fused_reference(x, m3))
    _held(dx, want_dx)
    _held(dm, want_dm)
    _held(dm_only, want_dm)
    for a, c in zip((out, dx, dm, dm_only), again):
        assert torch.equal(a, c)


@pytest.mark.parametrize("b,n,k,dp1", [
    (262144, 16, 16, 8),  # the headline layer
    (4096, 16, 128, 8),   # the N16K128 variant
    (5000, 1, 1, 32),     # deepest dp1, four degree chunks
    (3000, 40, 50, 12),   # two passes of items, K past one chunk of 32
])
def test_main_shapes_and_unclipped_x(cuda, b, n, k, dp1):
    for lo, hi in ((-1.0, 1.0), (-2.0, 2.0)):
        x, m3, g = _inputs(b + n, b, n, k, dp1, torch.float32, cuda, lo, hi)
        want_dx, want_dm = qkan_layer_fused_bwd_reference(x, m3, g, True)
        dx, dm = pl._launch_bwd(x, m3, g, True)
        _held(qkan_layer_fused(x, m3), qkan_layer_fused_reference(x, m3))
        _held(dx, want_dx)
        _held(dm, want_dm)
        _held(pl._launch_bwd(x, m3, g, False)[1], want_dm)


def test_dm_pass_matches_plain(cuda):
    x, m3, g = _inputs(3, 20000, 16, 16, 8, torch.float32, cuda)
    _, part = pl._bwd_pass(x, m3, g, False)
    assert part.shape[0] > 1
    _held(m3_dm_partial_sum(part), m3_dm_partial_sum_reference(part))


def _counts():
    return (qkan_layer_fused.launches, qkan_layer_fused.bwd_launches,
            qkan_layer_fused.bwd_dw_launches, m3_dm_partial_sum.launches)


def _delta(before):
    return tuple(a - c for a, c in zip(_counts(), before))


def test_counters_route_k13_and_k14(cuda):
    x, m3, _ = _inputs(0, 300, 16, 16, 8, torch.float32, cuda)
    leaf = m3.clone().requires_grad_()
    before = _counts()
    torch.sum(qkan_layer_fused(x, leaf) ** 2).backward()  # data x: K14
    assert _delta(before) == (1, 0, 1, 1)
    before = _counts()
    xg = x.clone().requires_grad_()
    torch.sum(qkan_layer_fused(xg, leaf) ** 2).backward()  # K13
    assert _delta(before) == (1, 1, 0, 1)
    before = _counts()
    xd = x.clone().requires_grad_()
    torch.sum(qkan_layer_fused_dw(xd, leaf) ** 2).backward()  # K14, zero dx
    assert _delta(before) == (1, 0, 1, 1)
    assert torch.equal(xd.grad, torch.zeros_like(x))
    assert xg.grad.shape == x.shape and bool(torch.any(xg.grad != 0))
    # the weights train through weights_to_m3
    w = torch.zeros(8, 256, device=cuda).uniform_(-1, 1).requires_grad_()
    before = _counts()
    torch.sum(qkan_layer_forward_batched_fused(x, w, 16, 16) ** 2).backward()
    assert _delta(before) == (1, 0, 1, 1) and bool(torch.any(w.grad != 0))
    # B = 0 launches nothing; the plain versions launch nothing
    before = _counts()
    x0 = torch.zeros(0, 16, device=cuda, requires_grad=True)
    dx0, dm0 = torch.autograd.grad(qkan_layer_fused(x0, leaf).sum(),
                                   [x0, leaf])
    assert dx0.shape == (0, 16) and torch.equal(dm0, torch.zeros_like(m3))
    qkan_layer_fused_reference(x, m3)
    assert _delta(before) == (0, 0, 0, 0)


def test_rejects_what_the_kernels_do_not_take(cuda):
    x, m3, g = _inputs(0, 8, 16, 16, 8, torch.float32, cuda)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        qkan_layer_fused(x.double(), m3)
    with pytest.raises(ValueError, match="m3 must be float32"):
        qkan_layer_fused(x, m3.double())
    with pytest.raises(ValueError, match="m3 must be float32"):
        pl._launch_bwd(x, m3.to(torch.bfloat16), g, False)
    with pytest.raises(ValueError, match="expected x"):
        qkan_layer_fused(x, m3[:, :15])
    with pytest.raises(ValueError, match="D\\+1 <= 32"):
        qkan_layer_fused(x, torch.zeros(33, 16, 16, device=cuda))
    with pytest.raises(ValueError, match="g must be"):
        pl._launch_bwd(x, m3, g[:, :15], True)
    # M3 [32, 64, 256] is 2 MB: over a block's shared memory for K12 and
    # K13, which stage it; K14 stages no M3 and takes it
    big = torch.zeros(32, 64, 256, device=cuda)
    xb = torch.zeros(8, 64, device=cuda)
    gb = torch.zeros(8, 256, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        qkan_layer_fused(xb, big)
    with pytest.raises(ValueError, match="shared memory"):
        pl._launch_bwd(xb, big, gb, True)
    _, dm = pl._launch_bwd(xb, big, gb, False)
    assert torch.equal(dm, torch.zeros_like(big))
