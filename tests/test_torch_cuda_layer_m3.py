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
same inputs give the same bits.  The dM pass (``csrc/partial_sum.cu``)
sums in the order of ``fixed_order_sum_reference`` with the card's segment
count, every add an f32 rounding on both sides: it equals that version bit
for bit, and the one-call backward gives the bits of the backward followed
by the pass alone.
"""

import numpy as np
import pytest
import torch

from qkan_implementation_tpu_torch.experimental import pallas_layer as pl
from qkan_implementation_tpu_torch.ops.fused_layer import (
    fixed_order_sum_reference,
    partial_sum_segments,
)
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
    _, part, _ = pl._bwd_pass(x, m3, g, False)
    assert part.shape[0] > 1
    got = m3_dm_partial_sum(part)
    _held(got, m3_dm_partial_sum_reference(part))
    segments = partial_sum_segments(part.shape[0], got.numel())
    assert torch.equal(got, fixed_order_sum_reference(part, segments))


@pytest.mark.parametrize("nblk,per", [
    (256, 2048),   # the headline's partials [256, 8, 16, 16]
    (264, 2048),   # MAX_BLOCKS partials of 8 x 16 x 16
    (16, 16384),   # N16 K128 at B 4096
    (547, 1792),   # as many partials as the K5 headline workspace
    (1, 2048),     # one block
    (5, 1001),     # per no multiple of 4: scalar loads, a ragged unit
    (33, 3),
])
def test_dm_pass_equals_fixed_order_reference(cuda, nblk, per):
    rng = np.random.default_rng(nblk + per)
    part = torch.from_numpy(
        rng.normal(size=(nblk, per)).astype(np.float32)).to(cuda)
    segments = partial_sum_segments(nblk, per)
    assert 1 <= segments <= min(nblk, 32)
    got = m3_dm_partial_sum(part)
    again = m3_dm_partial_sum(part)
    torch.cuda.synchronize()
    assert torch.equal(got, fixed_order_sum_reference(part, segments))
    assert torch.equal(got, again)
    _held(got, m3_dm_partial_sum_reference(part))


@pytest.mark.parametrize("b,n,k,dp1", [
    (262144, 16, 16, 8), (4096, 16, 128, 8), (37, 4, 3, 6), (1, 16, 16, 2),
])
@pytest.mark.parametrize("want_dx", [True, False], ids=["k13", "k14"])
def test_one_call_backward_equals_backward_then_pass(cuda, b, n, k, dp1,
                                                    want_dx):
    x, m3, g = _inputs(b + k, b, n, k, dp1, torch.float32, cuda)
    dx, dm = pl._launch_bwd(x, m3, g, want_dx)
    dx2, part, _ = pl._bwd_pass(x, m3, g, want_dx)
    dm2 = m3_dm_partial_sum(part)
    torch.cuda.synchronize()
    assert torch.equal(dm, dm2)
    assert (dx is None and dx2 is None) or torch.equal(dx, dx2)
    # dM owns its memory: keeping it keeps no partials
    assert dm.untyped_storage().nbytes() == 4 * dm.numel()


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
    with pytest.raises(ValueError, match="g must be"):
        pl._launch_bwd(x, m3, g[:, :15], True)


# M3s that took a ValueError before the kernels ran over slices of M3:
# D+1 past 32, and M3s past a block's shared memory (K12 and K13 stage
# M3; K14 stages none and takes them whole)
WIDE = [
    (40, 64, 128, 8),    # 256 KB of M3: K columns in slices
    (33, 16, 16, 40),    # D+1 40
    (50, 16, 16, 33),
    (8, 64, 256, 32),    # 2 MB of M3
    (20, 300, 8, 40),    # columns, then features in slices
    (16, 2000, 4, 8),    # 4 columns still overflow: features in slices
]


@pytest.mark.parametrize("b,n,k,dp1", WIDE)
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_wide_m3_matches_plain_and_repeats_bits(cuda, b, n, k, dp1, x_dtype):
    """K12, K13 and K14 over their slices of M3 against the plain versions,
    gradients included, twice with the same bits; one launch a slice."""
    x, m3, g = _inputs(b + n + k + dp1, b, n, k, dp1, x_dtype, cuda)
    before = _counts()
    out = qkan_layer_fused(x, m3)
    dx, dm = pl._launch_bwd(x, m3, g, True)
    _, dm_only = pl._launch_bwd(x, m3, g, False)
    again = (qkan_layer_fused(x, m3), *pl._launch_bwd(x, m3, g, True),
             pl._launch_bwd(x, m3, g, False)[1])
    want_dx, want_dm = qkan_layer_fused_bwd_reference(x, m3, g, True)
    torch.cuda.synchronize()
    _held(out, qkan_layer_fused_reference(x, m3))
    _held(dx, want_dx)
    _held(dm, want_dm)
    _held(dm_only, want_dm)
    for a, c in zip((out, dx, dm, dm_only), again):
        assert torch.equal(a, c)
    launches = [int(np.prod([-(-full // w) for full, w in
                             zip((n, k), pl.m3_slices(n, dp1, k, kind))]))
                for kind in (0, 1, 2)]
    assert _delta(before)[:3] == (2 * launches[0], 2 * launches[1],
                                  2 * launches[2])


def test_slice_entries_equal_their_python_mirrors(cuda):
    """The slices each M3 entry launches over, its launches and carry, and
    the shared memory at its slice, equal the plain functions."""
    from qkan_implementation_tpu_torch.ops._cuda_build import load_library

    lib = load_library()
    for n in (1, 3, 16, 64, 300, 2000):
        for dp1 in (1, 2, 8, 32, 33, 40, 100):
            for k in (1, 3, 16, 100, 128, 256):
                for kind in (0, 1, 2):
                    nw, kw = pl.m3_slices(n, dp1, k, kind)
                    assert (lib.qkan_m3_slice_n(n, dp1, k, kind),
                            lib.qkan_m3_slice_k(n, dp1, k, kind)) == (nw, kw)
                    assert lib.qkan_m3_launches(n, dp1, k, kind) == \
                        -(-n // nw) * -(-k // kw)
                    assert lib.qkan_m3_smem_bytes(n, dp1, k, kind) <= \
                        lib.qkan_m3_smem_limit()
                    carry = (4 * 7 * k if kind == 0 and nw < n else
                             4 * 7 * n if kind == 1 and kw < k else 0)
                    assert lib.qkan_m3_carry_bytes(7, n, dp1, k, kind) == \
                        carry


# -- the tensor-core route (csrc/qkan_layer_m3_tc.cu) -------------------------


def test_tc_plan_entry_equals_its_python_mirror(cuda):
    """``qkan_m3_tc_plan`` (the route and tiling each call takes) and
    ``qkan_m3_bwd_blocks`` (the backward's block layout, the same on both
    routes) equal their plain mirrors over a grid of sizes."""
    from qkan_implementation_tpu_torch.ops._cuda_build import load_library

    lib = load_library()
    for n in (1, 3, 8, 16, 40, 64, 300):
        for dp1 in (1, 2, 8, 12, 32, 40):
            for k in (1, 2, 16, 50, 64, 80, 128, 144, 256):
                for kind in (0, 1, 2):
                    for x_bf16 in (False, True):
                        assert pl.library_m3_tc_plan(n, dp1, k, kind,
                                                     x_bf16) == \
                            pl.m3_tc_plan(n, dp1, k, kind, x_bf16)
                for want_dx in (False, True):
                    for b in (1, 37, 4096, 262144):
                        assert lib.qkan_m3_bwd_blocks(b, n, dp1, k,
                                                      int(want_dx)) == \
                            pl.m3_bwd_layout(b, n, dp1, k, want_dx)[2]


def _kernel_names(fn) -> set:
    """The device kernels ``fn`` launches, from torch.profiler.  A window
    in which the profiler saw no device event is taken again, up to three
    times, as chip_smoke.py's ``device_per_call`` does."""
    from torch.profiler import ProfilerActivity, profile

    names = set()
    for _ in range(3):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
        names = {ev.key for ev in prof.key_averages()
                 if ev.device_type == torch.autograd.DeviceType.CUDA}
        if names:
            break
    return names


@pytest.mark.parametrize("b,n,k,dp1,x_dtype", [
    (4096, 16, 16, 8, torch.float32),    # the headline layer's widths
    (4096, 16, 128, 8, torch.float32),   # N16 K128
    (37, 3, 2, 2, torch.float32),
    (300, 40, 50, 12, torch.float32),    # K12's M3 fragments overflow
    (300, 16, 144, 8, torch.float32),    # K13: 9 column groups, refused
    (4096, 16, 16, 8, torch.bfloat16),   # a bf16 x
])
def test_each_call_runs_the_route_of_its_plan(cuda, b, n, k, dp1, x_dtype):
    """K12, K13 and K14 launch the tensor-core kernels where
    ``m3_tc_plan`` takes the call and the CUDA-core kernels elsewhere."""
    x, m3, g = _inputs(b + k, b, n, k, dp1, x_dtype, cuda)
    bf16 = x_dtype == torch.bfloat16
    tc_names = ("m3_fwd_kernel_tc", "m3_bwd_kernel_tc", "m3_bwd_dw_kernel_tc")
    for kind, fn in ((0, lambda: qkan_layer_fused(x, m3)),
                     (1, lambda: pl._bwd_pass(x, m3, g, True)),
                     (2, lambda: pl._bwd_pass(x, m3, g, False))):
        names = " ".join(_kernel_names(fn))
        tc = pl.m3_tc_plan(n, dp1, k, kind, bf16).ok
        old_name = "m3_fwd_kernel<" if kind == 0 else "m3_bwd_kernel<"
        assert (tc_names[kind] in names) == tc, names
        assert all(other not in names for i, other in enumerate(tc_names)
                   if i != kind), names
        assert (old_name in names) == (not tc), names


@pytest.mark.parametrize("n,k", [(16, 16), (16, 128), (3, 2), (40, 50)])
def test_out_rows_are_bit_equal_across_batch(cuda, n, k):
    """A row of out has the same bits at every B on both routes: K12's
    tensor-core warps compute each row from its own x and the plan alone."""
    x, m3, _ = _inputs(5, 4096, n, k, 8, torch.float32, cuda)
    full = qkan_layer_fused(x, m3)
    for b in (1, 37, 100):
        part = qkan_layer_fused(x[:b].contiguous(), m3)
        torch.cuda.synchronize()
        assert torch.equal(part, full[:b])


# shapes where K13 and K14 both take the tensor cores in the same block
# layout (where K13's CUDA-core tile is narrower, as at N 40 / K 50 / dp1
# 12, its blocks hold fewer rows and its partials are another fixed sum):
# the headline, N16 K128 (8 warps a feature group), the parity widths, 31
# degrees (4 degree groups), 2 x 2 groups over 2 row splits, 4 column
# groups (two feature groups a block, one in the last) and 4 x 2 groups
SAME_LAYOUT = [(262144, 16, 16, 8), (4096, 16, 128, 8), (37, 3, 2, 1),
               (100, 4, 3, 6), (4096, 8, 8, 2), (5000, 1, 1, 32),
               (3000, 8, 32, 12), (3000, 40, 50, 8), (3000, 24, 50, 12)]


@pytest.mark.parametrize("b,n,k,dp1", SAME_LAYOUT)
def test_k13_dm_partials_are_k14s_bits(cuda, b, n, k, dp1):
    """On the tensor cores K13 runs K14's warps for dM: where the two
    block layouts agree its partials are K14's bit for bit, and its dx is
    within the bar of the plain version."""
    assert pl.m3_tc_plan(n, dp1, k, 1).ok and pl.m3_tc_plan(n, dp1, k, 2).ok
    assert pl.m3_bwd_layout(b, n, dp1, k, True) == \
        pl.m3_bwd_layout(b, n, dp1, k, False)
    x, m3, g = _inputs(b + dp1, b, n, k, dp1, torch.float32, cuda)
    dx, part13, _ = pl._bwd_pass(x, m3, g, True)
    _, part14, _ = pl._bwd_pass(x, m3, g, False)
    torch.cuda.synchronize()
    assert torch.equal(part13, part14)
    _held(dx, qkan_layer_fused_bwd_reference(x, m3, g, True)[0])


@pytest.mark.parametrize("n,k,dp1", [(16, 16, 8), (16, 128, 8), (3, 2, 2),
                                     (1, 1, 32), (8, 32, 12), (40, 50, 12)])
def test_dx_rows_are_bit_equal_across_batch(cuda, n, k, dp1):
    """A row of K13's dx has the same bits at every B: its warps compute
    it from the row's x and g, M3 and the plan alone (rows 0-36 at B 37,
    4096 and 262144)."""
    x, m3, g = _inputs(9, 262144, n, k, dp1, torch.float32, cuda)
    full = pl._bwd_pass(x, m3, g, True)[0]
    for b in (37, 4096):
        dx = pl._bwd_pass(x[:b].contiguous(), m3, g[:b].contiguous(),
                          True)[0]
        torch.cuda.synchronize()
        assert torch.equal(dx[:37], full[:37]), b
