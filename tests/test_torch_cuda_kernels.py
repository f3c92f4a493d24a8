"""CUDA kernels of the torch port against their plain torch versions, on
the card.  Every test here needs a CUDA card and skips without one.

This file imports torch and numpy only, so it runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_cuda_kernels.py -q

Bars: max|kernel - plain| <= 1e-4 max|plain| + 1e-5 in every mode, for
the forward output and for dx and dW each against its own max.
'high'/'default' are FP32 on both sides and differ only in the summation
order.  'bf16' rounds at the same points on both sides, so it differs
the same way (the card measured <= 1.2e-6 absolute at the flagship
shapes); the bar leaves room for a tanh one f32 ulp apart that flips a
bf16 rounding.  A bf16 dx is the f32 sum rounded once more: where the two
f32 sums, taken in another order, straddle a bf16 rounding boundary, the
two dx differ by one bf16 step (2^-8 of the value).  So an element of a
bf16 dx past the bar must be exactly one bf16 step from the plain one,
and at most 1 in 1000 elements may be.  Control: where dp1 > 1, the
'bf16' output (forward) and dW (backward) must differ from 'high' on the
same x by more than the bar, so a kernel that skips the mode's rounding
fails; the v1 forward must differ from the degree-wise 'high' forward on
a bf16 x, since it rounds all of w2 to bf16.

The dW pass (``csrc/partial_sum.cu``) sums in the order of
``fixed_order_sum_reference`` with the card's segment count, every add an
f32 rounding on both sides: it must equal that version bit for bit, and
the one-call backward must give the bits of the backward followed by the
pass alone.
"""

import numpy as np
import pytest
import torch

from qkan_implementation_tpu_torch.ops.fused_layer import (
    _bwd_pass,
    _fused_bwd,
    _fused_dw_bwd,
    fused_bwd_fixed_order_reference,
    fused_bwd_partial_sum,
    fused_bwd_partial_sum_reference,
    kan_layer_fused,
    kan_layer_fused_bwd_reference,
    kan_layer_fused_dw,
    kan_layer_fused_dw_bwd_reference,
    kan_layer_fused_dw_reference,
    kan_layer_fused_reference,
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
    """Within the bar; a bf16 tensor may also sit one bf16 step away in
    at most 1 of 1000 elements (module docstring)."""
    err = (got.float() - want.float()).abs()
    over = err > _bar(want.float(), precision)
    if got.dtype == torch.bfloat16:
        steps = (got.view(torch.int16).int() - want.view(torch.int16).int())
        assert bool((~over | (steps.abs() == 1)).all()), float(err.max())
        assert int(over.sum()) <= max(1, over.numel() // 1000)
    else:
        assert not bool(over.any()), (float(err.max()),
                                      _bar(want, precision))


SHAPES = [
    (1, 784, 6, 10),
    (33, 10, 6, 10),  # ragged last row tile
    (1000, 37, 8, 17),  # ragged feature chunk, odd T
    (64, 5, 1, 3),  # dp1 = 1: colsum(W_0) only
    (40, 1, 2, 1),
    (96, 24, 16, 64),  # widest T the kernels take
    (129, 300, 32, 33),  # deepest dp1: smaller chunks, degree chunks
]


@pytest.mark.parametrize("b,n,dp1,t_dim", SHAPES)
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


@pytest.mark.parametrize("b,n,dp1,t_dim", SHAPES + [(4096, 784, 6, 10)])
@pytest.mark.parametrize("tanh", [True, False])
@pytest.mark.parametrize(
    "v1,precision",
    # the v1 pair has no 'bf16' mode (it raises, tested below)
    [(False, "high"), (False, "default"), (False, "bf16"), (True, "high"),
     (True, "default")],
    ids=["dw-high", "dw-default", "dw-bf16", "v1-high", "v1-default"],
)
def test_backward_kernels_match_plain(cuda, b, n, dp1, t_dim, precision,
                                      tanh, v1):
    bwd, ref = ((_fused_bwd, kan_layer_fused_bwd_reference) if v1
                else (_fused_dw_bwd, kan_layer_fused_dw_bwd_reference))
    for x_dtype in (torch.float32, torch.bfloat16):
        x, w2 = _inputs(b * n + dp1, b, n, dp1, t_dim, tanh, x_dtype, cuda)
        g = torch.from_numpy(
            np.random.default_rng(b + n).normal(size=(b, t_dim))
            .astype(np.float32)
        ).to(cuda)
        dx, dw = bwd(x, w2, g, dp1, tanh, precision)
        want_dx, want_dw = ref(x, w2, g, dp1, tanh, precision)
        torch.cuda.synchronize()
        assert dx.dtype == x_dtype and dx.shape == x.shape
        assert dw.dtype == torch.float32 and dw.shape == w2.shape
        _assert_close(dx, want_dx, precision)
        _assert_close(dw, want_dw, precision)
        # no dx asked: the same dW
        none, dw_only = bwd(x, w2, g, dp1, tanh, precision, want_dx=False)
        assert none is None and torch.equal(dw_only, dw)
        if precision == "bf16" and dp1 > 1:
            _, dw_high = bwd(x, w2, g, dp1, tanh, "high")
            gap = float((dw - dw_high).abs().max())
            assert gap > _bar(want_dw, precision), gap


@pytest.mark.parametrize("b,n,dp1,t_dim", SHAPES)
@pytest.mark.parametrize("precision", ["high", "default"])
@pytest.mark.parametrize("tanh", [True, False])
def test_v1_forward_kernel_matches_plain(cuda, b, n, dp1, t_dim, precision,
                                         tanh):
    for x_dtype in (torch.float32, torch.bfloat16):
        x, w2 = _inputs(b * n + dp1, b, n, dp1, t_dim, tanh, x_dtype, cuda)
        got = kan_layer_fused(x, w2, dp1, tanh, precision)
        want = kan_layer_fused_reference(x, w2, dp1, tanh, precision)
        torch.cuda.synchronize()
        assert got.shape == (b, t_dim) and got.dtype == torch.float32
        _assert_close(got, want, precision)
        if x_dtype == torch.bfloat16 and dp1 > 1:
            dw_high = kan_layer_fused_dw(x, w2, dp1, tanh, "high")
            gap = float((got - dw_high).abs().max())
            assert gap > _bar(want, precision), gap


@pytest.mark.parametrize("v1", [False, True], ids=["dw", "v1"])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_cuda_backward_matches_cpu_plain_backward(cuda, v1, x_dtype):
    """backward() through the wrapper on the card (kernels both ways)
    against the same call on the CPU (plain versions both ways)."""
    layer = kan_layer_fused if v1 else kan_layer_fused_dw
    x, w2 = _inputs(3, 300, 40, 6, 10, True, x_dtype, "cpu")
    g = torch.from_numpy(
        np.random.default_rng(4).normal(size=(300, 10)).astype(np.float32)
    )
    grads = {}
    for dev in ("cpu", cuda):
        xd = x.to(dev).detach().requires_grad_()
        wd = w2.to(dev).detach().requires_grad_()
        before = (layer.launches, layer.bwd_launches)
        layer(xd, wd, 6).backward(g.to(dev))
        torch.cuda.synchronize()
        grads[str(dev)] = (xd.grad.cpu(), wd.grad.cpu())
        moved = (layer.launches - before[0], layer.bwd_launches - before[1])
        assert moved == ((0, 0) if dev == "cpu" else (1, 1))
    for got, want in zip(grads["cuda"], grads["cpu"]):
        _assert_close(got, want, "high")


# the flagship's layer 0 at B = 4096 (26 row blocks) and 64 (2); SHAPES
# hold one row block (B = 1) and dW strides (dp1-1)*in*T of 4403 and 1,
# no multiple of 4
@pytest.mark.parametrize("b,n,dp1,t_dim",
                         SHAPES + [(4096, 784, 6, 10), (64, 784, 6, 10)])
def test_partial_sum_kernel_matches_plain(cuda, b, n, dp1, t_dim):
    x, w2 = _inputs(b + n, b, n, dp1, t_dim, True, torch.float32, cuda)
    g = torch.randn((b, t_dim), device=cuda)
    _, ws, _ = _bwd_pass("qkan_fused_dw_bwd", x, w2, g, dp1, True, (0,), True)
    got = fused_bwd_partial_sum(ws, b, n, dp1, t_dim)
    want = fused_bwd_partial_sum_reference(ws, b, n, dp1, t_dim)
    torch.cuda.synchronize()
    _assert_close(got, want, "high")
    # a fixed order: the same bits every time, those of the plain version
    # in the kernel's order
    assert torch.equal(fused_bwd_partial_sum(ws, b, n, dp1, t_dim), got)
    assert torch.equal(
        fused_bwd_fixed_order_reference(ws, b, n, dp1, t_dim), got)


@pytest.mark.parametrize("b,n,dp1,t_dim",
                         SHAPES + [(4096, 784, 6, 10), (64, 784, 6, 10)])
@pytest.mark.parametrize("v1", [False, True], ids=["dw", "v1"])
@pytest.mark.parametrize("want_dx", [True, False], ids=["dx", "no_dx"])
def test_one_call_backward_equals_backward_then_pass(cuda, b, n, dp1, t_dim,
                                                    v1, want_dx):
    entry, bwd = (("qkan_fused_bwd", _fused_bwd) if v1
                  else ("qkan_fused_dw_bwd", _fused_dw_bwd))
    extra = () if v1 else (0,)
    x, w2 = _inputs(b * 3 + n, b, n, dp1, t_dim, True, torch.float32, cuda)
    g = torch.randn((b, t_dim), device=cuda)
    dx, dw = bwd(x, w2, g, dp1, True, "high", want_dx=want_dx)
    dx2, ws, _ = _bwd_pass(entry, x, w2, g, dp1, True, extra, want_dx)
    dw2 = fused_bwd_partial_sum(ws, b, n, dp1, t_dim, want_dx)
    torch.cuda.synchronize()
    assert torch.equal(dw, dw2)
    assert (dx is None and dx2 is None) or torch.equal(dx, dx2)
    # dW owns its memory: keeping it keeps no workspace
    assert dw.untyped_storage().nbytes() == 4 * dw.numel()


def test_launch_counters_count_kernel_launches(cuda):
    x, w2 = _inputs(0, 8, 16, 3, 4, True, torch.float32, cuda)
    g = torch.ones((8, 4), device=cuda)
    for layer, bwd in ((kan_layer_fused_dw, _fused_dw_bwd),
                       (kan_layer_fused, _fused_bwd)):
        before = (layer.launches, layer.bwd_launches,
                  fused_bwd_partial_sum.launches)
        layer(x, w2, 3)
        layer(x, w2, 3, precision="default")
        bwd(x, w2, g, 3, True, "high")
        assert (layer.launches, layer.bwd_launches,
                fused_bwd_partial_sum.launches) == (
            before[0] + 2, before[1] + 1, before[2] + 1
        )
    before = kan_layer_fused_dw.launches
    kan_layer_fused_dw(x, w2, 3, precision="bf16")
    assert kan_layer_fused_dw.launches == before + 1


@pytest.mark.parametrize("b,dp1,t_dim,x_dtype,chunks", [
    (0, 6, 10, torch.float32, 0),  # an empty batch launches nothing
    (8, 6, 10, torch.float32, 1),  # the flagship: one tensor-core launch
    # f32 x: the tensor-core kernel, one launch (the CUDA-core kernel
    # took 2 degree chunks here)
    (8, 6, 16, torch.float32, 1),
    # 11 degrees at T 33: past the tensor-core kernel, one degree a chunk
    (8, 12, 33, torch.float32, 11),
    # bf16 x: the CUDA-core kernel, once per degree chunk
    (8, 6, 16, torch.bfloat16, 2),  # 4 degrees a chunk
    (8, 12, 33, torch.bfloat16, 11),  # one degree a chunk
], ids=["empty", "flagship", "t16", "t33", "t16_bf16", "t33_bf16"])
def test_launch_counters_move_once_per_launch(cuda, b, dp1, t_dim, x_dtype,
                                              chunks):
    """Counted where each kernel launches: the backward once per launch
    (one on the tensor cores, one per degree chunk on the CUDA cores),
    nothing at B = 0."""
    x, w2 = _inputs(1, b, 16, dp1, t_dim, True, x_dtype, cuda)
    g = torch.ones((b, t_dim), device=cuda)
    for layer, bwd in ((kan_layer_fused_dw, _fused_dw_bwd),
                       (kan_layer_fused, _fused_bwd)):
        before = (layer.launches, layer.bwd_launches)
        out = layer(x, w2, dp1)
        dx, dw = bwd(x, w2, g, dp1, True, "high")
        torch.cuda.synchronize()
        assert out.shape == (b, t_dim) and dx.shape == (b, 16)
        assert (layer.launches - before[0],
                layer.bwd_launches - before[1]) == (int(b > 0), chunks)
        if b == 0:
            assert not bool(dw.any())


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x, w2 = _inputs(0, 8, 16, 3, 4, True, torch.float32, cuda)
    g = torch.ones((8, 4), device=cuda)
    for bwd in (_fused_dw_bwd, _fused_bwd):
        with pytest.raises(ValueError, match="g must be"):
            bwd(x, w2, g[:, :3], 3, True, "high")
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            bwd(x.double(), w2, g, 3, True, "high")
    with pytest.raises(ValueError, match="'high' or 'default'"):
        kan_layer_fused(x, w2, 3, True, "bf16")
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        kan_layer_fused_dw(x.double(), w2, 3)
    with pytest.raises(ValueError, match="rows"):
        kan_layer_fused_dw(x, w2, 2)
    with pytest.raises(ValueError, match="contiguous"):
        kan_layer_fused_dw(x.t().contiguous().t(), w2, 3)
    with pytest.raises(ValueError, match="on"):
        kan_layer_fused_dw(x, w2.cpu(), 3)
    with pytest.raises(ValueError, match=">= 1"):
        kan_layer_fused_dw(x, torch.zeros(0, 4, device=cuda), 0)


# widths past one launch: T > 64 takes column tiles (forward) and slices
# of 64 (backward), dp1 > 32 degree chunks with the recurrence carried;
# these took a ValueError before the kernels took any width
WIDE = [
    (100, 24, 34, 96),   # two column tiles / slices, 33 degrees
    (37, 16, 40, 130),   # three slices, the last 2 columns wide
    (64, 784, 6, 65),    # the flagship's fan-in at one column past 64
    (300, 3, 33, 64),    # dp1 past 32 at one slice
]


@pytest.mark.parametrize("b,n,dp1,t_dim", WIDE)
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_wide_layers_match_plain_with_gradients(cuda, b, n, dp1, t_dim,
                                                 x_dtype):
    """Forward and backward of both layers against their plain versions
    (the bars above), twice with the same bits, through the wrappers'
    autograd Functions."""
    x, w2 = _inputs(b + n + dp1, b, n, dp1, t_dim, True, x_dtype, cuda)
    g = torch.from_numpy(np.random.default_rng(b).normal(size=(b, t_dim))
                         .astype(np.float32)).to(cuda)
    cases = [(kan_layer_fused_dw, kan_layer_fused_dw_reference,
              kan_layer_fused_dw_bwd_reference, "high"),
             (kan_layer_fused_dw, kan_layer_fused_dw_reference,
              kan_layer_fused_dw_bwd_reference, "bf16"),
             (kan_layer_fused, kan_layer_fused_reference,
              kan_layer_fused_bwd_reference, "high")]
    for layer, ref, ref_bwd, precision in cases:
        runs = []
        for _ in range(2):
            xl = x.clone().requires_grad_()
            wl = w2.clone().requires_grad_()
            out = layer(xl, wl, dp1, True, precision)
            out.backward(g)
            runs.append((out.detach(), xl.grad, wl.grad))
        torch.cuda.synchronize()
        assert all(torch.equal(a, c) for a, c in zip(*runs))
        out, dx, dw = runs[0]
        want_dx, want_dw = ref_bwd(x, w2, g, dp1, True, precision)
        _assert_close(out, ref(x, w2, dp1, True, precision), precision)
        _assert_close(dx, want_dx, precision)
        _assert_close(dw, want_dw, precision)


def test_plan_entries_equal_their_python_mirrors(cuda):
    """The forward's route and feature splits (and its workspace), the
    backward's route, feature chunk, row blocks, workspace, column slices
    and launches: each C entry equals the plain function the CPU tests
    reach, over a sweep of shapes, x dtypes and modes."""
    from qkan_implementation_tpu_torch.ops._cuda_build import load_library
    from qkan_implementation_tpu_torch.ops.fused_layer import (
        fused_bwd_launches, fused_bwd_plan, fused_col_slices, fused_fwd_plan)

    lib = load_library()
    for b in (1, 37, 64, 4096, 100000):
        for n in (1, 5, 10, 16, 17, 32, 33, 784):
            for dp1 in (1, 2, 6, 32, 33, 40):
                for t_dim in (1, 10, 32, 64, 65, 130):
                    tc, splits, _ = fused_fwd_plan(b, n, dp1, t_dim)
                    assert lib.qkan_fused_fwd_tensor_cores(
                        b, n, dp1, t_dim) == int(tc)
                    assert lib.qkan_fused_fwd_splits(b, n, dp1, t_dim) == \
                        splits
                    assert lib.qkan_fused_fwd_workspace_bytes(
                        b, n, dp1, t_dim) == (4 * splits * b * t_dim
                                              if splits > 1 else 0)
    for t_dim in (1, 4, 10, 33, 64, 65, 96, 130, 200):
        assert lib.qkan_fused_bwd_col_slices(t_dim) == \
            len(fused_col_slices(t_dim))
        for dp1 in (1, 2, 6, 12, 16, 33, 40, 100):
            for n in (1, 10, 16, 17, 784):
                for route in ((0, 0), (1, 0), (0, 1), (1, 1)):
                    assert lib.qkan_fused_bwd_launches(
                        n, dp1, t_dim, *route) == fused_bwd_launches(
                            n, dp1, t_dim, *route)
    for b in (1, 37, 64, 4096, 100000):
        for n in (1, 10, 16, 17, 32, 300, 784):
            for dp1 in (1, 2, 6, 8, 12, 16, 33):
                for t_dim in (1, 10, 16, 32, 33, 64, 65):
                    for route in ((0, 0), (1, 0), (0, 1)):
                        tc, fc, _, _, nrb = fused_bwd_plan(b, n, dp1, t_dim,
                                                           *route)
                        assert lib.qkan_fused_bwd_tensor_cores(
                            n, dp1, t_dim, *route) == int(tc)
                        assert lib.qkan_fused_bwd_feature_chunk(
                            n, dp1, t_dim, *route) == fc
                        assert lib.qkan_fused_bwd_row_blocks(
                            b, n, dp1, t_dim, *route) == nrb
                        # dW and colsum(g) partials, then the CUDA-core
                        # kernel's carried dt past one launch
                        dt = (b * n if fused_bwd_launches(
                            n, dp1, t_dim, *route) > 1 else 0)
                        assert lib.qkan_fused_bwd_workspace_bytes(
                            b, n, dp1, t_dim, 1, *route) == 4 * (
                                nrb * ((dp1 - 1) * n * t_dim + t_dim) + dt)


@pytest.mark.parametrize("n,t_dim", [(784, 10), (10, 10), (784, 32),
                                     (32, 16), (16, 16), (16, 10)])
@pytest.mark.parametrize("v1", [False, True], ids=["dw", "v1"])
def test_tensor_core_backward_dx_is_batch_invariant(cuda, n, t_dim, v1):
    """At every layer shape of the main path (f32 x, 'high'), the backward
    runs the tensor-core kernel; a row's dx has the same bits at B 37, 64
    and 4096 (the feature chunk and the mma order are functions of (in,
    dp1, T)), and two runs give the same bits of dx and dW."""
    from qkan_implementation_tpu_torch.ops.fused_layer import fused_bwd_plan

    for b in (37, 64, 4096):
        assert fused_bwd_plan(b, n, 6, t_dim)[0]
    bwd = _fused_bwd if v1 else _fused_dw_bwd
    x, w2 = _inputs(n + t_dim, 4096, n, 6, t_dim, True, torch.float32, cuda)
    g = torch.from_numpy(np.random.default_rng(n).normal(size=(4096, t_dim))
                         .astype(np.float32)).to(cuda)
    dxs = []
    for b in (37, 64, 4096):
        dx, dw = bwd(x[:b], w2, g[:b], 6, True, "high")
        dx2, dw2 = bwd(x[:b], w2, g[:b], 6, True, "high")
        torch.cuda.synchronize()
        assert torch.equal(dx, dx2) and torch.equal(dw, dw2)
        dxs.append(dx[:37])
    assert torch.equal(dxs[0], dxs[1]) and torch.equal(dxs[0], dxs[2])


def test_split_forward_counts_its_pass(cuda):
    """The flagship's layer 0 at B 64 splits its 784 features 49 ways:
    one forward launch and one launch of the fixed-order pass, in one
    library call; its narrow layers launch the forward alone."""
    for n, passes in ((784, 1), (10, 0)):
        x, w2 = _inputs(1, 64, n, 6, 10, True, torch.float32, cuda)
        for layer in (kan_layer_fused_dw, kan_layer_fused):
            before = (layer.launches, fused_bwd_partial_sum.launches)
            layer(x, w2, 6)
            assert (layer.launches - before[0],
                    fused_bwd_partial_sum.launches - before[1]) == (1, passes)
