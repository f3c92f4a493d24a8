"""Widths past one launch of a kernel: the fused layer at T > 64 and
dp1 > 32, the train step there, and the M3 layer past one block's shared
memory and at D+1 > 32.  The torch port's plain versions (which CPU
tensors take) against the JAX package in Pallas interpret mode, on the
same numpy inputs; the slice plans the CUDA entries launch over, against
their definitions; and the plain versions run slice by slice, combined
in the kernels' order, against the whole plain version.

Bars:
- against JAX: those of the existing parity tests.  Fused layer (as
  tests/test_torch_fused_layer.py): f32 rtol 1e-5 / atol 1e-6 on the
  outputs over max(1, their max), x drawn again where XLA's tanh and
  torch's differ.  Train step (tests/test_torch_fused_step.py): loss rtol
  1e-5, dW relative norm < 1e-5.  M3 (tests/test_torch_pallas_layer.py):
  forward atol 1e-5, dx atol 1e-4, dM atol 1e-5 over max(1, max).
- slice by slice against whole: the same f32 products, only the order of
  the sums across slices differs: 1e-5 of the whole's max (outputs of
  many terms, each f32-rounded).  Where a slice plan cuts nothing that
  crosses slices (dW and dM columns, out over K slices), the bits are
  the whole's.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from qkan_implementation_tpu.experimental import pallas_layer as jpl
from qkan_implementation_tpu.ops.fused_layer import (
    kan_layer_fused as jax_fused,
    kan_layer_fused_dw as jax_fused_dw,
    kan_train_step_fused as jax_step,
)
from qkan_implementation_tpu_torch.experimental import pallas_layer as tpl
from qkan_implementation_tpu_torch.ops import fused_layer as fl

WIDE = [(t_dim, dp1) for t_dim in (65, 130) for dp1 in (33, 40)]
B, N_IN = 12, 3


def _ids(case):
    return "T{}_dp1_{}".format(*case)


def _inputs(b, n, dp1, t_dim, seed, lo=-2.0, hi=2.0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(lo, hi, (b, n)).astype(np.float32)
    w2 = rng.normal(0, 1 / np.sqrt(dp1 * n), (dp1 * n, t_dim))
    g = rng.normal(0, 1, (b, t_dim)).astype(np.float32)
    return x, w2.astype(np.float32), g


def _tanh_agreeing(x, seed=0):
    """x drawn again, from its range, where XLA's tanh and torch's differ
    (tests/test_torch_fused_layer.py)."""
    x = x.copy()
    rng = np.random.default_rng(seed)
    for _ in range(200):
        bad = np.asarray(jnp.tanh(jnp.asarray(x))) != torch.tanh(
            torch.from_numpy(x)).numpy()
        if not bad.any():
            return x
        x[bad] = rng.uniform(-2, 2, int(bad.sum())).astype(np.float32)
    raise AssertionError("no tanh-agreeing inputs")


def _assert_bar(got, want):
    got = np.asarray(got, dtype=np.float32)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got / scale, want / scale, rtol=1e-5,
                               atol=1e-6)


def _jax_vjp(fn, x, w2, g):
    def both(xx, ww, gg):
        out, vjp = jax.vjp(fn, xx, ww)
        return (out,) + vjp(gg)

    args = (jnp.asarray(x), jnp.asarray(w2), jnp.asarray(g))
    comp = jax.jit(both).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})
    return [np.asarray(a.astype(jnp.float32)) for a in comp(*args)]


# -- the fused layer and the train step at T > 64, dp1 > 32 ------------------


@pytest.mark.parametrize("case", WIDE, ids=_ids)
@pytest.mark.parametrize("v1", [False, True], ids=["dw", "v1"])
def test_fused_layer_wide_matches_jax(case, v1):
    """kan_layer_fused_dw / kan_layer_fused forward and backward (through
    the wrapper's autograd Function, the hand-written backward)."""
    t_dim, dp1 = case
    x, w2, g = _inputs(B, N_IN, dp1, t_dim, seed=t_dim + dp1)
    x = _tanh_agreeing(x)
    jfn, tfn = ((jax_fused, fl.kan_layer_fused) if v1
                else (jax_fused_dw, fl.kan_layer_fused_dw))
    out, dx, dw = _jax_vjp(
        lambda xx, ww: jfn(xx, ww, dp1, True, True, "high"), x, w2, g)
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w2).requires_grad_()
    got = tfn(xt, wt, dp1, True, "high")
    got.backward(torch.from_numpy(g))
    assert got.shape == (B, t_dim) and wt.grad.shape == w2.shape
    _assert_bar(got.detach().numpy(), out)
    _assert_bar(xt.grad.numpy(), dx)
    _assert_bar(wt.grad.numpy(), dw)


@pytest.mark.parametrize("case", WIDE, ids=_ids)
@pytest.mark.parametrize("loss", ["sumsq", "mse"])
def test_train_step_wide_matches_jax(case, loss):
    t_dim, dp1 = case
    x, w2, y = _inputs(B, N_IN, dp1, t_dim, seed=3 * t_dim + dp1, lo=-1,
                       hi=1)
    yj = jnp.asarray(y) if loss == "mse" else None

    def step(xx, ww, yy):
        return jax_step(xx, ww, dp1, y=yy, loss=loss, interpret=True,
                        tile_b=B)

    jl, jdw = jax.jit(step)(jnp.asarray(x), jnp.asarray(w2), yj)
    got_l, got_dw = fl.kan_train_step_fused(
        torch.from_numpy(x), torch.from_numpy(w2), dp1,
        y=torch.from_numpy(y) if loss == "mse" else None, loss=loss)
    np.testing.assert_allclose(float(got_l), float(jl), rtol=1e-5)
    jdw = np.asarray(jdw, dtype=np.float64)
    rel = (np.linalg.norm(got_dw.numpy().astype(np.float64) - jdw)
           / np.linalg.norm(jdw))
    assert rel < 1e-5, rel


# -- the M3 layer past one block's shared memory, and at D+1 = 40 ------------


@pytest.mark.parametrize("dp1,n,k", [(8, 64, 128), (40, 4, 8)],
                         ids=["dp1_8_N64_K128", "dp1_40_N4_K8"])
def test_m3_layer_wide_matches_jax(dp1, n, k):
    rng = np.random.default_rng(dp1 + n + k)
    b = 10
    x = rng.uniform(-1, 1, (b, n)).astype(np.float32)
    m3 = rng.normal(0, 1 / np.sqrt(dp1 * n), (dp1, n, k)).astype(np.float32)
    g = rng.normal(size=(b, k)).astype(np.float32)

    def both(xx, mm, gg):
        out, vjp = jax.vjp(lambda a, c: jpl.qkan_layer_fused(a, c, True),
                           xx, mm)
        return (out, *vjp(gg))

    out, dx, dm = (np.asarray(a) for a in jax.jit(both)(
        jnp.asarray(x), jnp.asarray(m3), jnp.asarray(g)))
    xt = torch.from_numpy(x).requires_grad_()
    mt = torch.from_numpy(m3).requires_grad_()
    got = tpl.qkan_layer_fused(xt, mt)
    got.backward(torch.from_numpy(g))

    def close(a, want, atol):
        scale = max(1.0, float(np.abs(want).max()))
        assert float(np.abs(a.detach().numpy() - want).max()) <= atol * scale

    close(got, out, 1e-5)
    close(xt.grad, dx, 1e-4)
    close(mt.grad, dm, 1e-5)


# -- the slice plans ----------------------------------------------------------


def test_backward_column_slices_cover_t_in_order():
    for t_dim in (1, 10, 63, 64, 65, 96, 128, 130, 300):
        sl = fl.fused_col_slices(t_dim)
        assert sl[0][0] == 0 and sl[-1][1] == t_dim
        assert all(c1 - c0 <= 64 and c1 > c0 for c0, c1 in sl)
        assert all(a[1] == b[0] for a, b in zip(sl, sl[1:]))
    assert fl.fused_col_slices(130) == [(0, 64), (64, 128), (128, 130)]


@pytest.mark.parametrize("n,dp1,t_dim,x_bf16,want", [
    (16, 6, 10, False, 1),     # the flagship: one launch
    # an f32 x takes the tensor-core kernel, one launch, where the
    # CUDA-core kernel took 2 (4 degrees a chunk); a bf16 x keeps the
    # CUDA-core kernel and its counts
    (16, 6, 16, False, 1),
    (16, 6, 16, True, 2),      # 4 degrees a chunk
    # 11 degrees at T 33 (64 padded) pass what a warp's registers hold
    # (3): the CUDA-core kernel at either dtype, one degree a chunk
    (16, 12, 33, False, 11),
    (16, 12, 33, True, 11),
    (16, 40, 130, False, 81),  # 39 + 39 + 3: two slices of 64, one of 2
    (16, 1, 130, False, 3),    # dp1 = 1: one launch a slice (colsum(g) only)
    (64, 34, 96, False, 50),   # 33 at 64 columns + 17 at 32 (2 degrees a chunk)
], ids=["flagship", "t16", "t16_bf16", "t33", "t33_bf16", "t130", "dp1_1",
        "t96"])
def test_backward_launches_per_call(n, dp1, t_dim, x_bf16, want):
    assert fl.fused_bwd_launches(n, dp1, t_dim, x_bf16) == want


# (in, T) of chip_smoke.py's LAYER_SHAPES: the flagship checkpoint's
# layers and those of a [784, 32, 16, 16, 10] mapping to the next width
LAYER_SHAPES = [(784, 10), (10, 10), (784, 32), (32, 16), (16, 16), (16, 10)]


@pytest.mark.parametrize("n,t_dim", LAYER_SHAPES,
                         ids=[f"{n}to{t}" for n, t in LAYER_SHAPES])
@pytest.mark.parametrize("b", [64, 4096])
def test_backward_plan_takes_the_tensor_cores_at_the_main_shapes(n, t_dim,
                                                                 b):
    """Every layer of the main path, f32 x, 'high' / 'default': one
    tensor-core launch; its feature chunks cover [0, in) once, its row
    blocks cover B in whole 64-row tiles, its dW partials stay within 8 MB
    (or one row block), and about 264 blocks or fewer."""
    tc, fc, col_tiles, rows, nrb = fl.fused_bwd_plan(b, n, 6, t_dim)
    assert tc and col_tiles == 1 and fc == 16
    assert fl.fused_bwd_launches(n, 6, t_dim) == 1
    chunks = [(c, min(c + fc, n)) for c in range(0, -(-n // fc) * fc, fc)]
    assert chunks[0][0] == 0 and chunks[-1][1] == n
    assert all(a[1] == c[0] and a[0] < a[1] for a, c in zip(chunks,
                                                            chunks[1:]))
    assert rows % 64 == 0 and (nrb - 1) * rows < b <= nrb * rows
    assert nrb == 1 or nrb * 5 * n * t_dim * 4 <= 8 << 20
    assert nrb * len(chunks) <= 264 or nrb == 1


def test_backward_plan_chunk_is_a_function_of_the_sizes_alone():
    """The feature chunk (so a row's dx bits) does not depend on B; the
    route does not either; the row blocks do."""
    for n, t_dim in LAYER_SHAPES + [(37, 17), (300, 33), (24, 64)]:
        for dp1 in (2, 6, 8):
            plans = [fl.fused_bwd_plan(b, n, dp1, t_dim)
                     for b in (1, 37, 64, 65, 4096, 100000)]
            assert len({p[:3] for p in plans}) == 1
    # layer 0: 49 chunks of 16 features, 264 // 49 = 5 row blocks of 13
    # tiles at B 4096 (245 blocks), one tile at B 64 (49 blocks)
    assert fl.fused_bwd_plan(4096, 784, 6, 10) == (True, 16, 1, 832, 5)
    assert fl.fused_bwd_plan(64, 784, 6, 10) == (True, 16, 1, 64, 1)
    assert fl.fused_bwd_plan(4096, 10, 6, 10) == (True, 16, 1, 64, 64)


@pytest.mark.parametrize("b,n,dp1,t_dim,x_bf16,round_bf16", [
    (4096, 784, 6, 10, True, False),   # a bf16 x
    (4096, 784, 6, 10, False, True),   # 'bf16'
    (256, 64, 34, 96, False, False),   # chip_smoke.py's wide layer
    (64, 16, 1, 10, False, False),     # dp1 = 1: colsum(g) only
    (64, 16, 6, 65, False, False),     # T past one column tile
    (64, 300, 32, 33, False, False),   # dW past a block's registers
], ids=["bf16_x", "bf16_mode", "wide", "dp1_1", "t65", "dp1_32"])
def test_backward_plan_keeps_the_cuda_core_kernel_elsewhere(
        b, n, dp1, t_dim, x_bf16, round_bf16):
    """Shapes and modes the tile does not take keep the CUDA-core kernel,
    its column slices and its 4 MB layout."""
    plan = fl.fused_bwd_plan(b, n, dp1, t_dim, x_bf16, round_bf16)
    assert plan == (False, 0, len(fl.fused_col_slices(t_dim)),
                    *fl.fused_bwd_layout(b, n, dp1, t_dim))


def test_forward_plan_route_and_splits():
    # the narrow layers keep the CUDA-core kernel, one launch, no pass
    assert fl.fused_fwd_plan(4096, 10, 6, 10) == (False, 1, 0)
    assert fl.fused_fwd_plan(64, 16, 6, 16) == (False, 1, 0)
    # past its limits the tensor cores take them, whatever the width
    assert fl.fused_fwd_plan(64, 10, 33, 10)[0]
    assert fl.fused_fwd_plan(64, 10, 6, 65)[0]
    # the flagship's layer 0: S = 264 // row tiles, in chunks of 32
    # features; at B 64 those 25 chunks would cap S, so chunks of 16 (49)
    assert fl.fused_fwd_plan(64, 784, 6, 10) == (True, 49, 16)
    assert fl.fused_fwd_plan(4096, 784, 6, 32) == (True, 4, 32)
    assert fl.fused_fwd_plan(100000, 784, 6, 10) == (True, 1, 32)
    # column tiles count too: T 96 takes two tiles of 64
    assert fl.fused_fwd_plan(1024, 64, 34, 96) == (True, 4, 16)
    for b in (1, 63, 64, 65, 4096):
        for n in (17, 100, 784):
            tc, s, fc = fl.fused_fwd_plan(b, n, 6, 32)
            assert tc and fc in (16, 32) and 1 <= s <= -(-n // fc)


def test_step_column_slice():
    # one launch takes every shape the kernels took before (T <= 64,
    # dp1 <= 32)
    for n in (1, 10, 16, 784):
        for dp1 in (1, 2, 6, 32):
            for t_dim in (1, 10, 33, 64):
                assert fl.fused_step_col_slice(n, dp1, t_dim) == t_dim
    assert fl.fused_step_col_slice(16, 40, 130) == 64
    assert fl.fused_step_col_slice(784, 34, 96) == 64
    # staging 96 KB at a chunk of 8: at 64 columns dp1 <= 47, at 4 <= 759
    assert fl.fused_step_col_slice(16, 48, 64) == 32
    assert fl.fused_step_col_slice(16, 759, 64) == 4
    # past that a chunk of 1 feature still stages 10 columns (pad 12)
    assert fl.fused_step_col_slice(16, 800, 10) == 10
    assert fl.fused_step_col_slice(16, 7000, 10) == 0
    # the slices run the CUDA-core kernel: its staging sets their width,
    # even where the tensor cores would take a wider slice
    assert fl.fused_step_tensor_cores(1, 48, 64)
    assert fl.fused_step_col_slice(1, 48, 130) == 32


def test_m3_slices_fit_and_cut_nothing_that_fits():
    # the headline and the N16 K128 case: whole
    for kind in (0, 1, 2):
        assert tpl.m3_slices(16, 8, 16, kind) == (16, 16)
        assert tpl.m3_slices(16, 8, 128, kind) == (16, 128)
    # D+1 8, N 64, K 128: M3 is 256 KB; the forward and K13 slice K, K14
    # stages no M3
    assert tpl.m3_slices(64, 8, 128, 0) == (64, 96)
    assert tpl.m3_slices(64, 8, 128, 1) == (64, 96)
    assert tpl.m3_slices(64, 8, 128, 2) == (64, 128)
    # where 4 columns still overflow, N is halved
    nw, kw = tpl.m3_slices(2000, 8, 16, 0)
    assert kw == 4 and nw < 2000
    for n, dp1, k in ((64, 8, 128), (2000, 8, 16), (300, 40, 8), (16, 40, 16)):
        for kind in (0, 1, 2):
            nw, kw = tpl.m3_slices(n, dp1, k, kind)
            assert tpl._fits(nw, dp1, kw, kind)
            assert 1 <= nw <= n and 1 <= kw <= k


# -- slice by slice, combined in the kernels' order ----------------------------


def _close_whole(got, whole):
    err = float((got - whole).abs().max())
    assert err <= 1e-5 * float(whole.abs().max()), err


@pytest.mark.parametrize("v1", [False, True], ids=["dw", "v1"])
def test_backward_by_column_slices_matches_whole(v1):
    """dW by slices is the whole's dW; dx by slices added in slice order
    (the kernels carry it in f32 across launches) within f32 rounding."""
    b, n, dp1, t_dim = 20, 5, 7, 130
    x, w2, g = (torch.from_numpy(a) for a in _inputs(b, n, dp1, t_dim, 1))
    ref = (fl.kan_layer_fused_bwd_reference if v1
           else fl.kan_layer_fused_dw_bwd_reference)
    dx_whole, dw_whole = ref(x, w2, g, dp1)
    dx, dw = None, torch.empty_like(dw_whole)
    for c0, c1 in fl.fused_col_slices(t_dim):
        dx_s, dw_s = ref(x, w2[:, c0:c1].contiguous(),
                         g[:, c0:c1].contiguous(), dp1)
        dw[:, c0:c1] = dw_s
        dx = dx_s if dx is None else dx + dx_s
    assert torch.equal(dw, dw_whole)
    _close_whole(dx, dx_whole)


@pytest.mark.parametrize("loss", ["sumsq", "mse"])
def test_train_step_by_column_slices_matches_whole(loss):
    """The slices' dW are the whole's columns; the losses, each scaled by
    1 / (B T) of the whole T for 'mse', add in slice order."""
    b, n, dp1, t_dim = 16, 4, 40, 130
    x, w2, y = (torch.from_numpy(a) for a in _inputs(b, n, dp1, t_dim, 2,
                                                     -1, 1))
    width = fl.fused_step_col_slice(n, dp1, t_dim)
    assert width == 64
    l_whole, dw_whole = fl.kan_train_step_fused_reference(x, w2, dp1, y, loss)
    total, dw = None, torch.empty_like(dw_whole)
    for c0 in range(0, t_dim, width):
        cols = slice(c0, min(c0 + width, t_dim))
        l_s, dw_s = fl.kan_train_step_fused_reference(
            x, w2[:, cols].contiguous(), dp1, y[:, cols].contiguous(), loss)
        if loss == "mse":  # the slice's own 1 / (B T_s), to the whole T's
            share = (cols.stop - cols.start) / t_dim
            l_s, dw_s = l_s * share, dw_s * share
        dw[:, cols] = dw_s
        total = l_s if total is None else total + l_s
    np.testing.assert_allclose(float(total), float(l_whole), rtol=1e-5)
    _close_whole(dw, dw_whole)


def test_forward_by_feature_splits_matches_whole():
    """The splits' partial outs, each colsum(W_0) of its features plus its
    products, added in the pass's order, within f32 rounding of the whole
    forward."""
    b, n, dp1, t_dim = 64, 784, 6, 10
    x, w2, _ = (torch.from_numpy(a) for a in _inputs(b, n, dp1, t_dim, 4))
    tc, splits, fc = fl.fused_fwd_plan(b, n, dp1, t_dim)
    assert tc and (splits, fc) == (49, 16)
    nfc = -(-n // fc)
    whole = fl.kan_layer_fused_dw_reference(x, w2, dp1)
    parts = []
    for s in range(splits):
        lo, hi = s * nfc // splits * fc, min((s + 1) * nfc // splits * fc, n)
        idx = torch.cat([torch.arange(lo, hi) + d * n for d in range(dp1)])
        parts.append(fl.kan_layer_fused_dw_reference(
            x[:, lo:hi].contiguous(), w2[idx].contiguous(), dp1))
    got = fl.fixed_order_sum_reference(
        torch.stack(parts), fl.partial_sum_segments(splits, b * t_dim))
    _close_whole(got, whole)


def test_m3_by_slices_matches_whole():
    """out over K slices and dM over K and N slices are disjoint: the
    whole's bits; out over N slices and dx over K slices add in slice
    order, within f32 rounding."""
    b, n, k, dp1 = 24, 12, 40, 5
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.uniform(-1, 1, (b, n)).astype(np.float32))
    m3 = torch.from_numpy(rng.normal(0, 0.2, (dp1, n, k)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(b, k)).astype(np.float32))
    out_whole = tpl.qkan_layer_fused_reference(x, m3)
    dx_whole, dm_whole = tpl.qkan_layer_fused_bwd_reference(x, m3, g)
    nw, kw = 5, 16
    out = torch.zeros_like(out_whole)
    dx = torch.zeros_like(dx_whole)
    dm = torch.empty_like(dm_whole)
    for n0 in range(0, n, nw):
        ns = slice(n0, min(n0 + nw, n))
        for k0 in range(0, k, kw):
            ks = slice(k0, min(k0 + kw, k))
            m3s = m3[:, ns, ks].contiguous()
            out[:, ks] += tpl.qkan_layer_fused_reference(
                x[:, ns].contiguous(), m3s)
            dx_s, dm_s = tpl.qkan_layer_fused_bwd_reference(
                x[:, ns].contiguous(), m3s, g[:, ks].contiguous())
            dx[:, ns] += dx_s
            dm[:, ns, ks] = dm_s
    assert torch.equal(dm, dm_whole)
    _close_whole(out, out_whole)
    _close_whole(dx, dx_whole)
