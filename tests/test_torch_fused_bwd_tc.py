"""The decomposition of the fused-layer backward's tensor-core kernel
(``csrc/fused_dw_bwd_tc.cu``), checked here where no kernel can run: a
plain torch mirror of what its blocks compute, against the port's plain
backward and the JAX package's ``kan_layer_fused_dw`` VJP in Pallas
interpret mode, on the same numpy inputs.

The mirror takes the kernel's plan (``fused_bwd_plan``: feature chunks,
row blocks of whole 64-row tiles) and, block by block and tile by tile,
builds the chunk's basis T_1..T_D (column (d-1)*fc + f), adds g^T @ basis
over each of the tile's 64 / fc row splits to that split's dW^T (the
splits added in order at the block's end), takes gm = g @ W_chunk^T and
forms dx = (1 - t^2) sum_d d U_{d-1}(t) gm_d; the chunk-0 blocks add
colsum(g) in four quarters of each tile's rows, each in row order, the
quarters added in order at the end.  Both
products are 3xTF32 as the tensor cores run them: hi is the operand with
its 13 low mantissa bits cleared, lo = v - hi (cleared the same way: the
tensor core reads it as TF32), and hi*hi + (lo*hi + hi*lo) in f32.  The
per-block partials are summed by ``fixed_order_sum_reference`` in the
pass's order (``partial_sum_segments``).

Bar: chip_smoke.py's BARS['high'], max|mirror - ref| <= 1e-4 max|ref| +
1e-5, for dx and dW each.  A 3xTF32 product is within about 2^-21 of the
f32 one relative to |a b| (the dropped lo*lo and lo's low bits), and the
sums run over at most 64 rows or T columns a tile in f32, as the plain
versions' do in another order: orders of magnitude inside the bar, which
a wrong index, degree, chunk edge or row block would not be.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qkan_implementation_tpu.ops.fused_layer import (
    kan_layer_fused_dw as jax_fused_dw,
)
from qkan_implementation_tpu_torch.ops import fused_layer as fl

BAR = (1e-4, 1e-5)  # chip_smoke.py's BARS['high']
DP1 = 6
ROWS = 64


def _tf32(v: torch.Tensor) -> torch.Tensor:
    """v with its 13 low mantissa bits cleared."""
    return (v.view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return ah @ bh + (al @ bh + ah @ bl)


def bwd_tc_mirror(x, w2, g, dp1, apply_tanh=True):
    """(dx, dW) as the tensor-core kernel's blocks compute them."""
    b, n = x.shape
    t_dim = w2.shape[1]
    d = dp1 - 1
    tc, fc, col_tiles, rows, nrb = fl.fused_bwd_plan(b, n, dp1, t_dim)
    assert tc and col_tiles == 1
    part = torch.zeros(nrb, d, n, t_dim)
    gpart = torch.zeros(nrb, t_dim)
    quarters = torch.zeros(nrb, 4, t_dim)
    dx = torch.full((b, n), float("nan"))
    for rb in range(nrb):
        r_begin, r_end = rb * rows, min(b, (rb + 1) * rows)
        for i0 in range(0, n, fc):
            width = min(fc, n - i0)
            # W_chunk [D*fc, T]: row (dd-1)*fc + f is W_dd[i0 + f], zeros
            # past in
            w_chunk = torch.zeros(d, fc, t_dim)
            for dd in range(1, dp1):
                w_chunk[dd - 1, :width] = w2[dd * n + i0:dd * n + i0 + width]
            w_chunk = w_chunk.view(d * fc, t_dim)
            splits = ROWS // fc
            acc = torch.zeros(splits, t_dim, d * fc)  # dW^T of each split
            for r0 in range(r_begin, r_end, ROWS):
                nr = min(ROWS, r_end - r0)
                xt = torch.zeros(ROWS, fc)
                xt[:nr, :width] = x[r0:r0 + nr, i0:i0 + width]
                gt = torch.zeros(ROWS, t_dim)
                gt[:nr] = g[r0:r0 + nr]
                t = torch.tanh(xt) if apply_tanh else xt
                cols, prev, cur = [], torch.ones_like(t), t
                for _ in range(d):
                    cols.append(cur)
                    prev, cur = cur, 2.0 * t * cur - prev
                basis = torch.cat(cols, dim=1)  # [64, D*fc]
                for s in range(splits):
                    rs = slice(s * fc, (s + 1) * fc)
                    acc[s] += _mm_3xtf32(gt[rs].T.contiguous(), basis[rs])
                if i0 == 0:  # colsum(g): rows 16 q .. +16, in order
                    for r in range(ROWS):
                        quarters[rb, r // 16] += gt[r]
                gm = _mm_3xtf32(gt, w_chunk.T.contiguous())  # [64, D*fc]
                u_m2, u_m1 = torch.zeros_like(t), torch.ones_like(t)
                dt = torch.zeros_like(t)
                for dd in range(1, dp1):
                    dt = dt + (float(dd) * u_m1) * gm[:, (dd - 1) * fc:
                                                        dd * fc]
                    u_m2, u_m1 = u_m1, 2.0 * t * u_m1 - u_m2
                dxt = (1.0 - t * t) * dt if apply_tanh else dt
                dx[r0:r0 + nr, i0:i0 + width] = dxt[:nr, :width]
            dwt = acc[0]
            for s in range(1, splits):
                dwt = dwt + acc[s]
            part[rb, :, i0:i0 + width] = dwt.T.reshape(d, fc, t_dim)[:, :width]
    for rb in range(nrb):
        gpart[rb] = ((quarters[rb, 0] + quarters[rb, 1]) + quarters[rb, 2]
                     + quarters[rb, 3])
    per = d * n * t_dim
    segments = fl.partial_sum_segments(nrb, per)
    dw_d = fl.fixed_order_sum_reference(part.view(nrb, per), segments)
    colsum = fl.fixed_order_sum_reference(gpart, segments)
    return dx, torch.cat([colsum.expand(n, -1), dw_d.view(d * n, t_dim)])


def _inputs(b, n, t_dim, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, 2, (b, n)).astype(np.float32)
    w2 = rng.normal(0, 1 / np.sqrt(DP1 * n), (DP1 * n, t_dim))
    g = rng.normal(0, 1, (b, t_dim)).astype(np.float32)
    return x, w2.astype(np.float32), g


def _held(got, want, what):
    want = torch.as_tensor(np.array(want))
    err = float((got - want).abs().max())
    bar = BAR[0] * float(want.abs().max()) + BAR[1]
    assert err <= bar, (what, err, bar)


def _jax_vjp(x, w2, g):
    """(dx, dW) of the JAX function in interpret mode, 'high', tanh on."""
    def both(xx, ww, gg):
        _, vjp = jax.vjp(
            lambda a, c: jax_fused_dw(a, c, DP1, True, True, "high"), xx, ww)
        return vjp(gg)

    return [np.asarray(a) for a in jax.jit(both)(
        jnp.asarray(x), jnp.asarray(w2), jnp.asarray(g))]


CASES = [(b, n, t) for n in (784, 10) for t in (10, 32) for b in (37, 64)]


@pytest.mark.parametrize("b,n,t_dim", CASES,
                         ids=[f"B{b}_{n}to{t}" for b, n, t in CASES])
def test_tile_decomposition_matches_plain_and_jax(b, n, t_dim):
    x, w2, g = _inputs(b, n, t_dim, seed=b + n + t_dim)
    xt, wt, gt = (torch.from_numpy(a) for a in (x, w2, g))
    dx, dw = bwd_tc_mirror(xt, wt, gt, DP1)
    assert dx.shape == (b, n) and dw.shape == (DP1 * n, t_dim)
    assert bool(torch.isfinite(dx).all()) and bool(torch.isfinite(dw).all())
    want_dx, want_dw = fl.kan_layer_fused_dw_bwd_reference(xt, wt, gt, DP1)
    _held(dx, want_dx, "dx vs plain")
    _held(dw, want_dw, "dW vs plain")
    jdx, jdw = _jax_vjp(x, w2, g)
    _held(dx, jdx, "dx vs JAX")
    _held(dw, jdw, "dW vs JAX")


@pytest.mark.parametrize("t_dim", [10, 32])
def test_tile_decomposition_over_row_blocks(t_dim):
    """B 200 at in 784: four row blocks, the last tile 8 rows, the pass
    over four partials; and a row's dx is the same at B 37 and 200 (the
    chunk does not move with B)."""
    b, n = 200, 784
    assert fl.fused_bwd_plan(b, n, DP1, t_dim)[3:] == (64, 4)
    x, w2, g = (torch.from_numpy(a) for a in _inputs(b, n, t_dim, seed=3))
    dx, dw = bwd_tc_mirror(x, w2, g, DP1)
    want_dx, want_dw = fl.kan_layer_fused_dw_bwd_reference(x, w2, g, DP1)
    _held(dx, want_dx, "dx vs plain")
    _held(dw, want_dw, "dW vs plain")
    dx37, _ = bwd_tc_mirror(x[:37], w2, g[:37], DP1)
    assert torch.equal(dx37, dx[:37])
