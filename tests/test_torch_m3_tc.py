"""The decomposition of the M3 layer's tensor-core kernels
(``csrc/qkan_layer_m3_tc.cu``: K12's forward, K13's backward with dx and
K14's weight-only backward), checked here where no kernel can run: a plain
torch mirror of what their warps compute, against the port's plain
versions and the JAX package's ``qkan_layer_fused`` /
``qkan_layer_fused_dw`` VJP in Pallas interpret mode, on the same numpy
inputs; and the route of each call (``m3_tc_plan``).

The mirrors take the kernels' plan (``m3_tc_plan``) and build every mma
operand from the fragment formulas of the kernels' lanes (lane = 4 g + t):

- K12: a k-step is (degree d >= 1, features 8 s .. +8); lane (g, t) loads
  x[rows g, g + 8][8 s + 2 t, +1] into its A slots (columns t and t + 4)
  and runs T_d by its recurrence; M3's B fragment {b0, b1} of lane (g, t)
  is M3[d][8 s + 2 t, +1][8 n-tile + g]; k-steps run s outer, d inner;
  T_0 is colsum(M3[0]), added in the epilogue; the C fragment (rows g,
  g + 8, columns 2 t, 2 t + 1) is out.
- K14: a warp's group is (16 columns of g, features 8 h .. +8, a run of
  degrees) and a row split of its block's rows (chunks of 32 rows dealt in
  turn, k-steps of 8 rows); dM^T += g^T basis per k-step, degree 0 as g^T
  times ones; the row splits' sums added in split order, each block's
  partial [dp1, N, K] summed by ``fixed_order_sum_reference`` in the
  pass's order (``partial_sum_segments``) over ``m3_bwd_layout``'s blocks.
- K13: K14's groups and dM in K13's block layout, and dx from the same
  rows: per m16-tile of rows and degree d of a group (16 columns of g at
  16 mg, features 8 h .. +8, its degrees), C_d = g @ M3[d]^T over two
  k-steps of 8 columns; lane (g, t) holds g's A slots at (rows g, g + 8) x
  (columns t, t + 4), M3^T's B fragment {b0, b1} = M3[d][8 h + g][16 mg +
  8 ks + t, + 4], and the C fragment at (rows g, g + 8) x (features 2 t,
  2 t + 1), where it adds d U_{d-1}(x) C_d, U by its recurrence on the x
  of those places, d ascending; a feature group's p = mg * dgn partials
  added in group order (mg, then dg).

Both products are 3xTF32 as the tensor cores run them: hi is the operand
with its 13 low mantissa bits cleared, lo = v - hi (cleared the same way:
the tensor core reads it as TF32), and hi*hi + (lo*hi + hi*lo) in f32.

Bar: chip_smoke.py's BARS['high'], max|mirror - ref| <= 1e-4 max|ref| +
1e-5.  A 3xTF32 product is within about 2^-21 of the f32 one relative to
|a b| (the dropped lo*lo and lo's low bits), and the sums run over at most
(D+1) N terms or a block's rows in f32, as the plain versions' do in
another order: orders of magnitude inside the bar, which a wrong feature,
degree, column, row split or block would not be.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qkan_implementation_tpu.experimental import pallas_layer as jpl
from qkan_implementation_tpu_torch.experimental import pallas_layer as pl
from qkan_implementation_tpu_torch.ops import fused_layer as fl

BAR = (1e-4, 1e-5)  # chip_smoke.py's BARS['high']
CHUNK = 32          # K14: rows of a ring stage


def _tf32(v: torch.Tensor) -> torch.Tensor:
    """v with its 13 low mantissa bits cleared."""
    return (v.view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return ah @ bh + (al @ bh + ah @ bl)


def _lanes():
    """(g, t) of the 32 lanes."""
    lane = torch.arange(32)
    return lane >> 2, lane & 3


def fwd_tc_mirror(x: torch.Tensor, m3: torch.Tensor) -> torch.Tensor:
    """out as K12's warps compute it."""
    b, n = x.shape
    dp1, _, k = m3.shape
    p = pl.m3_tc_plan(n, dp1, k, 0)
    assert p.ok
    rows, ntp = 16 * p.mt, p.ng * p.ntw
    bp = -(-b // rows) * rows
    xs = torch.zeros(bp, p.xs)  # every task's stage, zeros past B and N
    xs[:b, :n] = x
    g, t = _lanes()
    # colsum(M3[0]) in the epilogue, n ascending
    csum = torch.zeros(8 * ntp)
    for f in range(n):
        csum[:k] += m3[0, f]
    acc = torch.zeros(bp, 8 * ntp)
    for s in range(p.s):
        # A [rows, 8]: lane (g, t) holds x[.., 8s + 2t] in column t and
        # x[.., 8s + 2t + 1] in column t + 4
        a1 = torch.zeros(bp, 8)
        a1[:, t[:4]] = xs[:, 8 * s + 2 * t[:4]]
        a1[:, t[:4] + 4] = xs[:, 8 * s + 2 * t[:4] + 1]
        prv, cur = torch.ones_like(a1), a1
        for d in range(1, dp1):
            # B [8, 8 ntp] from the staged fragments: b0 at (t, g), b1 at
            # (t + 4, g) of n-tile nt, = M3[d][8s + 2t (+1)][8 nt + g]
            bm = torch.zeros(8, 8 * ntp)
            for nt in range(ntp):
                c = 8 * nt + g
                for f_off, krow in ((0, t), (1, t + 4)):
                    f = 8 * s + 2 * t + f_off
                    live = (c < k) & (f < n)
                    vals = torch.zeros(32)
                    vals[live] = m3[d, f[live], c[live]]
                    bm[krow, c] = vals
            acc = acc + _mm_3xtf32(cur, bm)
            cur, prv = 2.0 * a1 * cur - prv, cur
    return (csum + acc)[:b, :k]


def bwd_dw_tc_mirror(x: torch.Tensor, m3: torch.Tensor,
                     g: torch.Tensor, kind: int = 2) -> torch.Tensor:
    """dM as K14's (or, ``kind`` 1, K13's) warps and blocks compute it,
    then the fixed-order pass over the blocks' partials."""
    b, n = x.shape
    dp1, _, k = m3.shape
    p = pl.m3_tc_plan(n, dp1, k, kind)
    assert p.ok
    _, rows, nblk = pl.m3_bwd_layout(b, n, dp1, k, kind == 1)
    groups = p.mg * p.s * p.dgn
    wr_n = p.wr
    part = torch.zeros(nblk, dp1, n, k)
    for blk in range(nblk):
        r_begin, r_end = blk * rows, min(b, (blk + 1) * rows)
        nch = -(-(r_end - r_begin) // CHUNK)
        for gamma in range(groups):
            dg, h, mg = gamma % p.dgn, gamma // p.dgn % p.s, \
                gamma // (p.dgn * p.s)
            d_lo = 1 + dg * p.dpg
            nd = max(0, min(p.dpg, dp1 - d_lo))
            do0 = h == 0 and dg == 0
            f0, k0 = 8 * h, 16 * mg
            split_sums = []
            for wr in range(wr_n):
                acc = torch.zeros(nd, 16, 8)  # dM^T of each degree
                acc0 = torch.zeros(16, 8)
                for c in range(wr, nch, wr_n):
                    rc = r_begin + c * CHUNK
                    xs = torch.zeros(CHUNK, 8)
                    gs = torch.zeros(CHUNK, 16)
                    live = max(0, min(CHUNK, r_end - rc))
                    fw, kw = max(0, min(8, n - f0)), max(0, min(16, k - k0))
                    xs[:live, :fw] = x[rc:rc + live, f0:f0 + fw]
                    gs[:live, :kw] = g[rc:rc + live, k0:k0 + kw]
                    for kk in range(0, CHUNK, 8):
                        a = gs[kk:kk + 8].T.contiguous()  # [16 columns, 8 rows]
                        if do0:
                            acc0 = acc0 + _mm_3xtf32(a, torch.ones(8, 8))
                        xv = xs[kk:kk + 8]
                        prv, cur = torch.ones_like(xv), xv
                        for _ in range(1, d_lo):
                            cur, prv = 2.0 * xv * cur - prv, cur
                        for j in range(nd):
                            acc[j] = acc[j] + _mm_3xtf32(a, cur)
                            cur, prv = 2.0 * xv * cur - prv, cur
                split_sums.append((acc, acc0))
            acc, acc0 = split_sums[0]
            for more, more0 in split_sums[1:]:
                acc, acc0 = acc + more, acc0 + more0
            fw, kw = max(0, min(8, n - f0)), max(0, min(16, k - k0))
            for j in range(nd):
                part[blk, d_lo + j, f0:f0 + fw, k0:k0 + kw] = \
                    acc[j].T[:fw, :kw]
            if do0:
                part[blk, 0, :, k0:k0 + kw] = acc0.T[0, :kw]
    per = dp1 * n * k
    segments = fl.partial_sum_segments(nblk, per)
    return fl.fixed_order_sum_reference(part.view(nblk, per),
                                        segments).view(dp1, n, k)


def _dx_slots():
    """(rows, columns) of each lane's four A fragment slots, then of its
    four C fragment slots, of an m16n8k8 tile: [4, 32] each."""
    g, t = _lanes()
    return (torch.stack([g, g + 8, g, g + 8]),
            torch.stack([t, t, t + 4, t + 4]),
            torch.stack([g, g, g + 8, g + 8]),
            torch.stack([2 * t, 2 * t + 1, 2 * t, 2 * t + 1]))


def bwd_dx_tc_mirror(x: torch.Tensor, m3: torch.Tensor,
                     g: torch.Tensor) -> torch.Tensor:
    """dx as K13's warps compute it: every m16-tile of rows at once."""
    b, n = x.shape
    dp1, _, k = m3.shape
    p = pl.m3_tc_plan(n, dp1, k, 1)
    assert p.ok
    tiles = -(-b // 16)
    xs = torch.zeros(tiles * 16, 8 * p.s)  # zeros past B and N
    xs[:b, :n] = x
    gs = torch.zeros(tiles * 16, 16 * p.mg)  # zeros past B and K
    gs[:b, :k] = g
    xs, gs = xs.view(tiles, 16, -1), gs.view(tiles, 16, -1)
    a_rows, a_cols, c_rows, c_cols = _dx_slots()
    lg, lt = _lanes()
    dx = torch.zeros(tiles, 16, 8 * p.s)
    for h in range(p.s):
        f0 = 8 * h
        # x in the C fragment's places: [tiles, 4 slots, 32 lanes]
        xv = xs[:, c_rows, f0 + c_cols]
        partials = []
        for mg in range(p.mg):
            k0 = 16 * mg
            # g's A fragments of the two k-steps, split once for every degree
            a = []
            for ks in range(2):
                am = torch.zeros(tiles, 16, 8)
                am[:, a_rows, a_cols] = gs[:, a_rows, k0 + 8 * ks + a_cols]
                a.append(am)
            for dg in range(p.dgn):
                d_lo = 1 + dg * p.dpg
                nd = max(0, min(p.dpg, dp1 - d_lo))
                um, uc = torch.zeros_like(xv), torch.ones_like(xv)
                for _ in range(1, d_lo):
                    uc, um = 2.0 * xv * uc - um, uc
                dt = torch.zeros_like(xv)
                for d in range(d_lo, d_lo + nd):
                    cd = torch.zeros(tiles, 16, 8)
                    for ks in range(2):
                        # B = M3[d]^T: b0 at (t, g), b1 at (t + 4, g)
                        bm = torch.zeros(8, 8)
                        f = f0 + lg
                        for k_off, krow in ((0, lt), (4, lt + 4)):
                            c = k0 + 8 * ks + lt + k_off
                            live = (f < n) & (c < k)
                            vals = torch.zeros(32)
                            vals[live] = m3[d, f[live], c[live]]
                            bm[krow, lg] = vals
                        cd = cd + _mm_3xtf32(a[ks], bm)
                    dt = dt + (float(d) * uc) * cd[:, c_rows, c_cols]
                    uc, um = 2.0 * xv * uc - um, uc
                partials.append(dt)
        total = partials[0]
        for more in partials[1:]:
            total = total + more
        dx[:, c_rows, f0 + c_cols] = total
    return dx.view(tiles * 16, -1)[:b, :n]


def _inputs(b, n, k, dp1, seed, lo=-1.0, hi=1.0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(lo, hi, (b, n)).astype(np.float32)
    m3 = rng.normal(0, 1 / np.sqrt(dp1 * n), (dp1, n, k)).astype(np.float32)
    g = rng.normal(size=(b, k)).astype(np.float32)
    return x, m3, g


def _held(got, want):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape and np.all(np.isfinite(got))
    err = float(np.abs(got - want).max())
    bar = BAR[0] * float(np.abs(want).max()) + BAR[1]
    assert err <= bar, (err, bar)


def _jax(x, m3, g):
    """(out, dM, dx, dM) of the JAX layer's forward, its weight-only VJP and
    its VJP in both arguments, in interpret mode."""
    xj, mj, gj = jnp.asarray(x), jnp.asarray(m3), jnp.asarray(g)
    out, vjp = jax.vjp(lambda a, c: jpl.qkan_layer_fused_dw(a, c, True),
                       xj, mj)
    _, vjp_x = jax.vjp(lambda a, c: jpl.qkan_layer_fused(a, c, True), xj, mj)
    dx, dm = vjp_x(gj)
    return (np.asarray(out), np.asarray(vjp(gj)[1]), np.asarray(dx),
            np.asarray(dm))


CASES = [
    # b, n, k, dp1, x range: the headline layer at a small B (three K14
    # blocks of 256 rows, 4 row splits a group), N16 K128 (16 K14 groups
    # over two block rows; K13's dx adds 8 column groups' partials), N 3 /
    # K 2 at dp1 1 and 2, an unclipped x, batches that are no multiple of
    # 16 (or of a 32-row chunk), 31 degrees in 4 groups (K13 adds 4 degree
    # groups' partials), and N 40 / K 50 / dp1 12 (K13: 4 column groups x
    # 2 degree groups, 5 feature groups over 5 block rows)
    (600, 16, 16, 8, 1.0),
    (100, 16, 128, 8, 1.0),
    (37, 3, 2, 1, 1.0),
    (37, 3, 2, 2, 1.0),
    (300, 16, 16, 8, 2.0),
    (45, 4, 3, 6, 1.0),
    (70, 1, 1, 32, 1.0),
    (50, 40, 50, 12, 1.0),
]


@pytest.mark.parametrize("b,n,k,dp1,r", CASES,
                         ids=[f"B{c[0]}_N{c[1]}_K{c[2]}_dp1_{c[3]}_x{c[4]:g}"
                              for c in CASES])
def test_mirrors_match_plain_and_jax(b, n, k, dp1, r):
    x, m3, g = _inputs(b, n, k, dp1, b + n + k + dp1, -r, r)
    xt, mt, gt = map(torch.from_numpy, (x, m3, g))
    out = fwd_tc_mirror(xt, mt) if pl.m3_tc_plan(n, dp1, k, 0).ok else None
    dm = bwd_dw_tc_mirror(xt, mt, gt)
    dm13 = bwd_dw_tc_mirror(xt, mt, gt, kind=1)
    dx = bwd_dx_tc_mirror(xt, mt, gt)
    want_out = pl.qkan_layer_fused_reference(xt, mt)
    want_dx, want_dm = pl.qkan_layer_fused_bwd_reference(xt, mt, gt, True)
    jax_out, jax_dm, jax_dx, jax_dm13 = _jax(x, m3, g)
    if out is not None:  # K12 refuses N 40 / K 50 / dp1 12
        _held(out, want_out)
        _held(out, jax_out)
    for got in (dm, dm13):
        _held(got, want_dm)
        _held(got, jax_dm)
        _held(got, jax_dm13)
    _held(dx, want_dx)
    _held(dx, jax_dx)


def test_mirror_fails_with_a_wrong_feature_order():
    """A mirror whose M3 fragments take the features in the plain order
    (8 s + j) instead of the A fragments' (8 s + 2 (j & 3) + (j >> 2))
    misses the bar: the mirror's permutation is what the test holds."""
    x, m3, _ = _inputs(64, 16, 16, 8, 7)
    xt, mt = torch.from_numpy(x), torch.from_numpy(m3)
    perm = [2 * (j & 3) + (j >> 2) for j in range(8)]
    inv = [perm.index(j) for j in range(8)]
    # feeding the mirror an M3 whose rows are permuted within each group
    # of 8 features is the same as reading M3 in the wrong order
    wrong = mt.view(8, 2, 8, 16)[:, :, inv].reshape(8, 16, 16)
    err = float((fwd_tc_mirror(xt, wrong) -
                 pl.qkan_layer_fused_reference(xt, mt)).abs().max())
    want = pl.qkan_layer_fused_reference(xt, mt)
    assert err > BAR[0] * float(want.abs().max()) + BAR[1]


def test_dx_mirror_fails_with_the_a_fragments_feature_order():
    """A K13 epilogue that read x at the A fragment's columns (t, t + 4)
    instead of the C fragment's (2 t, 2 t + 1) misses the bar: feeding the
    mirror an x whose features are permuted within each group of 8 is that
    epilogue, while C_d keeps its own features."""
    x, m3, g = _inputs(64, 16, 16, 8, 11)
    xt, mt, gt = map(torch.from_numpy, (x, m3, g))
    perm = [2 * (j & 3) + (j >> 2) for j in range(8)]
    wrong = xt.view(64, 2, 8)[:, :, perm].reshape(64, 16)
    want, _ = pl.qkan_layer_fused_bwd_reference(xt, mt, gt, True)
    _held(bwd_dx_tc_mirror(xt, mt, gt), want)
    err = float((bwd_dx_tc_mirror(wrong, mt, gt) - want).abs().max())
    assert err > BAR[0] * float(want.abs().max()) + BAR[1]


# the f32-x shapes of tests/test_torch_cuda_layer_m3.py's parity cases:
# (n, k) at dp1 1, 2, 6, 8, and its main shapes
PARITY = [(n, k, dp1) for n, k in ((3, 2), (4, 3), (8, 8), (16, 16),
                                   (16, 128)) for dp1 in (1, 2, 6, 8)]
MAIN = [(16, 16, 8), (16, 128, 8), (1, 1, 32), (40, 50, 12)]


def test_plan_routes_the_shapes_as_stated():
    # the headline and N16 K128: K12, K13 and K14 on the tensor cores
    for n, k in ((16, 16), (16, 128)):
        for kind in (0, 1, 2):
            assert pl.m3_tc_plan(n, 8, k, kind).ok
    # every parity shape whose M3 fits: all of them, all three kernels
    for n, k, dp1 in PARITY + MAIN[:3]:
        for kind in (0, 1, 2):
            assert pl.m3_tc_plan(n, dp1, k, kind).ok, (n, k, dp1, kind)
    # N 40 / K 50 / dp1 12: K14 stages no M3 and takes it; K13 stages only
    # its block's feature group of M3^T (48 KB) and takes it too; K12's
    # fragments of 11 degrees (176 KB) and its rings overflow a block
    assert pl.m3_tc_plan(40, 12, 50, 2).ok
    assert pl.m3_tc_plan(40, 12, 50, 1).ok
    assert not pl.m3_tc_plan(40, 12, 50, 0).ok
    # a bf16 x keeps the CUDA-core kernels at every shape
    for n, k, dp1 in PARITY + MAIN:
        for kind in (0, 1, 2):
            assert not pl.m3_tc_plan(n, dp1, k, kind, x_bf16=True).ok
    # an M3 the CUDA-core kernels take in slices keeps them too (K13 and
    # K12 stage M3, K14 does not)
    for kind in (0, 1):
        assert pl.m3_slices(64, 8, 128, kind) != (64, 128)
        assert not pl.m3_tc_plan(64, 8, 128, kind).ok
    assert pl.m3_tc_plan(64, 8, 128, 2).ok
    # K13 where a feature group would take more than a block's 8 warps
    # (mg * dgn > 8): past 128 columns, or 80 columns at 11 degrees
    for n, k, dp1 in ((16, 144, 8), (8, 256, 2), (16, 80, 12)):
        assert pl.m3_slices(n, dp1, k, 1) == (n, k)
        assert not pl.m3_tc_plan(n, dp1, k, 1).ok, (n, k, dp1)
        assert pl.m3_tc_plan(n, dp1, k, 2).ok


def test_plan_tiling_at_the_headline():
    p = pl.m3_tc_plan(16, 8, 16, 0)
    assert (p.s, p.xs, p.mt, p.ntw, p.ng) == (2, 24, 2, 2, 1)
    # M3's fragments (14 KB), colsum and 8 warps' rings of 2 x 32 rows
    assert p.smem == 16 * 7 * 2 * 2 * 32 + 4 * 16 + 4 * 8 * 2 * 32 * 24
    p = pl.m3_tc_plan(16, 8, 16, 2)
    assert (p.s, p.mg, p.dgn, p.dpg, p.wr, p.gy) == (2, 1, 1, 7, 4, 1)
    p = pl.m3_tc_plan(16, 8, 128, 2)
    assert (p.mg, p.wr, p.gy) == (8, 1, 2)
    p = pl.m3_tc_plan(1, 32, 1, 2)  # 31 degrees: 4 groups of 8
    assert (p.dgn, p.dpg, p.wr) == (4, 8, 2)
    # K13 at the headline: K14's 2 groups (s 2, one m-tile, one degree
    # group of 7), 4 row splits, one block row; p = mg dgn = 1, so dx
    # leaves from the fragments and no partial buffers.  Shared memory:
    # 8 rings of 2 stages x 32 rows x (8 + 24) floats (64 KB) + 2 groups x
    # 7 degrees x 2 k-steps x 32 lanes x 16 bytes of M3^T (14 KB)
    p = pl.m3_tc_plan(16, 8, 16, 1)
    assert (p.s, p.mg, p.dgn, p.dpg, p.wr, p.gy) == (2, 1, 1, 7, 4, 1)
    assert p.smem == 4 * 8 * 2 * 32 * 32 + 16 * 2 * 7 * 2 * 32 == 79872
    # N16 K128: p = 8 (column groups), so a block is one feature group's
    # 8 warps, 2 block rows, no row splits; + 8 groups' M3^T (56 KB) + the
    # two buffers of 8 warps' [32 rows][8 features] partials (16 KB)
    p = pl.m3_tc_plan(16, 8, 128, 1)
    assert (p.mg, p.wr, p.gy) == (8, 1, 2)
    assert p.smem == (4 * 8 * 2 * 32 * 32 + 16 * 8 * 7 * 2 * 32
                      + 4 * 2 * 8 * 32 * 8) == 139264
    # 31 degrees: p = 4 (degree groups), 2 feature groups a block: the
    # same 4 groups and 2 row splits as K14
    p = pl.m3_tc_plan(1, 32, 1, 1)
    assert (p.dgn, p.dpg, p.wr, p.gy) == (4, 8, 2, 1)
    # N 40 / K 50 / dp1 12: p = 4 x 2, a feature group a block, 5 of them
    p = pl.m3_tc_plan(40, 12, 50, 1)
    assert (p.s, p.mg, p.dgn, p.dpg, p.wr, p.gy) == (5, 4, 2, 6, 1, 5)
    assert p.smem == (4 * 8 * 2 * 32 * 32 + 16 * 8 * 6 * 2 * 32
                      + 4 * 2 * 8 * 32 * 8) == 131072


def test_bwd_layout_mirror():
    """The backward's block layout, the same on both routes: the
    headline's 256 blocks of 1024 rows, N16 K128's 16 of 256, K13's the
    same as K14's there (so its dM partials are K14's bits)."""
    for want_dx in (False, True):
        assert pl.m3_bwd_layout(262144, 16, 8, 16, want_dx) == \
            (256, 1024, 256)
        assert pl.m3_bwd_layout(4096, 16, 8, 128, want_dx) == (256, 256, 16)
        assert pl.m3_bwd_layout(600, 16, 8, 16, want_dx)[2] == 3
