"""Fused FixedKAN layer: tanh -> Chebyshev recurrence -> matmul, and back.

Counterpart of ``qkan_implementation_tpu.ops.fused_layer``: the v2
degree-wise schedule ``kan_layer_fused_dw``, the v1 ``kan_layer_fused``
and the one-kernel single-layer train step ``kan_train_step_fused``
(forward, loss and dW with the basis built once; no dx).  The layers
compute

    out = colsum(W_0) + sum_{d>=1} T_d(t) @ W_d,    t = tanh(x) (or x),

with ``w2`` DEGREE-MAJOR: ``W_d = w2[d*in:(d+1)*in]``, and its gradient

    dW_0 = colsum(g),   dW_d = T_d(t)^T @ g,
    dx   = (1 - t^2) * sum_{d>=1} d * U_{d-1}(t) * (g @ W_d^T).

The fold of per-output coefficients, degree mask and horizontal weights
into ``w2`` is the caller's (``models.fixed_kan.kan_layer_apply``).  The
two schedules differ only in where they round when x is bf16 (below).

Each function has two versions:

- a plain torch version (``*_reference``, ``*_bwd_reference``) with the
  same math and the same bf16 rounding points as the TPU kernel in
  interpret mode.  CPU tensors take it, and it is the yardstick the CUDA
  kernel is held against on the card;
- a CUDA kernel (``csrc/fused_dw_fwd.cu``, ``csrc/fused_dw_bwd.cu``) that
  never writes the [B, dp1*in] basis to device memory.  A CUDA tensor
  launches it or raises: there is no fallback to the plain version.

Any width T and any dp1.  The forward takes them in one launch (column
tiles across its grid, degrees in chunks with the recurrence carried);
where its grid splits the features, the feature splits' partial outs go
to a workspace and the same library call adds them with the fixed-order
pass of ``csrc/partial_sum.cu`` (``fused_fwd_plan``).  S is a function of
(B, in, dp1, T), so a row's out has the same bits on every run and card
at one B but may differ in its last bits between batch sizes (the
features are added in S groups): at the flagship's layer 0 S is 49 at B
64, 4 at B 4096 and 1 past B 8448.  The TPU kernel and the CUDA-core
kernel give a row the same bits at any B.  A backward at an f32 x in
'high' / 'default' with dp1 >= 2, T <= 64 and few enough degrees (every
layer of the main path) runs one launch of the tensor-core kernel, its
features split over the grid in chunks of 16 (``fused_bwd_plan``: the
chunk is a function of (in, dp1, T), so a row's dx has the same bits at
every B); the rest (a bf16 x, 'bf16', dp1 = 1, T > 64, more degrees)
runs the CUDA-core kernel over column slices of 64 (``fused_col_slices``)
and, within each, degree chunks, carrying dx's sum across them.  The train step, where one launch
does not take T, launches its CUDA-core kernel once a column slice
(``fused_step_col_slice``) into one workspace.  Each is one library call.

A backward (and the train step) writes per-block dW partials to a
workspace and sums them with that pass, launched by the same library
call: one call a backward.  The row blocks are a function of the sizes
(and of the backward's route) alone: K2/K4's ``fused_bwd_plan`` (its
CUDA-core kernel's ``fused_bwd_layout``), K5's ``fused_step_layout``.  These
and the plans above are plain mirrors of the C layouts, which a GPU test
holds equal.  ``fixed_order_sum_reference`` is that pass's plain version
in its own order (equal to it bit for bit); ``fused_bwd_partial_sum``
runs the pass alone over a workspace.

``kan_layer_fused_dw`` and ``kan_layer_fused`` are differentiable in x and
w2 through one ``torch.autograd.Function`` each: forward and backward both
run the kernel on a CUDA tensor and the plain version on a CPU tensor, so
the CPU tests exercise the hand-written backward, not autograd's.

Precision.  'high' and 'default' are FP32 products with FP32 sums: on
the CUDA cores, and in the tensor-core kernels (the forward's, the
backward's, the train step's) as 3xTF32 (each f32 operand split into two
TF32 parts, three products summed in FP32: the counterpart of the TPU's
bf16x3 split).  The recurrences run
in x's dtype, so a bf16 x rounds tanh and every recurrence op to bf16.
Then:

- degree-wise 'bf16' rounds T_d, W_d (d >= 1) and g to bf16 before each
  product and accumulates in f32; colsum(W_0) and colsum(g) stay f32;
- the v1 pair takes 'high'/'default' only, and a bf16 x decides its
  numerics: the forward rounds ALL of w2 to bf16, W_0 included, so its
  T_0 term is sum_i bf16(W_0[i, c]); the backward keeps g and w2 in f32.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from qkan_implementation_tpu_torch.ops._cuda_build import (
    count_launches as _count,
    raise_on_error as _raise_on_error,
)
from qkan_implementation_tpu_torch.utils.platform import (
    tensor_device_type as _device_of,
)


def _resolve_mode(precision: str) -> str:
    """'high' | 'default' -> 'plain' (f32 products); 'bf16' -> 'bf16'."""
    if precision not in ("high", "default", "bf16"):
        raise ValueError(
            f"unknown fused precision {precision!r}: "
            "'high', 'default', or 'bf16'"
        )
    return "bf16" if precision == "bf16" else "plain"


def _check_v1_precision(precision: str) -> None:
    if precision not in ("high", "default"):
        raise ValueError(
            f"unknown fused precision {precision!r}: 'high' or 'default'"
        )


def _dot_md(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """a @ b with f32 accumulation; 'bf16' rounds both operands first.

    bf16 operands widened to f32 multiply exactly, so the f32 matmul is
    the one-pass bf16 product with f32 accumulation.
    """
    if mode == "bf16":
        a = a.to(torch.bfloat16)
        b = b.to(torch.bfloat16)
    return a.to(torch.float32) @ b.to(torch.float32)


def _cheb_blocks(t: torch.Tensor, dp1: int) -> list:
    """[T_0, T_1, ..., T_D](t), each op in t's dtype."""
    ts = [torch.ones_like(t), t]
    for _ in range(2, dp1):
        ts.append(2.0 * t * ts[-1] - ts[-2])
    return ts[:dp1]


# -- plain versions -------------------------------------------------------


def kan_layer_fused_dw_reference(
    x: torch.Tensor,
    w2: torch.Tensor,
    dp1: int,
    apply_tanh: bool = True,
    precision: str = "high",
) -> torch.Tensor:
    """Plain torch version of the degree-wise layer: [B, in] -> [B, T] f32."""
    mode = _resolve_mode(precision)
    t = torch.tanh(x) if apply_tanh else x
    n = x.shape[1]
    # T_0 = 1: exact broadcast of the W_0 column sums, no products
    acc = w2[:n].to(torch.float32).sum(dim=0).expand(x.shape[0], -1)
    prev, cur = torch.ones_like(t), t
    for d in range(1, dp1):
        acc = acc + _dot_md(cur, w2[d * n : (d + 1) * n], mode)
        prev, cur = cur, 2.0 * t * cur - prev
    return acc.contiguous()


def kan_layer_fused_dw_bwd_reference(
    x: torch.Tensor,
    w2: torch.Tensor,
    g: torch.Tensor,
    dp1: int,
    apply_tanh: bool = True,
    precision: str = "high",
) -> tuple:
    """Plain torch backward of the degree-wise layer.

    ``g`` is the [B, T] output cotangent (cast to f32).  Returns ``dx``
    [B, in] in x's dtype and ``dw`` [dp1*in, T] in f32.
    """
    mode = _resolve_mode(precision)
    t = torch.tanh(x) if apply_tanh else x
    n = x.shape[1]
    g = g.to(torch.float32)
    # dW_0 = 1^T @ g: exact broadcast of the g column sums
    dws = [g.sum(dim=0).expand(n, -1)]
    prev, cur = torch.ones_like(t), t  # T_{d-1}, T_d
    # U_{d-1} with U_{-1} = 0, U_0 = 1: the same 2t recurrence as T
    u_m2, u_m1 = 0.0, torch.ones_like(t)
    dt = torch.zeros(t.shape, dtype=torch.float32, device=x.device)
    for d in range(1, dp1):
        dws.append(_dot_md(cur.T, g, mode))
        gm = _dot_md(g, w2[d * n : (d + 1) * n].T, mode)
        # d * U_{d-1} in x's dtype; the product with the f32 gm widens
        dt = dt + (float(d) * u_m1) * gm
        prev, cur = cur, 2.0 * t * cur - prev
        u_m2, u_m1 = u_m1, 2.0 * t * u_m1 - u_m2
    dx = (1.0 - t * t) * dt if apply_tanh else dt
    return dx.to(x.dtype), torch.cat(dws).contiguous()


def _dot_x_dtype(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b for the v1 pair: bf16 operands multiply exactly in f32 with
    f32 sums; f32 and f64 operands multiply at their own dtype."""
    acc = torch.float64 if a.dtype == torch.float64 else torch.float32
    return a.to(acc) @ b.to(acc)


def kan_layer_fused_reference(
    x: torch.Tensor,
    w2: torch.Tensor,
    dp1: int,
    apply_tanh: bool = True,
    precision: str = "high",
) -> torch.Tensor:
    """Plain torch version of the v1 layer: the whole [B, dp1*in] basis in
    x's dtype, then one product with w2 cast to that dtype.  -> [B, T] f32.
    """
    _check_v1_precision(precision)
    t = torch.tanh(x) if apply_tanh else x
    basis = torch.cat(_cheb_blocks(t, dp1), dim=1)
    return _dot_x_dtype(basis, w2.to(basis.dtype)).to(torch.float32)


def kan_layer_fused_bwd_reference(
    x: torch.Tensor,
    w2: torch.Tensor,
    g: torch.Tensor,
    dp1: int,
    apply_tanh: bool = True,
    precision: str = "high",
) -> tuple:
    """Plain torch backward of the v1 layer: dW = basis^T @ g with the
    basis widened to f32; dx from one [B, T] @ [T, dp1*in] product with
    f32 w2, then the U-weighted sum over the degree blocks.  Returns
    ``dx`` in x's dtype and ``dw`` [dp1*in, T] f32."""
    _check_v1_precision(precision)
    t = torch.tanh(x) if apply_tanh else x
    n = x.shape[1]
    g = g.to(torch.float32)
    basis = torch.cat(_cheb_blocks(t, dp1), dim=1)
    dw = basis.to(torch.float32).T @ g
    gm = g @ w2.to(torch.float32).T  # [B, dp1*in]
    us = [torch.ones_like(t), 2.0 * t]
    for _ in range(3, dp1):
        us.append(2.0 * t * us[-1] - us[-2])
    dt = torch.zeros(t.shape, dtype=torch.float32, device=x.device)
    for d in range(1, dp1):
        dt = dt + (float(d) * us[d - 1]) * gm[:, d * n : (d + 1) * n]
    dx = (1.0 - t * t) * dt if apply_tanh else dt
    return dx.to(x.dtype), dw.contiguous()


def fixed_order_sum_reference(part: torch.Tensor,
                              segments: int) -> torch.Tensor:
    """The sum of ``part`` [nblk, ...] over its first axis in the order of
    the CUDA pass (``csrc/partial_sum.cu``): the partials cut into
    ``segments`` runs of ceil(nblk / segments), each summed from 0 one add
    at a time in block order, then the run sums added from 0 in run order.
    Each add is one IEEE rounding in part's dtype on either side, so the
    f32 kernel equals this bit for bit; ``segments = 1`` is the plain
    in-order loop.  The card's order takes ``partial_sum_segments``."""
    nblk = part.shape[0]
    if not 1 <= segments <= nblk:
        raise ValueError(
            f"segments must be in [1, {nblk}] for {nblk} partials, got "
            f"{segments}"
        )
    seg_len = -(-nblk // segments)
    total = torch.zeros(part.shape[1:], dtype=part.dtype, device=part.device)
    for s in range(segments):
        acc = torch.zeros_like(total)
        for b in range(s * seg_len, min((s + 1) * seg_len, nblk)):
            acc.add_(part[b])
        total.add_(acc)
    return total


# -- CUDA launches ----------------------------------------------------------


# the constants of the layouts in csrc/fused_dw_bwd.cu and of the pass's
# segments in csrc/partial_sum.cu, which the plain functions below mirror
_PARTIAL_BUDGET = 4 << 20  # bytes of dW partials
_STEP_WIDE_BUDGET = 32 << 20  # K5's on the CUDA-core path
_GROWS = 32                # K2's rows come in multiples of it
_TC_ROWS, _TC_GRID, _TC_ACC, _TC_THREADS = 64, 264, 8, 256
_TC_SMEM_MAX = 232448      # a block's shared memory on sm_90
_PS_SMALL_NBLK, _PS_MAX_SEGMENTS, _PS_SEGMENT_LOADS = 32, 32, 16
_PS_FILL_THREADS = 132 * 256
_COL_SLICE = 64            # columns of a backward launch, and of a step's
_STEP_STAGE_BYTES, _STEP_WARPS = 96 * 1024, 8
# the forward's plan (fwd_plan and fwd_tc in csrc/fused_dw_fwd.cu)
_FWD_ROWS, _FWD_GRID, _FWD_CC_MAX_IN = 64, 264, 16
# the backward's tensor-core plan (csrc/fused_bwd_tc.cuh)
_BT_ROWS, _BT_FC, _BT_GRID, _BT_BUDGET = 64, 16, 264, 8 << 20


def _pad_t(t_dim: int) -> int:
    """T padded to the CUDA-core kernels' register tile (``pad_t``)."""
    for p in (4, 8, 12, 16, 32):
        if t_dim <= p:
            return p
    return 64


def fused_fwd_plan(b: int, n: int, dp1: int, t_dim: int) -> tuple:
    """(tensor cores, feature splits S, features a chunk) of a forward
    (K1/K3) at these sizes: the plain mirror of ``fwd_tc`` and
    ``fwd_plan`` in ``csrc/fused_dw_fwd.cu`` (C entries
    ``qkan_fused_fwd_tensor_cores``, ``qkan_fused_fwd_splits``).  The
    CUDA-core kernel takes the narrow layers (in <= 16) where it takes the
    shape (dp1 <= 32, T <= 64), S = 1, no chunks; the tensor-core kernel
    the rest, over (64-row tiles) x (column tiles of up to 64) x S, S =
    264 // (row tiles x column tiles) clamped to [1, feature chunks]: a
    function of the sizes alone.  Chunks are 8 or 16 features at in <= 8
    or 16, else 32, or 16 past 32 features where 32-feature chunks would
    cap S short of 264 // (row tiles x column tiles).  Past S = 1 the partials take S * B
    * T floats of workspace."""
    if dp1 <= 32 and t_dim <= 64 and n <= _FWD_CC_MAX_IN:
        return False, 1, 0
    n8 = -(-min(t_dim, 64) // 8)
    tn = 8 * (1 if n8 <= 1 else 2 if n8 <= 2 else 4 if n8 <= 4 else 8)
    want = _FWD_GRID // (-(-b // _FWD_ROWS) * -(-t_dim // tn))
    fc = (8 if n <= 8 else 16 if n <= 16 or (n > 32 and want > -(-n // 32))
          else 32)
    return True, max(min(want, -(-n // fc)), 1), fc


def fused_col_slices(t_dim: int) -> list:
    """The column slices [c0, c1) a backward (K2/K4) launches over, in
    order: 64 columns each, the last the rest (C entry
    ``qkan_fused_bwd_col_slices`` counts them)."""
    return [(c0, min(c0 + _COL_SLICE, t_dim))
            for c0 in range(0, t_dim, _COL_SLICE)]


def fused_bwd_plan(b: int, n: int, dp1: int, t_dim: int,
                   x_bf16: bool = False, round_bf16: bool = False) -> tuple:
    """(tensor cores, features a chunk, column tiles, rows a block, row
    blocks) of a backward (K2/K4) at these sizes, x's dtype and mode: the
    plain mirror of ``bwd_tc_plan`` / ``bwd_tc_rows`` in
    ``csrc/fused_bwd_tc.cuh`` and of ``layout()`` in
    ``csrc/fused_dw_bwd.cu`` (C entries ``qkan_fused_bwd_tensor_cores``,
    ``qkan_fused_bwd_feature_chunk``, ``qkan_fused_bwd_row_blocks``).

    The tensor-core kernel takes an f32 x in 'high' / 'default' (not
    ``x_bf16``, not ``round_bf16``) at dp1 >= 2 and T <= 64, one column
    tile, in chunks of 16 features: a warp holds dW^T for dp1 - 1 <= 12,
    6 or 3 degrees at T padded to 16, 32 or 64, and a block's tiles fit
    227 KB of shared memory.  Its row blocks: 264 // (feature chunks),
    capped by the 64-row tiles and by an 8 MB budget of dW partials, each
    a run of whole tiles.  The chunk is a function of
    (in, dp1, T) alone, never of B.  Elsewhere the CUDA-core kernel:
    chunk 0, its column slices of 64, ``fused_bwd_layout``."""
    n8 = -(-t_dim // 8)
    nt = 2 if n8 <= 2 else 4 if n8 <= 4 else 8
    d = dp1 - 1
    if not (x_bf16 or round_bf16) and 1 <= d <= 24 // nt and t_dim <= 64:
        tn, fc = 8 * nt, _BT_FC
        kb = fc * d
        bs = -(-kb // 32) * 32 + 8
        tiles = 2 * _BT_ROWS * (bs + fc + (24 if tn == 16 else tn + 8))
        smem = 4 * (max(tiles, 8 * 128 * d * (nt // 2)) + 2 * kb * tn)
        if smem <= _TC_SMEM_MAX:
            tiles = -(-b // _BT_ROWS)
            nrb = max(min(_BT_GRID // -(-n // fc),
                          _BT_BUDGET // (d * n * t_dim * 4), tiles), 1)
            rows = -(-tiles // nrb) * _BT_ROWS
            return True, fc, 1, rows, -(-b // rows)
    return (False, 0, len(fused_col_slices(t_dim)),
            *fused_bwd_layout(b, n, dp1, t_dim))


def fused_bwd_launches(n: int, dp1: int, t_dim: int, x_bf16: bool = False,
                       round_bf16: bool = False) -> int:
    """Kernel launches of one backward call: one where the tensor-core
    kernel takes the call (``fused_bwd_plan``), else each column slice's
    degree chunks, DC = 64 // (the slice's padded width) degrees a chunk
    (the plain mirror of ``qkan_fused_bwd_launches``)."""
    if fused_bwd_plan(1, n, dp1, t_dim, x_bf16, round_bf16)[0]:
        return 1
    total = 0
    for c0, c1 in fused_col_slices(t_dim):
        tp = _pad_t(c1 - c0)
        dc = 1 if tp >= 64 else 64 // tp
        total += -(-(dp1 - 1) // dc) if dp1 > 1 else 1
    return total


def _step_stage_bytes(dp1: int, tp: int, chunk: int) -> int:
    return (_GROWS * (chunk + 1) + dp1 * chunk * tp) * 4


def fused_step_col_slice(n: int, dp1: int, t_dim: int) -> int:
    """Columns of one launch of a train step (K5): T where the
    tensor-core kernel takes the sizes, else the widest of T (up to 64),
    64, 32, 16, 12, 8, 4 whose CUDA-core staging fits 96 KB at a chunk of
    8 features; failing that, at a chunk of 1; 0 where nothing fits.  The
    plain mirror of ``step_cols`` in ``csrc/fused_dw_bwd.cu`` (C entry
    ``qkan_fused_step_col_slice``)."""
    if fused_step_tensor_cores(n, dp1, t_dim):
        return t_dim
    top = min(t_dim, _COL_SLICE)
    for chunk in (_STEP_WARPS, 1):
        for w in (top, 64, 32, 16, 12, 8, 4):
            if (w <= top and _step_stage_bytes(dp1, _pad_t(w), chunk)
                    <= _STEP_STAGE_BYTES):
                return w
    return 0


def partial_sum_segments(nblk: int, per: int) -> int:
    """Segments of the fixed-order pass over ``nblk`` partials of ``per``
    floats: a function of the two alone, so the pass gives the same bits
    on every call and every card.  The plain mirror of the C entry
    ``qkan_partial_sum_segments`` (a GPU test holds the two equal): one
    segment up to 32 partials, else the fewest that walk <= 16 partials
    each and fill 132 x 256 threads, a power of two, <= 32 and <= nblk."""
    if nblk < 1 or per < 0:
        return 0
    if nblk <= _PS_SMALL_NBLK:
        return 1
    units = (per + 3) // 4
    want = -(-nblk // _PS_SEGMENT_LOADS)
    fill = -(-_PS_FILL_THREADS // units) if units > 0 else _PS_MAX_SEGMENTS
    want = max(want, fill)
    segments = 1
    while segments < want and segments < _PS_MAX_SEGMENTS:
        segments <<= 1
    return min(segments, nblk)


def fused_bwd_layout(b: int, n: int, dp1: int, t_dim: int,
                     budget: int = _PARTIAL_BUDGET) -> tuple:
    """(rows a block, row blocks) of the CUDA-core backward kernel (K2/K4
    where ``fused_bwd_plan`` does not take the tensor cores) at these
    sizes: the plain mirror of ``layout()`` in ``csrc/fused_dw_bwd.cu``
    (C entry ``qkan_fused_bwd_row_blocks`` on that route).  Rows come in
    multiples of 32, and as few blocks as keep the dW partials under
    ``budget`` bytes (4 MB)."""
    per_rb = (dp1 - 1) * n * t_dim * 4
    max_nrb = max(budget // per_rb if per_rb else b, 1)
    rows = -(-b // max_nrb)
    rows = -(-rows // _GROWS) * _GROWS
    return rows, -(-b // rows)


def fused_step_tensor_cores(n: int, dp1: int, t_dim: int) -> bool:
    """Whether the train step at these sizes runs on the tensor cores
    (``fused_step_kernel_tc``): the plain mirror of ``tc_shape()`` in
    ``csrc/fused_dw_bwd.cu`` (C entry ``qkan_fused_step_tensor_cores``).
    It takes dp1 >= 2 and T <= 64 where a block's 8 warps hold all of dW
    in registers (mpw * nt <= 8 (m16, n8) tiles a warp, nt the n8-tiles
    of T and mpw the m16-tiles of K = in*(dp1-1) over 8 warps, each as 1,
    2, 4 or 8; K <= 1024) and a 64-row tile's shared memory fits;
    other shapes (the flagship's in = 784, dp1 = 1) run the CUDA-core
    kernel."""
    n8 = -(-t_dim // 8)
    nt = 1 if n8 <= 1 else 2 if n8 <= 2 else 4 if n8 <= 4 else 8
    tn = 8 * nt
    k = n * (dp1 - 1)
    kp, s = -(-k // 16) * 16, -(-k // 32) * 32
    need = -(-(kp // 16) // 8)
    mpw = 1 if need <= 1 else 2 if need <= 2 else 4 if need <= 4 else 8
    xstage = -(-(_TC_ROWS * n * 4) // 16) * 16
    smem = (4 * (_TC_ROWS * s + kp * tn + _TC_ROWS * tn + tn + 32 * tn
                 + _TC_THREADS + 64 * tn)
            + 2 * xstage)
    return (dp1 >= 2 and t_dim <= _COL_SLICE and k <= 1024
            and mpw * nt <= _TC_ACC and smem <= _TC_SMEM_MAX)


def fused_step_layout(b: int, n: int, dp1: int, t_dim: int) -> tuple:
    """(tensor cores, rows a block, row blocks) of a train step (K5): the
    plain mirror of ``step_layout()`` in ``csrc/fused_dw_bwd.cu`` (C entry
    ``qkan_fused_step_row_blocks``), a function of the sizes alone.  On
    the tensor cores: at most 264 persistent row blocks of whole 64-row
    tiles, fewer where the dW partials would pass 4 MB; else K2's
    layout under a 32 MB budget (128 row blocks at the flagship's layer
    0, B 4096, where 4 MB left 26 for 132 SMs)."""
    if not fused_step_tensor_cores(n, dp1, t_dim):
        return (False, *fused_bwd_layout(b, n, dp1, t_dim,
                                         _STEP_WIDE_BUDGET))
    tiles = -(-b // _TC_ROWS)
    per_rb = (dp1 - 1) * n * t_dim * 4
    nrb = max(min(_PARTIAL_BUDGET // per_rb, _TC_GRID, tiles), 1)
    rows = -(-tiles // nrb) * _TC_ROWS
    return True, rows, -(-b // rows)


def _check_layer_args(x, w2, dp1):
    """What every kernel takes; returns (B, in, T)."""
    if w2.device != x.device:
        raise ValueError(f"x is on {x.device} but w2 is on {w2.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if w2.dtype != torch.float32:
        raise ValueError(f"w2 must be float32, got {w2.dtype}")
    if x.dim() != 2 or w2.dim() != 2:
        raise ValueError(
            f"expected x [B, in] and w2 [dp1*in, T], got {tuple(x.shape)} "
            f"and {tuple(w2.shape)}"
        )
    b, n = x.shape
    t_dim = w2.shape[1]
    if w2.shape[0] != dp1 * n:
        raise ValueError(
            f"w2 has {w2.shape[0]} rows, expected dp1*in = {dp1}*{n}"
        )
    if dp1 < 1 or t_dim < 1 or n < 1:
        raise ValueError(
            f"the kernels take dp1, T and in >= 1, got dp1={dp1}, "
            f"T={t_dim}, in={n}"
        )
    if not (x.is_contiguous() and w2.is_contiguous()):
        raise ValueError("x and w2 must be contiguous")
    return b, n, t_dim


# the counter each C entry adds to when its kernel launches (filled in
# below, once the counters' owners exist)
_COUNTER_OF: dict = {}


def _launch_fwd(entry: str, x, w2, dp1, apply_tanh, extra: tuple):
    """Run a forward kernel (``qkan_fused_dw_fwd`` or ``qkan_fused_fwd``)
    and count its one launch; where the kernel splits the features (a
    workspace of partials), the same library call launches the
    fixed-order pass too, counted on ``fused_bwd_partial_sum.launches``.
    A B = 0 input launches and counts nothing."""
    b, n, t_dim = _check_layer_args(x, w2, dp1)
    out = torch.empty((b, t_dim), dtype=torch.float32, device=x.device)
    if b == 0:
        return out
    from qkan_implementation_tpu_torch.ops._cuda_build import load_library

    lib = load_library()
    ws_bytes = lib.qkan_fused_fwd_workspace_bytes(b, n, dp1, t_dim)
    ws = (torch.empty(ws_bytes, dtype=torch.uint8, device=x.device)
          if ws_bytes else None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, entry)(
            x.data_ptr(), w2.data_ptr(), out.data_ptr(),
            ws.data_ptr() if ws is not None else None, ws_bytes, b, n, dp1,
            t_dim, int(x.dtype == torch.bfloat16), *extra,
            int(bool(apply_tanh)), stream,
        )
    _raise_on_error(lib, err, entry)
    _count(*_COUNTER_OF[entry])
    if ws is not None:
        _count(fused_bwd_partial_sum, "launches")
    return out


def _bwd_pass(entry: str, x, w2, g, dp1, apply_tanh, extra: tuple,
              want_dx: bool, finish: bool = False):
    """A backward kernel (``qkan_fused_dw_bwd`` or ``qkan_fused_bwd``):
    (dx or None, the workspace of dW partials, dW or None).  With
    ``finish`` the same library call launches the fixed-order pass too,
    into dW [dp1*in, T] f32, a tensor of its own.  Counts the call's
    launches (``fused_bwd_launches``: one on the tensor cores, as at every
    main-path layer; one per degree chunk on the CUDA cores) and, with
    ``finish``, one of the pass; a B = 0 input launches and counts nothing
    (dW is zeros)."""
    b, n, t_dim = _check_layer_args(x, w2, dp1)
    g = g.to(torch.float32).contiguous()
    if g.device != x.device or tuple(g.shape) != (b, t_dim):
        raise ValueError(
            f"g must be [{b}, {t_dim}] on {x.device}, got "
            f"{tuple(g.shape)} on {g.device}"
        )
    dx = torch.empty_like(x) if want_dx else None
    from qkan_implementation_tpu_torch.ops._cuda_build import load_library

    lib = load_library()
    # the route's flags: x's dtype and the 'bf16' mode (the v1 entry has none)
    route = (int(x.dtype == torch.bfloat16), int(extra[0]) if extra else 0)
    ws_bytes = lib.qkan_fused_bwd_workspace_bytes(
        max(b, 1), n, dp1, t_dim, int(want_dx), *route
    )
    # per-block dW partials (and, past one degree chunk, dt): the kernel
    # allocates nothing itself
    ws = torch.empty(ws_bytes, dtype=torch.uint8, device=x.device)
    dw = (torch.empty((dp1 * n, t_dim), dtype=torch.float32, device=x.device)
          if finish else None)
    if b == 0:
        return dx, ws.zero_(), None if dw is None else dw.zero_()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, entry)(
            x.data_ptr(), w2.data_ptr(), g.data_ptr(),
            dx.data_ptr() if want_dx else None, ws.data_ptr(), ws_bytes, b,
            n, dp1, t_dim, int(x.dtype == torch.bfloat16), *extra,
            int(bool(apply_tanh)), int(want_dx),
            dw.data_ptr() if dw is not None else None, stream,
        )
    _raise_on_error(lib, err, entry)
    _count(*_COUNTER_OF[entry],
           lib.qkan_fused_bwd_launches(n, dp1, t_dim, *route))
    if finish:
        _count(fused_bwd_partial_sum, "launches")
    return dx, ws, dw


def fused_bwd_partial_sum(ws, b, n, dp1, t_dim, want_dx=True, *,
                          step=False, x_bf16=False, round_bf16=False):
    """dW [dp1*in, T] f32 from the workspace of a backward pass (or, with
    ``step``, of a train step) at these sizes, x's dtype (``x_bf16``) and
    mode (``round_bf16``: 'bf16'), which pick the backward's route: the
    partials summed over row blocks in a fixed order (the pass alone,
    entries ``qkan_fused_bwd_partial_sum`` /
    ``qkan_fused_step_partial_sum``; the backwards and the step launch it
    themselves).  Counts ``fused_bwd_partial_sum.launches``, as do the
    backwards and the train step where they launch it."""
    from qkan_implementation_tpu_torch.ops._cuda_build import load_library

    lib = load_library()
    dw = torch.empty((dp1 * n, t_dim), dtype=torch.float32, device=ws.device)
    with torch.cuda.device(ws.device):
        stream = torch.cuda.current_stream(ws.device).cuda_stream
        if step:
            entry = "qkan_fused_step_partial_sum"
            err = lib.qkan_fused_step_partial_sum(
                ws.data_ptr(), ws.numel(), dw.data_ptr(), max(b, 1), n, dp1,
                t_dim, stream,
            )
        else:
            entry = "qkan_fused_bwd_partial_sum"
            err = lib.qkan_fused_bwd_partial_sum(
                ws.data_ptr(), ws.numel(), dw.data_ptr(), max(b, 1), n, dp1,
                t_dim, int(want_dx), int(x_bf16), int(round_bf16), stream,
            )
    _raise_on_error(lib, err, entry)
    _count(fused_bwd_partial_sum, "launches")
    return dw


fused_bwd_partial_sum.launches = 0


def fused_bwd_workspace_partials(ws, b, n, dp1, t_dim, *, step=False,
                                 x_bf16=False, round_bf16=False) -> tuple:
    """Views of a backward's (or, with ``step``, a train step's)
    workspace: the dW_d (d >= 1) partials [nrb, (dp1-1)*in*T] and the
    colsum(g) partials [nrb, T], nrb row blocks from ``fused_bwd_plan``
    at x's dtype and mode (``fused_step_layout``).  The pass sums both in
    the order of ``partial_sum_segments(nrb, (dp1-1)*in*T)``."""
    nrb = (fused_step_layout(max(b, 1), n, dp1, t_dim)[2] if step
           else fused_bwd_plan(max(b, 1), n, dp1, t_dim, x_bf16,
                               round_bf16)[4])
    f = ws.view(torch.float32)
    per_rb = (dp1 - 1) * n * t_dim
    return (f[: nrb * per_rb].view(nrb, per_rb),
            f[nrb * per_rb : nrb * (per_rb + t_dim)].view(nrb, t_dim))


def fused_bwd_partial_sum_reference(ws, b, n, dp1, t_dim, *, step=False,
                                    x_bf16=False, round_bf16=False):
    """Plain torch version of ``fused_bwd_partial_sum``: the same sums
    over the [row blocks, ...] partials of a workspace."""
    part, gpart = fused_bwd_workspace_partials(
        ws, b, n, dp1, t_dim, step=step, x_bf16=x_bf16,
        round_bf16=round_bf16)
    return torch.cat([gpart.sum(dim=0).expand(n, -1),
                      part.sum(dim=0).view(-1, t_dim)])


def fused_bwd_fixed_order_reference(ws, b, n, dp1, t_dim, *, step=False,
                                    x_bf16=False, round_bf16=False):
    """Plain torch version of ``fused_bwd_partial_sum`` in the kernel's own
    order (``fixed_order_sum_reference`` over both kinds of partials, with
    the pass's segment count): the kernel equals it bit for bit."""
    part, gpart = fused_bwd_workspace_partials(
        ws, b, n, dp1, t_dim, step=step, x_bf16=x_bf16,
        round_bf16=round_bf16)
    segments = partial_sum_segments(part.shape[0], part.shape[1])
    return torch.cat([
        fixed_order_sum_reference(gpart, segments).expand(n, -1),
        fixed_order_sum_reference(part, segments).view(-1, t_dim),
    ])


def _launch_bwd(entry, x, w2, g, dp1, apply_tanh, extra, want_dx):
    """A backward kernel and its fixed-order sum, in one library call:
    (dx or None, dw)."""
    dx, _, dw = _bwd_pass(entry, x, w2, g, dp1, apply_tanh, extra, want_dx,
                          finish=True)
    return dx, dw


# -- degree-wise layer (K1 forward, K2 backward) --------------------------


def _fused_dw_fwd(x, w2, dp1, apply_tanh, precision):
    mode = _resolve_mode(precision)
    if _device_of(x) == "cpu":
        return kan_layer_fused_dw_reference(x, w2, dp1, apply_tanh, precision)
    return _launch_fwd("qkan_fused_dw_fwd", x, w2, dp1, apply_tanh,
                       (int(mode == "bf16"),))


def _fused_dw_bwd(x, w2, g, dp1, apply_tanh, precision, want_dx=True):
    mode = _resolve_mode(precision)
    if _device_of(x) == "cpu":
        return kan_layer_fused_dw_bwd_reference(
            x, w2, g, dp1, apply_tanh, precision
        )
    return _launch_bwd("qkan_fused_dw_bwd", x, w2, g, dp1, apply_tanh,
                       (int(mode == "bf16"),), want_dx)


class _FusedDW(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w2, dp1, apply_tanh, precision):
        ctx.save_for_backward(x, w2)
        ctx.args = (dp1, apply_tanh, precision)
        return _fused_dw_fwd(x, w2, dp1, apply_tanh, precision)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, w2 = ctx.saved_tensors
        want_dx, want_dw = ctx.needs_input_grad[:2]
        dx, dw = _fused_dw_bwd(x, w2, g, *ctx.args, want_dx=want_dx)
        return (dx if want_dx else None, dw if want_dw else None,
                None, None, None)


def kan_layer_fused_dw(
    x: torch.Tensor,
    w2: torch.Tensor,
    dp1: int,
    apply_tanh: bool = True,
    precision: str = "high",
) -> torch.Tensor:
    """Degree-wise fused layer: [B, in] x degree-major [dp1*in, T] -> [B, T].

    ``x`` is float32 or bfloat16, ``w2`` float32; the output is float32,
    differentiable in x and w2.  A CPU tensor runs the plain versions; a
    CUDA tensor launches the kernels (built from ``csrc/`` at first use),
    and each wrapper counts where it launches: a forward adds one to
    ``kan_layer_fused_dw.launches``, a backward its launches
    (``fused_bwd_launches``: one on the tensor cores, as at every layer of
    the flagship; on the CUDA cores one per degree chunk of each column
    slice of 64) to ``kan_layer_fused_dw.bwd_launches``,
    and where the forward splits the features (``fused_fwd_plan``) it
    adds one to ``fused_bwd_partial_sum.launches``.  Any T and dp1 >= 1.
    B = 0 launches nothing.
    """
    if torch.is_grad_enabled() and (x.requires_grad or w2.requires_grad):
        return _FusedDW.apply(x, w2, dp1, apply_tanh, precision)
    return _fused_dw_fwd(x, w2, dp1, apply_tanh, precision)


kan_layer_fused_dw.launches = 0
kan_layer_fused_dw.bwd_launches = 0


# -- v1 layer (K3 forward, K4 backward) -----------------------------------


def _fused_fwd(x, w2, dp1, apply_tanh, precision):
    _check_v1_precision(precision)
    if _device_of(x) == "cpu":
        return kan_layer_fused_reference(x, w2, dp1, apply_tanh, precision)
    return _launch_fwd("qkan_fused_fwd", x, w2, dp1, apply_tanh, ())


def _fused_bwd(x, w2, g, dp1, apply_tanh, precision, want_dx=True):
    _check_v1_precision(precision)
    if _device_of(x) == "cpu":
        return kan_layer_fused_bwd_reference(
            x, w2, g, dp1, apply_tanh, precision
        )
    return _launch_bwd("qkan_fused_bwd", x, w2, g, dp1, apply_tanh, (),
                       want_dx)


class _Fused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w2, dp1, apply_tanh, precision):
        ctx.save_for_backward(x, w2)
        ctx.args = (dp1, apply_tanh, precision)
        return _fused_fwd(x, w2, dp1, apply_tanh, precision)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, w2 = ctx.saved_tensors
        want_dx, want_dw = ctx.needs_input_grad[:2]
        dx, dw = _fused_bwd(x, w2, g, *ctx.args, want_dx=want_dx)
        return (dx if want_dx else None, dw if want_dw else None,
                None, None, None)


def kan_layer_fused(
    x: torch.Tensor,
    w2: torch.Tensor,
    dp1: int,
    apply_tanh: bool = True,
    precision: str = "high",
) -> torch.Tensor:
    """v1 fused layer: the same contract as ``kan_layer_fused_dw`` with the
    v1 rounding points (module docstring) and 'high'/'default' only.
    Counts ``kan_layer_fused.launches`` and ``.bwd_launches``."""
    if torch.is_grad_enabled() and (x.requires_grad or w2.requires_grad):
        return _Fused.apply(x, w2, dp1, apply_tanh, precision)
    return _fused_fwd(x, w2, dp1, apply_tanh, precision)


kan_layer_fused.launches = 0
kan_layer_fused.bwd_launches = 0

_COUNTER_OF.update({
    "qkan_fused_dw_fwd": (kan_layer_fused_dw, "launches"),
    "qkan_fused_dw_bwd": (kan_layer_fused_dw, "bwd_launches"),
    "qkan_fused_fwd": (kan_layer_fused, "launches"),
    "qkan_fused_bwd": (kan_layer_fused, "bwd_launches"),
})


# -- fused single-layer train step (K5) -----------------------------------


def _check_step_args(x, y, loss, precision) -> None:
    """The ValueErrors of the JAX wrapper, and an empty batch."""
    if loss not in ("sumsq", "mse"):
        raise ValueError(f"unknown loss {loss!r}: 'sumsq' or 'mse'")
    if loss == "mse" and y is None:
        raise ValueError("loss='mse' needs targets y")
    _check_v1_precision(precision)
    if x.dim() != 2 or x.shape[0] == 0:
        raise ValueError(
            f"x must be [B, in] with B >= 1, got {tuple(x.shape)}"
        )


def _step_scales(b: int, t_dim: int, loss: str) -> tuple:
    """(g = scale * err, loss = scale * sum err^2): 2 and 1 for 'sumsq',
    2 / (B*T) and 1 / (B*T) for 'mse'."""
    if loss == "sumsq":
        return 2.0, 1.0
    inv_b = 1.0 / float(b * t_dim)
    return 2.0 * inv_b, inv_b


def kan_train_step_fused_reference(
    x: torch.Tensor,
    w2: torch.Tensor,
    dp1: int,
    y: torch.Tensor | None = None,
    loss: str = "sumsq",
    apply_tanh: bool = True,
    precision: str = "default",
) -> tuple:
    """Plain torch version of the fused train step: the v1 forward at its
    rounding points (the basis in x's dtype, w2 cast to it), then err, g
    and the loss in f32, and dW = basis^T @ g with the basis widened to
    f32, as the v1 backward takes it.  Returns ``(loss, dw)``: a 0-dim f32
    tensor and [dp1*in, T] f32.  A float64 x (CPU only: the kernel takes
    f32 and bf16) keeps every step in float64 and returns float64."""
    _check_step_args(x, y, loss, precision)
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    t = torch.tanh(x) if apply_tanh else x
    basis = torch.cat(_cheb_blocks(t, dp1), dim=1)
    out = _dot_x_dtype(basis, w2.to(basis.dtype)).to(acc)
    err = out if loss == "sumsq" else out - y.to(acc)
    g_scale, loss_scale = _step_scales(x.shape[0], w2.shape[1], loss)
    total = (err * err).sum()
    dw = basis.to(acc).T @ (g_scale * err)
    return (total if loss == "sumsq" else loss_scale * total), dw.contiguous()


def _step_pass(x, w2, dp1, y, loss, apply_tanh, finish: bool = False):
    """K5 on x's card: (loss, the workspace of dW partials, dW or None).
    With ``finish`` the same library call launches the fixed-order pass
    too, into dW [dp1*in, T] f32.  The loss and dW are tensors of their
    own: keeping them does not keep the workspace.  Counts one
    ``kan_train_step_fused.launches`` a column slice
    (``fused_step_col_slice``) and, with ``finish``, one
    ``fused_bwd_partial_sum.launches``."""
    b, n, t_dim = _check_layer_args(x, w2, dp1)
    width = fused_step_col_slice(n, dp1, t_dim)
    if width == 0:
        raise ValueError(
            f"no train-step launch stages dp1={dp1} (its CUDA-core kernel "
            f"stages {_STEP_STAGE_BYTES} bytes at most)"
        )
    if loss == "mse":
        y = y.to(torch.float32).contiguous()
        if y.device != x.device or tuple(y.shape) != (b, t_dim):
            raise ValueError(
                f"y must be [{b}, {t_dim}] on {x.device}, got "
                f"{tuple(y.shape)} on {y.device}"
            )
    else:
        y = None  # 'sumsq' reads no targets: the kernel gets a null pointer
    from qkan_implementation_tpu_torch.ops._cuda_build import load_library

    lib = load_library()
    ws_bytes = lib.qkan_fused_step_workspace_bytes(b, n, dp1, t_dim)
    # K5's dW and colsum(g) partials (fused_step_layout), then one loss
    # partial per row block
    ws = torch.empty(ws_bytes, dtype=torch.uint8, device=x.device)
    loss_out = torch.empty((), dtype=torch.float32, device=x.device)
    dw = (torch.empty((dp1 * n, t_dim), dtype=torch.float32, device=x.device)
          if finish else None)
    g_scale, loss_scale = _step_scales(b, t_dim, loss)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.qkan_fused_step(
            x.data_ptr(), w2.data_ptr(),
            y.data_ptr() if y is not None else None, loss_out.data_ptr(),
            ws.data_ptr(), ws_bytes, b, n, dp1, t_dim,
            int(x.dtype == torch.bfloat16), int(bool(apply_tanh)), g_scale,
            loss_scale, dw.data_ptr() if finish else None, stream,
        )
    _raise_on_error(lib, err, "qkan_fused_step")
    _count(kan_train_step_fused, "launches", -(-t_dim // width))
    if finish:
        _count(fused_bwd_partial_sum, "launches")
    return loss_out, ws, dw


def _launch_step(x, w2, dp1, y, loss, apply_tanh):
    """K5 and the fixed-order dW pass, in one library call: (loss, dw) on
    x's card."""
    loss_out, _, dw = _step_pass(x, w2, dp1, y, loss, apply_tanh,
                                 finish=True)
    return loss_out, dw


def kan_train_step_fused(
    x: torch.Tensor,
    w2: torch.Tensor,
    dp1: int,
    y: torch.Tensor | None = None,
    loss: str = "sumsq",
    apply_tanh: bool = True,
    precision: str = "default",
    tile_b: int | None = None,
) -> tuple:
    """One fused single-layer train step: ``(loss, dW)`` with the
    Chebyshev basis built once, and neither it, ``out`` nor ``g`` written
    to device memory.

    ``loss='sumsq'``: L = sum(out^2) (the headline objective); ``'mse'``:
    L = mean((out - y)^2) over all B*T elements.  dX is not produced (the
    input is data).  ``x`` is float32 or bfloat16 (the v1 rounding points
    of ``kan_layer_fused``), ``w2`` and ``y`` float32; 'high' and
    'default' are both FP32-class products.  A CPU tensor runs
    ``kan_train_step_fused_reference``; a CUDA tensor launches the kernel
    ``qkan_fused_step`` (``csrc/fused_dw_bwd.cu``: counted on
    ``kan_train_step_fused.launches``) and the fixed-order dW pass (counted
    on ``fused_bwd_partial_sum.launches``) in one library call, or raises.
    The kernel runs on the tensor cores (3xTF32, the basis built once a
    64-row tile, a persistent grid) where ``fused_step_tensor_cores``
    takes the sizes, else as the CUDA-core kernel (the flagship's
    layer 0, dp1 = 1).

    Any B >= 1 is taken: the kernel masks the rows past B, so nothing is
    padded and 'mse' is not biased.  Any T and dp1 >= 1: past what one
    launch takes, the library call launches the CUDA-core kernel once a
    column slice (``fused_step_col_slice``), each counted.
    ``tile_b`` is accepted for the JAX signature and ignored (it set the
    TPU's batch tile).
    """
    del tile_b
    _check_step_args(x, y, loss, precision)
    if _device_of(x) == "cpu":
        return kan_train_step_fused_reference(x, w2, dp1, y, loss,
                                              apply_tanh, precision)
    return _launch_step(x, w2, dp1, y, loss, apply_tanh)


kan_train_step_fused.launches = 0
