"""The batched QKAN layer over the degree-major contraction tensor M3.

Counterpart of ``qkan_implementation_tpu.experimental.pallas_layer``: the
layer forward and its backward with the Chebyshev basis never written to
device memory.  With M3 [D+1, N, K] (``weights_to_m3``) and raw x [B, N]:

    out[b, k]   = sum_{d, n} T_d(x[b, n]) M3[d, n, k]
    dM[d, n, k] = sum_b T_d(x[b, n]) g[b, k]        (dM[0, n, :] = colsum(g))
    dx[b, n]    = sum_{d>=1} d U_{d-1}(x[b, n]) (g @ M3[d]^T)[b, n]

x is NOT clipped, unlike ``ops.qkan_layer.qkan_layer_forward_batched``
(its ``chebyshev_basis`` clips to [-1, 1]): the two agree for |x| <= 1 and
differ outside, as the JAX module's do.  ``weights_to_m3(w, N, K)
.reshape((D+1)*N, K)`` is also the degree-major ``w2`` that
``ops.fused_layer.kan_train_step_fused`` takes with ``apply_tanh=False``.

Dtypes, as the JAX kernels round: out and dx are in x's dtype, dM in M3's.
The recurrences run in x's dtype (a bf16 x rounds every op to bf16); every
contraction returns f32 (JAX's ``preferred_element_type``): bf16 operands
widen exactly, and f64 operands (CPU only) multiply in f64 and round to
f32.  The output cotangent g is taken in x's dtype.

Each function has two versions:

- a plain torch version (``qkan_layer_fused_reference``,
  ``qkan_layer_fused_bwd_reference``) with those rounding points, which
  CPU tensors take (f32, bf16 or f64) and which the kernels are held to on
  the card;
- CUDA kernels for f32 or bf16 x with f32 M3, behind two C entries: K12
  ``qkan_m3_fwd``, K13 ``qkan_m3_bwd`` with dx, K14 the same entry
  without dx, and the fixed-order sum of the backward's per-block dM
  partials (``csrc/partial_sum.cu``), which ``qkan_m3_bwd`` launches in
  the same library call (one call a backward; ``m3_dm_partial_sum`` runs
  it alone; ``ops.fused_layer.fixed_order_sum_reference`` is its plain
  version in its own order).  The entries pick each call's route by the
  sizes and x's dtype alone (``m3_tc_plan``, the mirror of the C entry
  ``qkan_m3_tc_plan``): K12, K13 and K14 on an f32 x whose M3 one launch
  takes whole run on the tensor cores (``csrc/qkan_layer_m3_tc.cu``,
  3xTF32 ``mma.sync``, the basis built in registers in the fragments'
  order; K13 is K14's warps plus dx from the same staged rows); a bf16 x
  and what the plan refuses run the CUDA-core kernels
  (``csrc/qkan_layer_m3.cu``).  A CUDA tensor launches them or
  raises (ValueError for an f64 tensor): there is no fallback to the
  plain version.  Any M3 and any D+1: where a CUDA-core kernel's staging
  of M3 overflows one block's shared memory, the entry runs it over
  slices of M3 (``m3_slices``: output columns first, then features),
  each a launch, the sums that cross slices carried in f32 in launch
  order.  Both routes keep the backward's block layout
  (``m3_bwd_layout``), so the dM partials and their pass are the same.

``qkan_layer_fused`` and ``qkan_layer_fused_dw`` are differentiable in x
and M3 through one ``torch.autograd.Function``: the backward runs K13 when
x needs a gradient and K14 when only dM is wanted (x is data), so the CPU
tests exercise the hand-written backward, not autograd's.
``qkan_layer_fused_dw`` always returns dx as exact zeros.  ``interpret``
is accepted for the JAX signature and ignored (it ran the TPU kernels in
Pallas interpret mode).  Launch counts, one a launch, nothing at B = 0:
``qkan_layer_fused.launches`` (K12), ``.bwd_launches`` (K13),
``.bwd_dw_launches`` (K14), one each per slice, and
``m3_dm_partial_sum.launches``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from qkan_implementation_tpu_torch.ops._cuda_build import (
    count_launches as _count,
    raise_on_error as _raise_on_error,
)
from qkan_implementation_tpu_torch.ops.fused_layer import _cheb_blocks
from qkan_implementation_tpu_torch.ops.qkan_layer import qkan_weight_tensor
from qkan_implementation_tpu_torch.utils.platform import (
    tensor_device_type as _device_of,
)

# qkan_m3_smem_bytes's kinds
_FWD, _BWD, _BWD_DW = 0, 1, 2
# the constants of csrc/qkan_layer_m3.cu that m3_slices and m3_bwd_layout
# mirror, and those of csrc/m3_tc.cuh that m3_tc_plan mirrors
_THREADS, _DC, _SMEM_LIMIT = 256, 8, 232448
_MAX_BLOCKS, _PART_BUDGET = 264, 16 << 20
_TC_RING, _TC_CHUNK, _TC_GS, _TC_DPG = 2, 32, 24, 8


def _geo(n: int, k: int) -> tuple:
    """(KP, KC, XS, GS): the tile widths of ``geo()``."""
    kp = 4 if k <= 4 else 8 if k <= 8 else 16 if k <= 16 else -(-k // 32) * 32
    return kp, min(kp, 32), n | 1, kp if (kp // 4) % 2 else kp + 4


def _fits(n: int, dp1: int, k: int, kind: int) -> bool:
    """Whether a kernel of ``kind`` stages an M3 slice of n features and
    k columns at its narrowest tile (32 rows) within a block."""
    kp, kc, xs, gs = _geo(n, k)
    m3 = dp1 * n * kp
    if kind == _FWD:
        need = 4 * (m3 + 32 * xs + 32 * (kc + 1))
    else:
        tiles = max(32 * (xs + gs), _THREADS * _DC * 4)
        need = 4 * ((m3 if kind == _BWD else 0) + tiles)
    return need <= _SMEM_LIMIT


def m3_slices(n: int, dp1: int, k: int, kind: int) -> tuple:
    """(features, columns) of the M3 slice one launch of ``kind`` (0 the
    forward, 1 the backward with dx, 2 the weight-only backward) takes:
    the plain mirror of ``m3_slices()`` in ``csrc/qkan_layer_m3.cu`` (C
    entries ``qkan_m3_slice_n`` / ``qkan_m3_slice_k``).  All of M3 where it
    fits; else the columns in steps of 32 down to 32, then 16, 8, 4; where
    4 columns still overflow, the features halved (rounded up) until the
    slice fits."""
    kw = k
    while kw > 4 and not _fits(n, dp1, kw, kind):
        kw = (kw - 1) // 32 * 32 if kw > 32 else 16 if kw > 16 else \
            8 if kw > 8 else 4
    nw = n
    while nw > 1 and not _fits(nw, dp1, kw, kind):
        nw = (nw + 1) // 2
    return nw, kw


def m3_bwd_layout(b: int, n: int, dp1: int, k: int, want_dx: bool) -> tuple:
    """(tile rows, rows a block, blocks) of a backward call: the plain
    mirror of ``bwd_layout()`` in ``csrc/qkan_layer_m3.cu`` (blocks: C
    entry ``qkan_m3_bwd_blocks``), the same on both routes.  At most 264
    blocks, fewer where the dM partials would pass 16 MB; a block's rows
    are whole tiles of the CUDA-core kernel's widest slice."""
    nw, kw = m3_slices(n, dp1, k, _BWD if want_dx else _BWD_DW)
    kp, _, xs, gs = _geo(nw, kw)
    tr = next((r for r in (256, 128, 64, 32)
               if 4 * ((dp1 * nw * kp if want_dx else 0)
                       + max(r * (xs + gs), _THREADS * _DC * 4))
               <= _SMEM_LIMIT), 32)
    cap = max(1, min(_MAX_BLOCKS, _PART_BUDGET // (dp1 * n * k * 4)))
    rows = -(-(-(-b // tr)) // cap) * tr
    return tr, rows, -(-b // rows)


class M3TcPlan(NamedTuple):
    """The tensor-core plan of one call (``m3_tc_plan``); all zeros where
    the call runs the CUDA-core kernels."""

    ok: int    # 1: the call runs the tensor-core kernel
    s: int     # k-steps of 8 features a degree (N padded to 8 s)
    xs: int    # the x stage's row stride, floats
    mt: int    # K12: m16-tiles (16 rows) a warp's task
    ntw: int   # K12: n8-tiles of K a warp
    ng: int    # K12: groups of ntw n8-tiles
    mg: int    # K13/K14: m16-tiles of K (16 columns of g a warp)
    dgn: int   # K13/K14: degree groups
    dpg: int   # K13/K14: degrees a group
    wr: int    # K13/K14: row splits (warps) a group in a block
    gy: int    # K13/K14: the grid's second dimension
    smem: int  # a block's dynamic shared memory, bytes


def m3_tc_plan(n: int, dp1: int, k: int, kind: int,
               x_bf16: bool = False) -> M3TcPlan:
    """The route and tiling of a call of ``kind`` (0: K12, 1: K13, 2: K14)
    at these sizes and x dtype: the plain mirror of ``tc_plan()`` in
    ``csrc/qkan_layer_m3.cu`` (C entry ``qkan_m3_tc_plan``).  The tensor
    cores take a call on an f32 x where one launch takes the whole M3
    (``m3_slices`` cuts nothing) and the block's shared memory fits: K12
    stages M3's fragments {hi, lo} of degrees 1..D beside 8 warps' rings of
    2 stages; K14 stages no M3; K13 is K14's warps with the block's groups'
    M3[d]^T fragments {hi, lo} and, where a feature group's dx adds the
    partials of p = mg * dgn > 1 warps, their two buffers; it takes p <= 8
    (a feature group's warps in one block).  A bf16 x and the rest run the
    CUDA-core kernels (all fields 0)."""
    off = M3TcPlan(*[0] * 12)
    if (x_bf16 or kind not in (_FWD, _BWD, _BWD_DW) or min(n, dp1, k) < 1
            or m3_slices(n, dp1, k, kind) != (n, k)):
        return off
    d, s = dp1 - 1, -(-n // 8)
    if kind == _FWD:
        xs = 8 * s + 8 if (8 * s) % 16 == 0 else 8 * s
        nt = -(-k // 8)
        ntw = 1 if nt <= 1 else 2 if nt <= 2 else 4 if nt <= 4 else 8
        ng, mt = -(-nt // ntw), 4 if ntw == 1 else 2
        smem = (16 * d * s * ng * ntw * 32 + 4 * 8 * ng * ntw
                + 4 * 8 * _TC_RING * 16 * mt * xs)
        return M3TcPlan(1, s, xs, mt, ntw, ng, 0, 0, 0, 0, 0, smem) \
            if smem <= _SMEM_LIMIT else off
    mg = -(-k // 16)
    dgn = 1 if d <= _TC_DPG else -(-d // _TC_DPG)
    dpg = -(-d // dgn)
    groups = mg * s * dgn
    smem = max(4 * 8 * _TC_RING * _TC_CHUNK * (8 + _TC_GS),
               4 * 8 * 32 * 4 * (_TC_DPG + 1))
    per_blk = 8  # groups a block
    if kind == _BWD:
        pg = mg * dgn  # the warps whose dx partials add up
        if pg > 8:
            return off
        per_blk = 8 // pg * pg
        smem += (16 * min(groups, per_blk) * dpg * 2 * 32
                 + (4 * 2 * 8 * _TC_CHUNK * 8 if pg > 1 else 0))
    plan = M3TcPlan(1, s, 8, 0, 0, 0, mg, dgn, dpg,
                    1 if groups >= 8 else 8 // groups, -(-groups // per_blk),
                    smem)
    return plan if smem <= _SMEM_LIMIT else off


def library_m3_tc_plan(n: int, dp1: int, k: int, kind: int,
                       x_bf16: bool = False) -> M3TcPlan:
    """``m3_tc_plan`` as the built library computes it (C entry
    ``qkan_m3_tc_plan``; needs the CUDA build)."""
    from qkan_implementation_tpu_torch.ops._cuda_build import load_library

    out = (ctypes.c_longlong * 12)()
    load_library().qkan_m3_tc_plan(n, dp1, k, kind, int(x_bf16), out)
    return M3TcPlan(*out)


def _dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as ``jnp.dot(..., preferred_element_type=float32)``: the
    product in the operands' promoted dtype (f32 at least), rounded to
    f32."""
    acc = torch.promote_types(torch.promote_types(a.dtype, b.dtype),
                              torch.float32)
    return (a.to(acc) @ b.to(acc)).to(torch.float32)


# -- plain versions -------------------------------------------------------


def qkan_layer_fused_reference(x: torch.Tensor, m3: torch.Tensor) -> torch.Tensor:
    """Plain torch forward: the degree-major basis [B, (D+1)*N] in x's
    dtype, then one product with M3 [(D+1)*N, K].  -> [B, K] in x's dtype."""
    dp1, n, k = m3.shape
    basis = torch.cat(_cheb_blocks(x, dp1), dim=1)
    return _dot_f32(basis, m3.reshape(dp1 * n, k)).to(x.dtype)


def qkan_layer_fused_bwd_reference(
    x: torch.Tensor, m3: torch.Tensor, g: torch.Tensor, want_dx: bool = True
) -> tuple:
    """Plain torch backward: ``(dx, dm)``, dx [B, N] in x's dtype (None
    when ``want_dx`` is false) and dM [D+1, N, K] in M3's dtype.  dM is
    basis^T @ g; dx sums d * U_{d-1}(x) * (g @ M3[d]^T) over d >= 1 in f32
    (f64 when x is f64), U by its recurrence in x's dtype."""
    dp1, n, k = m3.shape
    g = g.to(x.dtype)
    basis = torch.cat(_cheb_blocks(x, dp1), dim=1)
    dm = _dot_f32(basis.T, g).to(m3.dtype).reshape(m3.shape)
    if not want_dx:
        return None, dm
    m2 = m3.reshape(dp1 * n, k)
    us = [torch.ones_like(x), 2.0 * x]  # U_0, U_1
    for _ in range(3, dp1):
        us.append(2.0 * x * us[-1] - us[-2])
    dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for d in range(1, dp1):
        gm = _dot_f32(g, m2[d * n : (d + 1) * n].T)
        dx = dx + (float(d) * us[d - 1]) * gm
    return dx.to(x.dtype), dm


def m3_dm_partial_sum_reference(part: torch.Tensor) -> torch.Tensor:
    """Plain torch version of ``m3_dm_partial_sum``."""
    return part.sum(dim=0)


# -- CUDA launches ----------------------------------------------------------


def _check_args(x: torch.Tensor, m3: torch.Tensor, kind: int):
    """What the kernels take; returns (library, B, N, dp1, K)."""
    if m3.device != x.device:
        raise ValueError(f"x is on {x.device} but m3 is on {m3.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(
            f"x must be float32 or bfloat16 on the card, got {x.dtype}"
        )
    if m3.dtype != torch.float32:
        raise ValueError(f"m3 must be float32 on the card, got {m3.dtype}")
    if x.dim() != 2 or m3.dim() != 3 or m3.shape[1] != x.shape[1]:
        raise ValueError(
            f"expected x [B, N] and m3 [D+1, N, K], got {tuple(x.shape)} "
            f"and {tuple(m3.shape)}"
        )
    dp1, n, k = m3.shape
    if not (dp1 >= 1 and n >= 1 and k >= 1):
        raise ValueError(
            f"the kernels take D+1, N and K >= 1, got m3 {tuple(m3.shape)}"
        )
    if not (x.is_contiguous() and m3.is_contiguous()):
        raise ValueError("x and m3 must be contiguous")
    from qkan_implementation_tpu_torch.ops._cuda_build import load_library

    lib = load_library()
    launches = lib.qkan_m3_launches(n, dp1, k, kind)
    return lib, x.shape[0], n, dp1, k, launches


def _launch_fwd(x: torch.Tensor, m3: torch.Tensor) -> torch.Tensor:
    """K12; counts its launches (one a slice of M3), nothing at B = 0."""
    lib, b, n, dp1, k, launches = _check_args(x, m3, _FWD)
    out = torch.empty((b, k), dtype=x.dtype, device=x.device)
    if b == 0:
        return out
    # out's f32 sums carried across feature slices, where there are some
    carry_bytes = (lib.qkan_m3_carry_bytes(b, n, dp1, k, _FWD)
                   if launches > 1 else 0)
    carry = (torch.empty(carry_bytes, dtype=torch.uint8, device=x.device)
             if carry_bytes else None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.qkan_m3_fwd(
            x.data_ptr(), m3.data_ptr(), out.data_ptr(),
            carry.data_ptr() if carry is not None else None, carry_bytes, b,
            n, dp1, k, int(x.dtype == torch.bfloat16), stream,
        )
    _raise_on_error(lib, err, "qkan_m3_fwd")
    _count(qkan_layer_fused, "launches", launches)
    return out


def _bwd_pass(x, m3, g, want_dx: bool, finish: bool = False):
    """K13 (``want_dx``) or K14: (dx or None, the per-block dM partials
    [nblk, D+1, N, K] f32 or None at B = 0, dM or None).  With ``finish``
    the same library call launches the fixed-order pass too (counted on
    ``m3_dm_partial_sum.launches``), into dM [D+1, N, K] f32, a tensor of
    its own; at B = 0 dM is zeros and nothing launches.  Counts one launch
    a slice of M3 (``m3_slices``)."""
    kind = _BWD if want_dx else _BWD_DW
    lib, b, n, dp1, k, launches = _check_args(x, m3, kind)
    g = g.to(x.dtype).contiguous()
    if g.device != x.device or tuple(g.shape) != (b, k):
        raise ValueError(
            f"g must be [{b}, {k}] on {x.device}, got {tuple(g.shape)} on "
            f"{g.device}"
        )
    dx = torch.empty_like(x) if want_dx else None
    if b == 0:
        return dx, None, torch.zeros_like(m3) if finish else None
    nblk = lib.qkan_m3_bwd_blocks(b, n, dp1, k, int(want_dx))
    # the partials, then dx's f32 sums carried across column slices
    carry = (lib.qkan_m3_carry_bytes(b, n, dp1, k, kind) // 4
             if launches > 1 else 0)
    buf = torch.empty(nblk * dp1 * n * k + carry, dtype=torch.float32,
                      device=x.device)
    part = buf[: nblk * dp1 * n * k].view(nblk, dp1, n, k)
    dm = (torch.empty((dp1, n, k), dtype=torch.float32, device=x.device)
          if finish else None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.qkan_m3_bwd(
            x.data_ptr(), m3.data_ptr(), g.data_ptr(),
            dx.data_ptr() if want_dx else None, buf.data_ptr(),
            buf.numel() * 4, b, n, dp1, k, int(x.dtype == torch.bfloat16),
            int(want_dx), dm.data_ptr() if finish else None, stream,
        )
    _raise_on_error(lib, err, "qkan_m3_bwd")
    _count(qkan_layer_fused, "bwd_launches" if want_dx else "bwd_dw_launches",
           launches)
    if finish:
        _count(m3_dm_partial_sum, "launches")
    return dx, part, dm


def m3_dm_partial_sum(part: torch.Tensor) -> torch.Tensor:
    """dM [D+1, N, K] f32 from a backward pass's partials [nblk, D+1, N, K]:
    their sum over blocks in the fixed order of ``ops.fused_layer``'s
    ``fixed_order_sum_reference(part, partial_sum_segments(nblk, per))``
    (the pass alone, entry ``qkan_m3_dm_sum``; the backward launches it
    itself).  Counts ``m3_dm_partial_sum.launches``, as the backward does
    where it launches the pass."""
    from qkan_implementation_tpu_torch.ops._cuda_build import load_library

    lib = load_library()
    dm = torch.empty(part.shape[1:], dtype=torch.float32, device=part.device)
    with torch.cuda.device(part.device):
        stream = torch.cuda.current_stream(part.device).cuda_stream
        err = lib.qkan_m3_dm_sum(part.data_ptr(), dm.data_ptr(),
                                 part.shape[0], dm.numel(), stream)
    _raise_on_error(lib, err, "qkan_m3_dm_sum")
    _count(m3_dm_partial_sum, "launches")
    return dm


m3_dm_partial_sum.launches = 0


def _launch_bwd(x, m3, g, want_dx: bool) -> tuple:
    """K13 or K14 and the dM pass, in one library call: (dx or None, dm)."""
    dx, _, dm = _bwd_pass(x, m3, g, want_dx, finish=True)
    return dx, dm


# -- the layer --------------------------------------------------------------


def _fwd(x, m3):
    if _device_of(x) == "cpu":
        return qkan_layer_fused_reference(x, m3)
    return _launch_fwd(x, m3)


def _bwd(x, m3, g, want_dx):
    if _device_of(x) == "cpu":
        return qkan_layer_fused_bwd_reference(x, m3, g, want_dx)
    return _launch_bwd(x, m3, g, want_dx)


class _LayerM3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, m3, dw_only):
        ctx.save_for_backward(x, m3)
        ctx.dw_only = dw_only
        return _fwd(x, m3)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, m3 = ctx.saved_tensors
        want_dx, want_dm = ctx.needs_input_grad[:2]
        kernel_dx = want_dx and not ctx.dw_only
        dx, dm = _bwd(x, m3, g, kernel_dx)
        if want_dx and ctx.dw_only:
            dx = torch.zeros_like(x)
        return dx if want_dx else None, dm if want_dm else None, None


def _apply(x, m3, dw_only):
    if torch.is_grad_enabled() and (x.requires_grad or m3.requires_grad):
        return _LayerM3.apply(x, m3, dw_only)
    return _fwd(x, m3)


def qkan_layer_fused(x: torch.Tensor, m3: torch.Tensor,
                     interpret: bool = False) -> torch.Tensor:
    """Fused batched layer forward: [B, N] x [D+1, N, K] -> [B, K].

    ``m3`` is the layer's contraction tensor in degree-major layout
    (``weights_to_m3``).  Differentiable in both arguments; the backward
    launches K13 when x needs a gradient, else K14 (module docstring).
    """
    del interpret
    return _apply(x, m3, False)


qkan_layer_fused.launches = 0
qkan_layer_fused.bwd_launches = 0
qkan_layer_fused.bwd_dw_launches = 0


def qkan_layer_fused_dw(x: torch.Tensor, m3: torch.Tensor,
                        interpret: bool = False) -> torch.Tensor:
    """The forward of ``qkan_layer_fused``; its backward computes only dM
    (K14) and returns dx as exact zeros.

    For weight-only training where x is data.  Do not put it under layers
    whose inputs carry a gradient: the zero dx cuts the chain rule there.
    """
    del interpret
    return _apply(x, m3, True)


def weights_to_m3(weights: torch.Tensor, N: int, K: int) -> torch.Tensor:
    """Per-degree weight vectors [D+1, N*K] -> fused tensor [D+1, N, K]."""
    return qkan_weight_tensor(weights, N, K).permute(2, 1, 0).contiguous()


def qkan_layer_forward_batched_fused(
    x: torch.Tensor, weights: torch.Tensor, N: int, K: int,
    interpret: bool = False,
) -> torch.Tensor:
    """Drop-in fused equivalent of ``qkan_layer_forward_batched`` for
    |x| <= 1 (this layer does not clip); differentiable in ``weights``
    through ``weights_to_m3``."""
    return qkan_layer_fused(x, weights_to_m3(weights, N, K), interpret)
