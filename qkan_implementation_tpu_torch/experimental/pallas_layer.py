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
- CUDA kernels (``csrc/qkan_layer_m3.cu``) for f32 or bf16 x with f32 M3:
  K12 ``qkan_m3_fwd``, K13 ``qkan_m3_bwd`` with dx, K14 the same entry
  without dx, and the fixed-order sum of the backward's per-block dM
  partials (``m3_dm_partial_sum``).  A CUDA tensor launches them or
  raises (ValueError for an f64 tensor or an M3 over the kernels'
  shared-memory budget): there is no fallback to the plain version.

``qkan_layer_fused`` and ``qkan_layer_fused_dw`` are differentiable in x
and M3 through one ``torch.autograd.Function``: the backward runs K13 when
x needs a gradient and K14 when only dM is wanted (x is data), so the CPU
tests exercise the hand-written backward, not autograd's.
``qkan_layer_fused_dw`` always returns dx as exact zeros.  ``interpret``
is accepted for the JAX signature and ignored (it ran the TPU kernels in
Pallas interpret mode).  Launch counts, one a launch, nothing at B = 0:
``qkan_layer_fused.launches`` (K12), ``.bwd_launches`` (K13),
``.bwd_dw_launches`` (K14) and ``m3_dm_partial_sum.launches``.
"""

from __future__ import annotations

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

_MAX_DP1 = 32
# qkan_m3_smem_bytes's kinds
_FWD, _BWD, _BWD_DW = 0, 1, 2


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
    if not (1 <= dp1 <= _MAX_DP1 and n >= 1 and k >= 1):
        raise ValueError(
            f"the kernels take 1 <= D+1 <= {_MAX_DP1}, N >= 1 and K >= 1, "
            f"got m3 {tuple(m3.shape)}"
        )
    if not (x.is_contiguous() and m3.is_contiguous()):
        raise ValueError("x and m3 must be contiguous")
    from qkan_implementation_tpu_torch.ops._cuda_build import load_library

    lib = load_library()
    need, limit = lib.qkan_m3_smem_bytes(n, dp1, k, kind), lib.qkan_m3_smem_limit()
    if need > limit:
        raise ValueError(
            f"m3 {tuple(m3.shape)} needs {need} bytes of shared memory a "
            f"block, over the {limit} a block can have"
        )
    return lib, x.shape[0], n, dp1, k


def _launch_fwd(x: torch.Tensor, m3: torch.Tensor) -> torch.Tensor:
    """K12; counts its one launch, nothing at B = 0."""
    lib, b, n, dp1, k = _check_args(x, m3, _FWD)
    out = torch.empty((b, k), dtype=x.dtype, device=x.device)
    if b == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.qkan_m3_fwd(
            x.data_ptr(), m3.data_ptr(), out.data_ptr(), b, n, dp1, k,
            int(x.dtype == torch.bfloat16), stream,
        )
    _raise_on_error(lib, err, "qkan_m3_fwd")
    _count(qkan_layer_fused, "launches")
    return out


def _bwd_pass(x, m3, g, want_dx: bool):
    """K13 (``want_dx``) or K14: (dx or None, the per-block dM partials
    [nblk, D+1, N, K] f32, or None at B = 0)."""
    lib, b, n, dp1, k = _check_args(x, m3, _BWD if want_dx else _BWD_DW)
    g = g.to(x.dtype).contiguous()
    if g.device != x.device or tuple(g.shape) != (b, k):
        raise ValueError(
            f"g must be [{b}, {k}] on {x.device}, got {tuple(g.shape)} on "
            f"{g.device}"
        )
    dx = torch.empty_like(x) if want_dx else None
    if b == 0:
        return dx, None
    nblk = lib.qkan_m3_bwd_blocks(b, n, dp1, k, int(want_dx))
    part = torch.empty((nblk, dp1, n, k), dtype=torch.float32,
                       device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.qkan_m3_bwd(
            x.data_ptr(), m3.data_ptr(), g.data_ptr(),
            dx.data_ptr() if want_dx else None, part.data_ptr(),
            part.numel() * 4, b, n, dp1, k, int(x.dtype == torch.bfloat16),
            int(want_dx), stream,
        )
    _raise_on_error(lib, err, "qkan_m3_bwd")
    _count(qkan_layer_fused, "bwd_launches" if want_dx else "bwd_dw_launches")
    return dx, part


def m3_dm_partial_sum(part: torch.Tensor) -> torch.Tensor:
    """dM [D+1, N, K] f32 from a backward pass's partials [nblk, D+1, N, K]:
    their sum over blocks in a fixed order (kernel ``qkan_m3_dm_sum``).
    Counts ``m3_dm_partial_sum.launches``."""
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
    dx, part = _bwd_pass(x, m3, g, want_dx)
    if part is None:
        return dx, torch.zeros_like(m3)
    return dx, m3_dm_partial_sum(part)


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
