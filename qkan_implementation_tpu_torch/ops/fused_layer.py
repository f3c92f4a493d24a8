"""Degree-wise fused FixedKAN layer: tanh -> Chebyshev recurrence -> matmul.

Counterpart of ``qkan_implementation_tpu.ops.fused_layer`` (the v2
degree-wise schedule, ``kan_layer_fused_dw``).  The layer is

    out = colsum(W_0) + sum_{d>=1} T_d(t) @ W_d,    t = tanh(x) (or x),

with ``w2`` DEGREE-MAJOR: ``W_d = w2[d*in:(d+1)*in]``.  The fold of
per-output coefficients, degree mask and horizontal weights into ``w2`` is
the caller's (``models.fixed_kan.kan_layer_apply``).

Two versions of one function:

- ``kan_layer_fused_dw_reference``: plain torch ops, the same math and the
  same bf16 rounding points as the kernel.  It serves CPU tensors and is
  the yardstick the kernel is held against on the card.
- the CUDA kernel ``csrc/fused_dw_fwd.cu``, which builds each T_d tile in
  registers and contracts it at once, so the [B, dp1*in] basis never
  reaches device memory.  A CUDA tensor launches it or raises: there is no
  fallback to the plain version.

Precision modes: 'high' and 'default' are FP32 products with FP32 sums
(CUDA cores give true f32 products, so the TPU's bf16x3 split has no
counterpart); 'bf16' rounds T_d and W_d (d >= 1) to bf16 before each
product and accumulates in f32.  The recurrence runs in x's dtype, so a
bf16 x rounds tanh and every recurrence op to bf16.

Forward only: the backward kernel (TPU ``_bwd_kernel_degreewise``) is
ROADMAP queue 2; until it lands a CUDA input that requires grad raises.
"""

from __future__ import annotations

import threading

import torch

_MAX_DP1 = 32
_MAX_T = 64


def _resolve_mode(precision: str) -> str:
    """'high' | 'default' -> 'plain' (f32 products); 'bf16' -> 'bf16'."""
    if precision not in ("high", "default", "bf16"):
        raise ValueError(
            f"unknown fused precision {precision!r}: "
            "'high', 'default', or 'bf16'"
        )
    return "bf16" if precision == "bf16" else "plain"


def _dot_md(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """a @ b with f32 accumulation; 'bf16' rounds both operands first.

    bf16 operands widened to f32 multiply exactly, so the f32 matmul is
    the one-pass bf16 product with f32 accumulation.
    """
    if mode == "bf16":
        a = a.to(torch.bfloat16)
        b = b.to(torch.bfloat16)
    return a.to(torch.float32) @ b.to(torch.float32)


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


def kan_layer_fused_dw(
    x: torch.Tensor,
    w2: torch.Tensor,
    dp1: int,
    apply_tanh: bool = True,
    precision: str = "high",
) -> torch.Tensor:
    """Degree-wise fused layer: [B, in] x degree-major [dp1*in, T] -> [B, T].

    ``x`` is float32 or bfloat16, ``w2`` float32; the output is float32.
    A CPU tensor runs the plain version; a CUDA tensor launches the
    kernel (built from ``csrc/`` at first use) and adds one to
    ``kan_layer_fused_dw.launches``.
    """
    mode = _resolve_mode(precision)
    if x.device.type == "cpu":
        return kan_layer_fused_dw_reference(x, w2, dp1, apply_tanh, precision)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}: 'cpu' or 'cuda'")
    return _launch_cuda(x, w2, dp1, apply_tanh, mode)


kan_layer_fused_dw.launches = 0
# server threads launch concurrently: the count's read-modify-write is locked
_LAUNCHES_LOCK = threading.Lock()


def _launch_cuda(x, w2, dp1, apply_tanh, mode):
    if torch.is_grad_enabled() and (x.requires_grad or w2.requires_grad):
        raise NotImplementedError(
            "kan_layer_fused_dw on CUDA is forward-only: the backward "
            "kernel K2 (_bwd_kernel_degreewise) is ROADMAP queue 2; run "
            "under torch.inference_mode() or torch.no_grad()"
        )
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
    if not 1 <= dp1 <= _MAX_DP1 or not 1 <= t_dim <= _MAX_T or n < 1:
        raise ValueError(
            f"the kernel takes 1 <= dp1 <= {_MAX_DP1}, 1 <= T <= {_MAX_T} "
            f"and in >= 1, got dp1={dp1}, T={t_dim}, in={n}"
        )
    if not (x.is_contiguous() and w2.is_contiguous()):
        raise ValueError("x and w2 must be contiguous")
    out = torch.empty((b, t_dim), dtype=torch.float32, device=x.device)
    if b == 0:
        return out
    from qkan_implementation_tpu_torch.ops._cuda_build import load_library

    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.qkan_fused_dw_fwd(
            x.data_ptr(), w2.data_ptr(), out.data_ptr(), b, n, dp1, t_dim,
            int(x.dtype == torch.bfloat16), int(mode == "bf16"),
            int(bool(apply_tanh)), stream,
        )
    if err != 0:
        name = lib.qkan_cuda_error_string(err).decode()
        raise RuntimeError(f"fused_dw_fwd launch failed: {name} ({err})")
    with _LAUNCHES_LOCK:
        kan_layer_fused_dw.launches += 1
    return out
