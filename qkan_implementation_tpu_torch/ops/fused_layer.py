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

``kan_layer_fused_dw`` and ``kan_layer_fused`` are differentiable in x and
w2 through one ``torch.autograd.Function`` each: forward and backward both
run the kernel on a CUDA tensor and the plain version on a CPU tensor, so
the CPU tests exercise the hand-written backward, not autograd's.

Precision.  'high' and 'default' are FP32 products with FP32 sums (CUDA
cores give true f32 products, so the TPU's bf16x3 split has no
counterpart).  The recurrences run in x's dtype, so a bf16 x rounds tanh
and every recurrence op to bf16.  Then:

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


# -- CUDA launches ----------------------------------------------------------


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
    if not 1 <= dp1 <= _MAX_DP1 or not 1 <= t_dim <= _MAX_T or n < 1:
        raise ValueError(
            f"the kernel takes 1 <= dp1 <= {_MAX_DP1}, 1 <= T <= {_MAX_T} "
            f"and in >= 1, got dp1={dp1}, T={t_dim}, in={n}"
        )
    if not (x.is_contiguous() and w2.is_contiguous()):
        raise ValueError("x and w2 must be contiguous")
    return b, n, t_dim


# the counter each C entry adds to when its kernel launches (filled in
# below, once the counters' owners exist)
_COUNTER_OF: dict = {}


def _launch_fwd(entry: str, x, w2, dp1, apply_tanh, extra: tuple):
    """Run a forward kernel (``qkan_fused_dw_fwd`` or ``qkan_fused_fwd``)
    and count its one launch; a B = 0 input launches and counts nothing."""
    b, n, t_dim = _check_layer_args(x, w2, dp1)
    out = torch.empty((b, t_dim), dtype=torch.float32, device=x.device)
    if b == 0:
        return out
    from qkan_implementation_tpu_torch.ops._cuda_build import load_library

    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, entry)(
            x.data_ptr(), w2.data_ptr(), out.data_ptr(), b, n, dp1, t_dim,
            int(x.dtype == torch.bfloat16), *extra, int(bool(apply_tanh)),
            stream,
        )
    _raise_on_error(lib, err, entry)
    _count(*_COUNTER_OF[entry])
    return out


def _bwd_pass(entry: str, x, w2, g, dp1, apply_tanh, extra: tuple,
              want_dx: bool):
    """The per-block pass of a backward kernel (``qkan_fused_dw_bwd`` or
    ``qkan_fused_bwd``): dx (or None) and the workspace of dW partials.
    Counts one launch per degree chunk (one at the flagship's dp1 and T);
    a B = 0 input launches and counts nothing."""
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
    ws_bytes = lib.qkan_fused_bwd_workspace_bytes(
        max(b, 1), n, dp1, t_dim, int(want_dx)
    )
    # per-block dW partials (and, past one degree chunk, dt): the kernel
    # allocates nothing itself
    ws = torch.empty(ws_bytes, dtype=torch.uint8, device=x.device)
    if b == 0:
        return dx, ws.zero_()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, entry)(
            x.data_ptr(), w2.data_ptr(), g.data_ptr(),
            dx.data_ptr() if want_dx else None, ws.data_ptr(), ws_bytes, b,
            n, dp1, t_dim, int(x.dtype == torch.bfloat16), *extra,
            int(bool(apply_tanh)), int(want_dx), stream,
        )
    _raise_on_error(lib, err, entry)
    _count(*_COUNTER_OF[entry], lib.qkan_fused_bwd_launches(dp1, t_dim))
    return dx, ws


def fused_bwd_partial_sum(ws, b, n, dp1, t_dim, want_dx=True):
    """dW [dp1*in, T] f32 from the workspace of a backward pass at these
    sizes: the partials summed over row blocks in a fixed order (kernel
    ``qkan_fused_bwd_partial_sum``).  Counts
    ``fused_bwd_partial_sum.launches``."""
    from qkan_implementation_tpu_torch.ops._cuda_build import load_library

    lib = load_library()
    dw = torch.empty((dp1 * n, t_dim), dtype=torch.float32, device=ws.device)
    with torch.cuda.device(ws.device):
        stream = torch.cuda.current_stream(ws.device).cuda_stream
        err = lib.qkan_fused_bwd_partial_sum(
            ws.data_ptr(), ws.numel(), dw.data_ptr(), max(b, 1), n, dp1,
            t_dim, int(want_dx), stream,
        )
    _raise_on_error(lib, err, "qkan_fused_bwd_partial_sum")
    _count(fused_bwd_partial_sum, "launches")
    return dw


fused_bwd_partial_sum.launches = 0


def fused_bwd_partial_sum_reference(ws, b, n, dp1, t_dim):
    """Plain torch version of ``fused_bwd_partial_sum``: the same sums
    over the [row blocks, ...] partials of a workspace on the card."""
    from qkan_implementation_tpu_torch.ops._cuda_build import load_library

    nrb = load_library().qkan_fused_bwd_row_blocks(max(b, 1), n, dp1, t_dim)
    f = ws.view(torch.float32)
    per_rb = (dp1 - 1) * n * t_dim
    part = f[: nrb * per_rb].view(nrb, (dp1 - 1) * n, t_dim).sum(dim=0)
    gsum = f[nrb * per_rb : nrb * (per_rb + t_dim)].view(nrb, t_dim)
    return torch.cat([gsum.sum(dim=0).expand(n, -1), part])


def _launch_bwd(entry, x, w2, g, dp1, apply_tanh, extra, want_dx):
    """A backward kernel and its fixed-order sum: (dx or None, dw)."""
    dx, ws = _bwd_pass(entry, x, w2, g, dp1, apply_tanh, extra, want_dx)
    b, n = x.shape
    return dx, fused_bwd_partial_sum(ws, b, n, dp1, w2.shape[1], want_dx)


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
    ``kan_layer_fused_dw.launches``, a backward one per degree chunk (one
    where dp1 - 1 degrees fit in registers, as at the flagship) to
    ``kan_layer_fused_dw.bwd_launches``.  B = 0 launches nothing.
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
    tensor and [dp1*in, T] f32."""
    _check_step_args(x, y, loss, precision)
    t = torch.tanh(x) if apply_tanh else x
    basis = torch.cat(_cheb_blocks(t, dp1), dim=1)
    out = _dot_x_dtype(basis, w2.to(basis.dtype)).to(torch.float32)
    err = out if loss == "sumsq" else out - y.to(torch.float32)
    g_scale, loss_scale = _step_scales(x.shape[0], w2.shape[1], loss)
    total = (err * err).sum()
    dw = basis.to(torch.float32).T @ (g_scale * err)
    return (total if loss == "sumsq" else loss_scale * total), dw.contiguous()


def _launch_step(x, w2, dp1, y, loss, apply_tanh):
    """K5 and the fixed-order dW pass: (loss, dw) on x's card."""
    b, n, t_dim = _check_layer_args(x, w2, dp1)
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
    # K2's dW and colsum(g) partials, then one loss partial per row block
    ws = torch.empty(ws_bytes, dtype=torch.uint8, device=x.device)
    loss_out = torch.empty((), dtype=torch.float32, device=x.device)
    g_scale, loss_scale = _step_scales(b, t_dim, loss)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.qkan_fused_step(
            x.data_ptr(), w2.data_ptr(),
            y.data_ptr() if y is not None else None, loss_out.data_ptr(),
            ws.data_ptr(), ws_bytes, b, n, dp1, t_dim,
            int(x.dtype == torch.bfloat16), int(bool(apply_tanh)), g_scale,
            loss_scale, stream,
        )
    _raise_on_error(lib, err, "qkan_fused_step")
    _count(kan_train_step_fused, "launches")
    return loss_out, fused_bwd_partial_sum(ws, b, n, dp1, t_dim, False)


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
    'default' are both FP32 products.  A CPU tensor runs
    ``kan_train_step_fused_reference``; a CUDA tensor launches the kernel
    ``qkan_fused_step`` (``csrc/fused_dw_bwd.cu``: counted on
    ``kan_train_step_fused.launches``) and then the fixed-order dW pass
    (counted on ``fused_bwd_partial_sum.launches``), or raises.

    Any B >= 1 is taken: the kernel masks the rows past B, so nothing is
    padded and 'mse' is not biased.  ``tile_b`` is accepted for the JAX
    signature and ignored (it set the TPU's batch tile).
    """
    del tile_b
    _check_step_args(x, y, loss, precision)
    if _device_of(x) == "cpu":
        return kan_train_step_fused_reference(x, w2, dp1, y, loss,
                                              apply_tanh, precision)
    return _launch_step(x, w2, dp1, y, loss, apply_tanh)


kan_train_step_fused.launches = 0
