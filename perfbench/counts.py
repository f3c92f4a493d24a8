"""Frozen operation and byte counts, and the H100's published peaks.

Everything here is counted from shapes alone, whatever implements the
work, so a later change to the kernels cannot make the counts stale.

A FixedKAN layer maps [B, in] to [B, T] through a degree-major weight
[(D+1)*in, T]: out = colsum(W_0) + sum_{d>=1} T_d(tanh x) @ W_d.  Every
layer is fit against the same T-column target, so its coefficients are
[out, in, D+1, T] with ``in`` the width of the data for the first layer
and T for the others; the fold sums the ``out`` neurons into the weight
before the product (``fixed_kan_dims``).

- Model FLOPs (``step_model_flops``): 2*B*in*(D+1)*T for each layer's
  forward, the same again for each layer's weight gradient, and again for
  the input gradient of every layer but the first (the data takes no
  gradient).
- A fused layer call's least time (``fused_step_bound_s``), as the kernel
  bound of the port's on-chip smoke test counts it: the degree-0 term is a
  column sum, so the products are 2*B*in*D*T; each operand is read once
  and each result written once, at 4 bytes.  The time is the larger of
  bytes over the HBM rate and 3 * FLOPs over the TF32 tensor-core rate
  (three TF32 passes make one float32 product on the tensor cores, the
  fastest units a float32 product has on this chip), so no route the
  kernels may take can beat it.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at the 700 W power limit
HBM_BYTES_PER_S = 3.35e12
TF32_FLOP_PER_S = 495e12
# a float32 product on the tensor cores: three TF32 passes
F32_TC_FLOP_PER_S = TF32_FLOP_PER_S / 3.0
F32 = 4  # bytes


def fixed_kan_dims(network_shape: list[int],
                   t_dim: int) -> list[tuple[int, int]]:
    """(in, T) of each layer's folded product: the data's width for the
    first layer, then T, since every layer maps to the T-column target."""
    return [(network_shape[0] if i == 0 else t_dim, t_dim)
            for i in range(len(network_shape) - 1)]


def forward_model_flops(dims, max_degree: int, batch: int) -> int:
    """Model FLOPs of one forward pass over ``batch`` rows."""
    dp1 = max_degree + 1
    return sum(2 * batch * n * dp1 * t for n, t in dims)


def step_model_flops(dims, max_degree: int, batch: int) -> int:
    """Model FLOPs of one training step: forward, every layer's weight
    gradient, and the input gradient of layers 1 and up."""
    dp1 = max_degree + 1
    per_layer = [2 * batch * n * dp1 * t for n, t in dims]
    return 2 * sum(per_layer) + sum(per_layer[1:])


def _bound_s(bytes_moved: float, flops: float) -> float:
    return max(bytes_moved / HBM_BYTES_PER_S, flops / F32_TC_FLOP_PER_S)


def fused_fwd_counts(batch: int, n: int, max_degree: int, t: int):
    """(bytes, FLOPs) of one fused forward call: reads x [B, in] and the
    weight [(D+1)*in, T], writes out [B, T]."""
    dp1 = max_degree + 1
    bytes_moved = F32 * (batch * n + dp1 * n * t + batch * t)
    return bytes_moved, 2 * batch * n * (dp1 - 1) * t


def fused_bwd_counts(batch: int, n: int, max_degree: int, t: int,
                     want_dx: bool):
    """(bytes, FLOPs) of one fused backward call: reads x and g [B, T],
    writes dW; with ``want_dx`` it also reads the weight and writes dx,
    and makes the second product."""
    dp1 = max_degree + 1
    x_b, w_b, bt_b = batch * n, dp1 * n * t, batch * t
    mm = 2 * batch * n * (dp1 - 1) * t
    if want_dx:
        return F32 * (2 * x_b + 2 * w_b + bt_b), 2 * mm
    return F32 * (x_b + w_b + bt_b), mm


def fused_step_bound_s(dims, max_degree: int, batch: int) -> float:
    """Least device seconds of the fused forward and backward calls of one
    training step (every layer's forward; every layer's backward, the
    first without dx)."""
    total = 0.0
    for i, (n, t) in enumerate(dims):
        total += _bound_s(*fused_fwd_counts(batch, n, max_degree, t))
        total += _bound_s(*fused_bwd_counts(batch, n, max_degree, t,
                                            want_dx=i > 0))
    return total

