"""Operation and byte counts of the QKAN layer's training step, counted
from shapes alone, and its least time on the H100 at the peaks of
``counts``.

A QKANLayer maps x [B, N] to [B, K] through the degree-major weight w2
[(D+1)*N, K] that the trainer folds its weights into:
out = colsum(W_0) + sum_{d>=1} T_d(x) @ W_d.

- Model FLOPs of a step (``step_model_flops``): 2*B*N*(D+1)*K for the
  forward and the same again for the weight gradient (the data take no
  gradient).
- The fused step's least time (``fused_step_bound_s``): the degree-0
  term is a column sum, so the products are 2*B*N*D*K for the forward
  and as many for dW; x, y and w2 are read once, dW and the loss
  written once, at 4 bytes.  The time is the larger of bytes over the
  HBM rate and the FLOPs over the float32 tensor-core rate (three TF32
  passes a product), as ``counts.fused_step_bound_s`` bounds the
  FixedKAN layers.
"""

from __future__ import annotations

from perfbench.counts import F32, F32_TC_FLOP_PER_S, HBM_BYTES_PER_S


def step_model_flops(batch: int, n: int, max_degree: int, k: int) -> int:
    """Model FLOPs of one training step: forward and weight gradient."""
    return 2 * (2 * batch * n * (max_degree + 1) * k)


def fused_step_counts(batch: int, n: int, max_degree: int, k: int):
    """(bytes, FLOPs) of one fused step: reads x [B, N], y [B, K] and w2
    [(D+1)*N, K]; writes dW [(D+1)*N, K] and the loss."""
    w = (max_degree + 1) * n * k
    bytes_moved = F32 * (batch * n + batch * k + 2 * w + 1)
    return bytes_moved, 2 * (2 * batch * n * max_degree * k)


def fused_step_bound_s(batch: int, n: int, max_degree: int, k: int) -> float:
    """Least device seconds of one fused step."""
    bytes_moved, flops = fused_step_counts(batch, n, max_degree, k)
    return max(bytes_moved / HBM_BYTES_PER_S, flops / F32_TC_FLOP_PER_S)
