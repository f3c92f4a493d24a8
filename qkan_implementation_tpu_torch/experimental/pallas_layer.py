"""The batched QKAN layer over the degree-major contraction tensor M3.

Counterpart of ``qkan_implementation_tpu.experimental.pallas_layer``.  So
far only the fold ``weights_to_m3`` is ported: it turns the layer's
per-degree weight vectors (the JAX package's, as numpy, or the port's)
into M3 [D+1, N, K], and ``weights_to_m3(w, N, K).reshape((D+1)*N, K)`` is
the degree-major ``w2`` that ``ops.fused_layer.kan_train_step_fused``
takes with ``apply_tanh=False``:

    out[b, k] = sum_{d, n} T_d(x[b, n]) M3[d, n, k]

The module's kernels are the next slice's: ``qkan_layer_fused``,
``qkan_layer_fused_dw`` and ``qkan_layer_forward_batched_fused`` (ROADMAP
Queue 2, K12-K14).
"""

from __future__ import annotations

import torch

from qkan_implementation_tpu_torch.ops.qkan_layer import qkan_weight_tensor


def weights_to_m3(weights: torch.Tensor, N: int, K: int) -> torch.Tensor:
    """Per-degree weight vectors [D+1, N*K] -> fused tensor [D+1, N, K]."""
    return qkan_weight_tensor(weights, N, K).permute(2, 1, 0).contiguous()
