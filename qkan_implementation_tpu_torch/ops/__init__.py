"""Chebyshev transforms, the QKAN step pipeline and the fused layers, on
torch tensors.

The quantum-mode layer is ``ops.quantum``; the int8 serving recipes are
in ``qkan_layer``.
"""

from qkan_implementation_tpu_torch.ops.chebyshev import (
    chebyshev_t,
    chebyshev_basis,
    cumulative_transform,
    transform_diagonal,
    dilate,
    dilated_chebyshev_diag,
    check_unit_interval,
    check_weight_magnitudes,
)
from qkan_implementation_tpu_torch.ops.qkan_layer import (
    weighted_chebyshev_diag,
    lcu_combine_diag,
    sum_step,
    qkan_layer_forward,
    qkan_layer_forward_batched,
    qkan_layer_forward_batched_int8,
    int8_quantized_matmul,
    int8_residual_matmul,
    qkan_intermediates,
)
from qkan_implementation_tpu_torch.ops.fused_layer import (
    kan_layer_fused,
    kan_layer_fused_bwd_reference,
    kan_layer_fused_dw,
    kan_layer_fused_dw_bwd_reference,
    kan_layer_fused_dw_reference,
    kan_layer_fused_reference,
    kan_train_step_fused,
    kan_train_step_fused_reference,
)

__all__ = [
    "chebyshev_t",
    "chebyshev_basis",
    "cumulative_transform",
    "transform_diagonal",
    "dilate",
    "dilated_chebyshev_diag",
    "check_unit_interval",
    "check_weight_magnitudes",
    "weighted_chebyshev_diag",
    "lcu_combine_diag",
    "sum_step",
    "qkan_layer_forward",
    "qkan_layer_forward_batched",
    "qkan_layer_forward_batched_int8",
    "int8_quantized_matmul",
    "int8_residual_matmul",
    "qkan_intermediates",
    "kan_layer_fused",
    "kan_layer_fused_bwd_reference",
    "kan_layer_fused_dw",
    "kan_layer_fused_dw_bwd_reference",
    "kan_layer_fused_dw_reference",
    "kan_layer_fused_reference",
    "kan_train_step_fused",
    "kan_train_step_fused_reference",
]
