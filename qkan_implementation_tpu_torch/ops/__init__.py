"""Chebyshev transforms and the degree-wise fused layer, on torch tensors.

The JAX package's ``ops`` also exports the ``qkan_layer`` step pipeline
and the v1 ``kan_layer_fused``; those are not ported yet (ROADMAP.md).
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
from qkan_implementation_tpu_torch.ops.fused_layer import (
    kan_layer_fused_dw,
    kan_layer_fused_dw_reference,
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
    "kan_layer_fused_dw",
    "kan_layer_fused_dw_reference",
]
