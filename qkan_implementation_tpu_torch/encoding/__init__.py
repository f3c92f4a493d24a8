"""Block-encoding circuit builders (FABLE), numpy only."""

from qkan_implementation_tpu_torch.encoding.fable import (
    fable_runtime_params,
    fable,
    fable_alpha,
    gray_code,
    gray_permutation,
    sfwht,
)

__all__ = ["fable",
    "fable_runtime_params", "fable_alpha", "gray_code", "gray_permutation", "sfwht"]
