"""FixedKAN (QUBO-structured Chebyshev KAN): config, forward, checkpoints.

The JAX package's MLP baseline is not ported yet (ROADMAP.md).
"""

from qkan_implementation_tpu_torch.models.fixed_kan import (
    FixedKAN,
    FixedKANConfig,
    kan_apply,
    kan_layer_apply,
)

__all__ = ["FixedKAN", "FixedKANConfig", "kan_apply", "kan_layer_apply"]
