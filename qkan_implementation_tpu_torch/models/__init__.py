"""FixedKAN (QUBO-structured Chebyshev KAN): config, structure search,
forward, training, checkpoints; and the QSVT neuron (classical vs
block-encoded fit).

The JAX package's MLP baseline is not ported yet (ROADMAP.md).
"""

from qkan_implementation_tpu_torch.models.fixed_kan import (
    FixedKAN,
    FixedKANConfig,
    kan_apply,
    kan_layer_apply,
)
from qkan_implementation_tpu_torch.models.qsvt_neuron import (
    QSVTNeuron,
    compare_classical_quantum,
)

__all__ = ["FixedKAN", "FixedKANConfig", "kan_apply", "kan_layer_apply",
           "QSVTNeuron", "compare_classical_quantum"]
