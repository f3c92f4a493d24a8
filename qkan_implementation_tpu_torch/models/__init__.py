"""FixedKAN (QUBO-structured Chebyshev KAN): config, structure search,
forward, training, checkpoints; the MLP baseline; and the QSVT neuron
(classical vs block-encoded fit)."""

from qkan_implementation_tpu_torch.models.fixed_kan import (
    FixedKAN,
    FixedKANConfig,
    kan_apply,
    kan_layer_apply,
)
from qkan_implementation_tpu_torch.models.mlp import (
    MLP,
    MLPConfig,
    init_mlp,
    mlp_apply,
    mlp_predict,
    train_mlp,
)
from qkan_implementation_tpu_torch.models.qsvt_neuron import (
    QSVTNeuron,
    compare_classical_quantum,
)

__all__ = ["FixedKAN", "FixedKANConfig", "kan_apply", "kan_layer_apply",
           "MLP", "MLPConfig", "init_mlp", "mlp_apply", "mlp_predict",
           "train_mlp", "QSVTNeuron", "compare_classical_quantum"]
