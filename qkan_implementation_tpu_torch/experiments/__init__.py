"""The experiment harnesses: the market-data harness driven by a YAML
(or JSON) config (``config``, ``main``, ``evaluation``,
``visualization``, ``degree_viz``) and the flagship digits experiment
(``mnist``: structure search, training and evaluation of FixedKAN from
raw data).

Counterpart of ``qkan_implementation_tpu.experiments``.
"""

from qkan_implementation_tpu_torch.experiments.config import (
    DataConfig,
    ExperimentConfig,
    ModelConfig,
    get_default_features,
    load_config,
)
from qkan_implementation_tpu_torch.experiments.evaluation import (
    ModelEvaluator,
    ModelResult,
)
from qkan_implementation_tpu_torch.experiments.main import run_experiment
from qkan_implementation_tpu_torch.experiments.mnist import (
    run_mnist_experiment,
    run_mnist_n_times,
)

__all__ = [
    "DataConfig",
    "ModelConfig",
    "ExperimentConfig",
    "load_config",
    "get_default_features",
    "ModelResult",
    "ModelEvaluator",
    "run_experiment",
    "run_mnist_experiment",
    "run_mnist_n_times",
]
