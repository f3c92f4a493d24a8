"""MNIST / digits loading for the classification pipeline.

The JAX package's market pipeline (``DataPipeline``,
``generate_market_parquet``) is not ported yet (ROADMAP.md, Queue 1: the
market harness).
"""

from qkan_implementation_tpu_torch.data.mnist import (
    load_digits_784,
    load_mnist,
    sample_train_subset,
    to_one_hot,
)

__all__ = ["load_digits_784", "load_mnist", "sample_train_subset",
           "to_one_hot"]
