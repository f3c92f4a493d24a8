"""Data pipelines: the market columns (Jane Street-shaped, generated from
a seed or read from parquet) and the MNIST / digits loaders."""

from qkan_implementation_tpu_torch.data.pipeline import (
    DataPipeline,
    generate_market_parquet,
    market_columns,
)
from qkan_implementation_tpu_torch.data.mnist import (
    load_digits_784,
    load_mnist,
    sample_train_subset,
    to_one_hot,
)

__all__ = ["DataPipeline", "generate_market_parquet", "market_columns",
           "load_digits_784", "load_mnist", "sample_train_subset",
           "to_one_hot"]
