"""Model serving: bucketed batched inference + a minimal HTTP endpoint."""

from qkan_implementation_tpu_torch.serving.predictor import BatchedPredictor
from qkan_implementation_tpu_torch.serving.server import serve, make_server

__all__ = ["BatchedPredictor", "serve", "make_server"]
