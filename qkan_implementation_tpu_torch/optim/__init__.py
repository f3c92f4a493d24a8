"""Degree-optimizer training stack: the QUBO degree search per network
edge, Chebyshev transforms with caching, least-squares scoring,
expanding and time-window CV folds, and prediction through the QKAN
layer.

Counterpart of ``qkan_implementation_tpu.optim``.
"""

from qkan_implementation_tpu_torch.optim.base import BaseOptimizer
from qkan_implementation_tpu_torch.optim.degree_optimizer import (
    DegreeOptimizer,
    MetricType,
)

__all__ = ["BaseOptimizer", "DegreeOptimizer", "MetricType"]
