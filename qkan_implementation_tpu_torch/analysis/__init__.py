"""Sampling diagnostics for the digits experiment.

The JAX package's saved-model inspection (``model_analysis``) and dataset
sparsity metrics (``sparsity``) are not ported yet (ROADMAP.md, Queue 1:
diagnostics).
"""

from qkan_implementation_tpu_torch.analysis.mnist_diagnostics import (
    analyze_sample_distribution,
    compare_multiple_samples,
    plot_sample_distributions,
)

__all__ = [
    "analyze_sample_distribution",
    "compare_multiple_samples",
    "plot_sample_distributions",
]
