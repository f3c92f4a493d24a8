"""Analysis & diagnostics: saved-model inspection, sampling diagnostics,
dataset sparsity metrics.

Counterpart of ``qkan_implementation_tpu.analysis`` (reference L6:
analyze_model_utils.py, mnist_sampling_diagnostics.py, Sparsity_check/),
with its export list.
"""

from qkan_implementation_tpu_torch.analysis.model_analysis import (
    analyze_models,
    extract_degrees_from_checkpoint,
    compute_model_stats,
)
from qkan_implementation_tpu_torch.analysis.mnist_diagnostics import (
    analyze_sample_distribution,
    compare_multiple_samples,
    plot_sample_distributions,
)
from qkan_implementation_tpu_torch.analysis.sparsity import (
    SparsityMetrics,
    compute_sparsity,
    print_sparsity_analysis,
)

__all__ = [
    "analyze_models",
    "extract_degrees_from_checkpoint",
    "compute_model_stats",
    "analyze_sample_distribution",
    "compare_multiple_samples",
    "plot_sample_distributions",
    "SparsityMetrics",
    "compute_sparsity",
    "print_sparsity_analysis",
]
