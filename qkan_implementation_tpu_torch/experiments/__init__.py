"""The flagship digits experiment: structure search, training and
evaluation of FixedKAN from raw data.

Counterpart of ``qkan_implementation_tpu.experiments.mnist``.  The JAX
package's YAML market harness (``config``, ``main``, ``evaluation``,
``visualization``, ``degree_viz``) is not ported yet (ROADMAP.md, Queue 1:
the market harness).
"""

from qkan_implementation_tpu_torch.experiments.mnist import (
    run_mnist_experiment,
    run_mnist_n_times,
)

__all__ = ["run_mnist_experiment", "run_mnist_n_times"]
