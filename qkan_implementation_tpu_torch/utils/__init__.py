"""Device selection, parameter conversion and metrics; JSONL run records
live in ``utils.run_records``, checkpoint helpers in ``utils.checkpoint``
and stage timers and profiler traces in ``utils.profiling``.
"""

from qkan_implementation_tpu_torch.utils.convert import (
    array_from_numpy,
    array_to_numpy,
    mlp_from_numpy,
    mlp_to_numpy,
    params_from_numpy,
    params_to_numpy,
)
from qkan_implementation_tpu_torch.utils.metrics import (
    compute_metrics,
    mse,
    r2_score,
    weighted_competition_r2,
)
from qkan_implementation_tpu_torch.utils.platform import resolve_device

__all__ = ["array_from_numpy", "array_to_numpy", "mlp_from_numpy",
           "mlp_to_numpy", "params_from_numpy", "params_to_numpy",
           "compute_metrics", "mse", "r2_score", "weighted_competition_r2",
           "resolve_device"]
