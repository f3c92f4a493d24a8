"""Device selection and parameter conversion; JSONL run records live in
``utils.run_records``.

The JAX package's metrics, profiling and checkpoint helpers are not
ported yet (ROADMAP.md).
"""

from qkan_implementation_tpu_torch.utils.convert import (
    array_from_numpy,
    array_to_numpy,
    params_from_numpy,
    params_to_numpy,
)
from qkan_implementation_tpu_torch.utils.platform import resolve_device

__all__ = ["array_from_numpy", "array_to_numpy", "params_from_numpy",
           "params_to_numpy", "resolve_device"]
