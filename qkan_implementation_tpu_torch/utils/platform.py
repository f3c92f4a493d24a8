"""Device selection for the torch port.

Counterpart of ``qkan_implementation_tpu.utils.platform``.  The caller
names the device; nothing here picks one on its own, and a request for
CUDA on a machine without a card raises instead of running on the CPU.

The JAX module's ``apply_platform_env`` (``JAX_PLATFORMS`` /
``jax.config``) and ``disable_default_compile_cache`` (XLA's persistent
compile cache) are XLA settings with no torch meaning, so they have no
counterpart here.
"""

from __future__ import annotations

import torch


def resolve_device(name: str | torch.device) -> torch.device:
    """Return ``torch.device(name)``; raise if it cannot run here.

    Only ``cpu`` and ``cuda`` (optionally ``cuda:<index>``) are taken.
    """
    device = torch.device(name)
    if device.type == "cpu":
        return device
    if device.type != "cuda":
        raise ValueError(f"unsupported device {name!r}: 'cpu' or 'cuda'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but torch.cuda.is_available() is "
            "False"
        )
    if device.index is not None and device.index >= torch.cuda.device_count():
        raise RuntimeError(
            f"device {name!r} requested but only "
            f"{torch.cuda.device_count()} CUDA device(s) are present"
        )
    return device


def tensor_device_type(x: torch.Tensor) -> str:
    """'cpu' or 'cuda': where a kernel wrapper sends ``x`` (its plain
    version or its kernel); any other device raises."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}: 'cpu' or 'cuda'")
    return x.device.type
