"""Parameters and states between numpy and torch.

The JAX package's FixedKAN parameters are a list of per-layer dicts
(``degrees``, ``coefficients [out, in, D+1, T]``, ``horizontal_weights``);
as numpy arrays they are what its npz checkpoints hold.
``params_from_numpy`` / ``params_to_numpy`` carry that list across to
torch tensors and back, keys unchanged, so the two packages can run on the
same parameters.  ``array_from_numpy`` / ``array_to_numpy`` do the same
for one array: the quantum layer's [D+1, N*K] weights, inputs and
statevectors.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(params, device, dtype=None) -> list:
    """List of dicts of arrays -> list of dicts of tensors on ``device``.

    ``dtype`` casts the floating-point arrays (the integer ``degrees``
    keep theirs); None keeps every array's own dtype.
    """
    out = []
    for layer in params:
        converted = {}
        for key, value in layer.items():
            t = torch.from_numpy(np.array(value)).to(device)
            if dtype is not None and t.is_floating_point():
                t = t.to(dtype)
            converted[key] = t
        out.append(converted)
    return out


def params_to_numpy(params) -> list:
    """List of dicts of tensors -> list of dicts of numpy arrays."""
    return [
        {key: value.detach().cpu().numpy() for key, value in layer.items()}
        for layer in params
    ]


def array_from_numpy(a, device, dtype=None) -> torch.Tensor:
    """One array -> a tensor on ``device`` (a copy; ``dtype`` casts, None
    keeps the array's dtype)."""
    t = torch.from_numpy(np.array(a)).to(device)
    return t if dtype is None else t.to(dtype)


def array_to_numpy(t: torch.Tensor) -> np.ndarray:
    """One tensor -> a numpy array on the host (detached)."""
    return t.detach().cpu().numpy()
