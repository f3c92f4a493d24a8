"""FixedKAN parameters between numpy and torch.

The JAX package's parameters are a list of per-layer dicts
(``degrees``, ``coefficients [out, in, D+1, T]``, ``horizontal_weights``);
as numpy arrays they are what its npz checkpoints hold.  These two
functions carry that list across to torch tensors and back, keys
unchanged, so the two packages can run on the same parameters.
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
