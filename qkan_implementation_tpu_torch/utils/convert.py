"""Parameters and states between numpy and torch.

The JAX package's FixedKAN parameters are a list of per-layer dicts
(``degrees``, ``coefficients [out, in, D+1, T]``, ``horizontal_weights``);
as numpy arrays they are what its npz checkpoints hold.
``params_from_numpy`` / ``params_to_numpy`` carry that list across to
torch tensors and back, keys unchanged, so the two packages can run on the
same parameters.  ``array_from_numpy`` / ``array_to_numpy`` do the same
for one array: the quantum layer's [D+1, N*K] weights, inputs and
statevectors.  ``mlp_from_numpy`` / ``mlp_to_numpy`` carry the MLP
baseline's ``(params, bn_state)`` pair across to ``models.mlp.MLP`` and
back.
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


def mlp_from_numpy(params, bn_state, config, device, dtype=None):
    """The JAX package's MLP ``(params, bn_state)`` (numpy leaves:
    ``bn_scale``, ``bn_bias``, ``layers`` of ``{"w" [in, out], "b"}``;
    ``mean``, ``var``) -> a ``models.mlp.MLP`` on ``device`` (``dtype``
    None keeps the arrays' dtype)."""
    from qkan_implementation_tpu_torch.models.mlp import MLP

    if dtype is None:
        dtype = torch.from_numpy(np.array(params["bn_scale"])).dtype
    model = MLP(config, device=device, dtype=dtype)
    tensors = [
        (model.bn_scale, params["bn_scale"]),
        (model.bn_bias, params["bn_bias"]),
        (model.running_mean, bn_state["mean"]),
        (model.running_var, bn_state["var"]),
    ]
    for w, b, layer in zip(model.weights, model.biases, params["layers"]):
        tensors += [(w, layer["w"]), (b, layer["b"])]
    with torch.no_grad():
        for t, a in tensors:
            if tuple(t.shape) != np.shape(a):
                raise ValueError(f"shape {np.shape(a)} != {tuple(t.shape)}")
            t.copy_(torch.from_numpy(np.array(a)).to(t.dtype))
    return model


def mlp_to_numpy(model) -> tuple:
    """A ``models.mlp.MLP`` -> ``(params, bn_state)`` of numpy arrays in
    the JAX package's layout."""
    params = {
        "bn_scale": array_to_numpy(model.bn_scale),
        "bn_bias": array_to_numpy(model.bn_bias),
        "layers": [{"w": array_to_numpy(w), "b": array_to_numpy(b)}
                   for w, b in zip(model.weights, model.biases)],
    }
    bn_state = {"mean": array_to_numpy(model.running_mean),
                "var": array_to_numpy(model.running_var)}
    return params, bn_state
