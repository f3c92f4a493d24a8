"""One metrics module for the whole framework, on torch tensors.

Counterpart of ``qkan_implementation_tpu.utils.metrics``:

  - ``r2_score``: the coefficient of determination (sample-weighted as
    sklearn's ``sample_weight``);
  - ``weighted_competition_r2``: the zero-mean weighted metric
    1 - sum(w * (y - pred)^2) / sum(w * y^2) of the market-data logs.

Inputs may be numpy arrays, lists or tensors on any device; the sums run
where the tensors are and return Python floats.
"""

from __future__ import annotations

import numpy as np
import torch

from qkan_implementation_tpu_torch.utils import profiling
from qkan_implementation_tpu_torch.utils.profiling import span


def _as_tensor(a, dtype=None, device=None) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


def _flatten(y_true, y_pred, weights=None):
    # a float working dtype whatever the input (integer labels are valid
    # targets; finfo and the ratios need a float): y_true's dtype promoted
    # with float32, as the JAX package promotes
    y_true = _as_tensor(y_true)
    ft = torch.promote_types(y_true.dtype, torch.float32)
    device = y_true.device
    y_true = y_true.to(ft).reshape(-1)
    y_pred = _as_tensor(y_pred, ft, device).reshape(-1)
    if weights is not None:
        weights = _as_tensor(weights, ft, device).reshape(-1)
    return y_true, y_pred, weights


def mse(y_true, y_pred, weights=None) -> float:
    """(Weighted) mean squared error."""
    y_true, y_pred, weights = _flatten(y_true, y_pred, weights)
    sq = (y_true - y_pred) ** 2
    if weights is None:
        return float(torch.mean(sq))
    wsum = float(torch.sum(weights))
    if wsum == 0.0:
        return 0.0  # all-zero weights: consistent with the R^2s
    return float(torch.sum(weights * sq) / wsum)


def r2_score(y_true, y_pred, weights=None) -> float:
    """Coefficient of determination, weighted like sklearn's sample_weight."""
    y_true, y_pred, weights = _flatten(y_true, y_pred, weights)
    if weights is None:
        weights = torch.ones_like(y_true)
    if float(torch.sum(weights)) == 0.0:
        return 0.0  # all-zero weights (the weighted mean would be 0/0)
    w_mean = torch.sum(weights * y_true) / torch.sum(weights)
    ss_res = torch.sum(weights * (y_true - y_pred) ** 2)
    ss_tot = torch.sum(weights * (y_true - w_mean) ** 2)
    # scale-relative degeneracy test: only a variance at the rounding
    # level of the target energy is constant (an absolute eps would zero
    # small-magnitude targets)
    eps = torch.finfo(y_true.dtype).eps
    scale = float(torch.sum(weights * y_true**2))
    if float(ss_tot) <= eps * max(scale, 0.0):
        return 0.0
    return float(1.0 - ss_res / ss_tot)


def weighted_competition_r2(y_true, y_pred, weights=None) -> float:
    """Zero-mean weighted R^2: 1 - sum(w*(y-pred)^2)/sum(w*y^2)."""
    y_true, y_pred, weights = _flatten(y_true, y_pred, weights)
    if weights is None:
        weights = torch.ones_like(y_true)
    num = torch.sum(weights * (y_true - y_pred) ** 2)
    den = torch.sum(weights * y_true**2)
    if float(den) == 0.0:
        return 0.0
    return float(1.0 - num / den)


def compute_metrics(y_true, y_pred, weights=None) -> dict:
    """MSE and both R^2 flavours in one record."""
    with span(profiling.METRICS):
        return {
            "mse": mse(y_true, y_pred, weights),
            "r2": r2_score(y_true, y_pred, weights),
            "comp_r2": weighted_competition_r2(y_true, y_pred, weights),
        }
