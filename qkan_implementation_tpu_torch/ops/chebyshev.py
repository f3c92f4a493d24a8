"""Chebyshev transforms for the QKAN pipeline, on torch tensors.

Counterpart of ``qkan_implementation_tpu.ops.chebyshev``: T_d(x) =
cos(d * arccos(x)) on values in [-1, 1] with the eps-tolerant clipping of
the original ``ChebyshevStep.py``, the recurrence-built basis the KAN
models use, and the dilated (K-fold repeated) diagonal of the MUL step.
Validation (which raises) is offered as separate eager helpers, as in the
JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

# Same tolerance the reference applies before clipping
# (ChebyshevStep.py:25-30).
UNIT_EPS = 1e-8


def _clip_unit(x: torch.Tensor) -> torch.Tensor:
    """clip(x, -1, 1) by maximum/minimum, not ``torch.clamp``: at a tie
    they pass half the gradient, as ``jnp.clip`` does (clamp passes all)."""
    lo = torch.tensor(-1.0, dtype=x.dtype, device=x.device)
    hi = torch.tensor(1.0, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo), hi)


def _as_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def check_unit_interval(x, eps: float = UNIT_EPS, name: str = "Input value"):
    """Validate that all values lie in [-1-eps, 1+eps]; return ``x``.

    Mirrors the ValueError contract of ``ChebyshevStep.apply_chebyshev``.
    """
    arr = _as_numpy(x)
    if not np.all((arr >= -1 - eps) & (arr <= 1 + eps)):
        raise ValueError(f"{name} must be between -1 and 1.")
    return x


def check_weight_magnitudes(weights, limit: float = 1.0):
    """Validate |w| <= 1 (unitarity bound); return ``weights``."""
    arr = _as_numpy(weights)
    if not np.all(np.abs(arr) <= limit):
        raise ValueError("Weight magnitudes must be <= 1 for unitarity")
    return weights


def chebyshev_t(x: torch.Tensor, degree: int) -> torch.Tensor:
    """T_degree(x) = cos(degree * arccos(clip(x, -1, 1))), elementwise."""
    if degree < 0:
        raise ValueError("Degree must be a non-negative integer.")
    x = _clip_unit(x)
    return torch.cos(degree * torch.arccos(x))


def transform_diagonal(x: torch.Tensor, degree: int) -> torch.Tensor:
    """Vectorized T_degree over a vector of inputs."""
    return chebyshev_t(x, degree)


def chebyshev_basis(
    x: torch.Tensor, max_degree: int, clip: bool = True
) -> torch.Tensor:
    """All T_0..T_max_degree stacked on a trailing axis: x.shape + (D+1,).

    Three-term recurrence T_{d+1} = 2x T_d - T_{d-1}.  ``clip=True``
    clamps to [-1, 1] like the quantum pipeline; ``clip=False`` evaluates
    the polynomial unclipped, as the KAN models do.
    """
    if max_degree < 0:
        raise ValueError("Degree must be a non-negative integer.")
    if clip:
        x = _clip_unit(x)
    cols = [torch.ones_like(x)]
    if max_degree >= 1:
        cols.append(x)
    for _ in range(2, max_degree + 1):
        cols.append(2.0 * x * cols[-1] - cols[-2])
    return torch.stack(cols, dim=-1)


def cumulative_transform(
    x: torch.Tensor, max_degree: int, clip: bool = False
) -> torch.Tensor:
    """[batch, in] -> [batch, in * (D+1)], all degrees of dim 0 first."""
    basis = chebyshev_basis(x, max_degree, clip=clip)  # [batch, in, D+1]
    b, n, dp1 = basis.shape
    return basis.reshape(b, n * dp1)


def dilate(values: torch.Tensor, K: int) -> torch.Tensor:
    """Repeat each value K times: [N] -> [N*K], index n*K + k holds values[n]."""
    return torch.repeat_interleave(values, K, dim=-1)


def dilated_chebyshev_diag(x: torch.Tensor, K: int, degree: int) -> torch.Tensor:
    """Diagonal of the dilated Chebyshev matrix, as a vector of length N*K."""
    return dilate(transform_diagonal(x, degree), K)
