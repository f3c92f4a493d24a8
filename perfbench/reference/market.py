"""The plain degree search of a QKAN layer over market rows, in torch
operations alone.  It imports nothing of the program.

It follows the layer's description:

- features are standardised by the training rows' mean and standard
  deviation (plus 1e-8), clipped to [-1, 1], and expanded into Chebyshev
  polynomials T_0..T_D;
- a degree's score is the weighted mean squared residual, over rows and
  targets, of the least-squares fit of the target on T_0..T_d of every
  feature (degree-major columns), solved from the normal equations with
  a ridge of 1e-10 times the block's mean diagonal (by the symmetric
  eigendecomposition of the ridged block, which gives a number at any
  precision); the weights enter the score only;
- the degree choice: if one degree beats every other by the significance
  threshold (relative), every edge takes it; else each edge takes
  argmin_d of -(s_d - s_{d-1}) + w d^2, with s_{-1} = 0;
- the layer maps x [B, N] to [B, K]: out_k = sum_{n, d} T_d(x_n) M[k, n,
  d], with M[k, n, d] = 1 / (N (D+1)) where the edge (k, n) has degree d
  and 0 elsewhere (edge j = k N + n feeds feature j // K);
- a prediction is scored by its weighted mean squared error, its weighted
  R^2 against the weighted mean, and the zero-mean weighted R^2
  1 - sum w (y - p)^2 / sum w y^2.
"""

from __future__ import annotations

import numpy as np
import torch


def basis(x: torch.Tensor, max_degree: int) -> torch.Tensor:
    """[B, F] -> [B, F, D+1], x clipped to [-1, 1]."""
    t = torch.clamp(x, -1.0, 1.0)
    cols = [torch.ones_like(t), t]
    for _ in range(2, max_degree + 1):
        cols.append(2 * t * cols[-1] - cols[-2])
    return torch.stack(cols[: max_degree + 1], dim=-1)


def degree_scores(x, y, w, max_degree: int, chunk: int = 65536) -> np.ndarray:
    """Weighted MSE of each cumulative degree's fit; x [n, F], y [n, T],
    w [n, 1] tensors of one dtype on one device."""
    n, f = x.shape
    dp1 = max_degree + 1
    G = torch.zeros((f * dp1, f * dp1), dtype=x.dtype, device=x.device)
    b = torch.zeros((f * dp1, y.shape[1]), dtype=x.dtype, device=x.device)
    for s in range(0, n, chunk):
        X = basis(x[s:s + chunk], max_degree).transpose(1, 2).reshape(-1, f * dp1)
        G += X.T @ X
        b += X.T @ y[s:s + chunk]
    out = np.zeros(dp1)
    for d in range(dp1):
        k = (d + 1) * f
        Gk = G[:k, :k]
        ridge = 1e-10 * torch.trace(Gk) / k
        lam, vec = torch.linalg.eigh(Gk)
        c = vec @ ((vec.T @ b[:k]) / (lam + ridge)[:, None])
        res = torch.zeros((), dtype=x.dtype, device=x.device)
        for s in range(0, n, chunk):
            X = basis(x[s:s + chunk], d).transpose(1, 2).reshape(-1, k)
            r = y[s:s + chunk] - X @ c
            res += torch.sum(w[s:s + chunk] * r * r)
        out[d] = float(res / (torch.sum(w) * y.shape[1]))
    return out


def degree_objective(scores, complexity_weight: float,
                     significance: float) -> np.ndarray:
    """Each degree's value in the selection; an edge takes the least."""
    scores = np.asarray(scores, dtype=np.float64)
    best = int(np.argmin(scores))
    others = [d for d in range(len(scores)) if d != best]
    if all((scores[d] - scores[best]) / (scores[d] + 1e-10) >= significance
           for d in others):
        lin = np.full(len(scores), 100.0)
        lin[best] = -100.0
        return lin
    improvement = np.diff(scores, prepend=0.0)
    d = np.arange(len(scores), dtype=np.float64)
    return -improvement + complexity_weight * d**2


def layer(x: torch.Tensor, degrees: np.ndarray, max_degree: int,
          mean, std) -> torch.Tensor:
    """The layer of one-hot edge degrees [K, N] on raw rows x [B, N]."""
    k_out, n = degrees.shape
    z = (x - mean) / std
    M = torch.zeros((k_out, n, max_degree + 1), dtype=x.dtype, device=x.device)
    j = np.arange(k_out)[:, None] * n + np.arange(n)[None, :]
    for k in range(k_out):
        for i in range(n):
            M[k, j[k, i] // k_out, int(degrees[k, i])] += 1.0
    M /= n * (max_degree + 1)
    return basis(z, max_degree).reshape(x.shape[0], -1) @ M.reshape(k_out, -1).T


def metrics(y: torch.Tensor, pred: torch.Tensor, w: torch.Tensor) -> dict:
    """The weighted scores of the predictions ``pred`` of ``y``."""
    y, pred, w = y.reshape(-1), pred.reshape(-1), w.reshape(-1)
    sq = torch.sum(w * (y - pred) ** 2)
    wsum = torch.sum(w)
    y_mean = torch.sum(w * y) / wsum
    return {
        "mse": float(sq / wsum),
        "r2": float(1 - sq / torch.sum(w * (y - y_mean) ** 2)),
        "comp_r2": float(1 - sq / torch.sum(w * y * y)),
    }
