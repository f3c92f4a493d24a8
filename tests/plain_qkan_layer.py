"""The plain QKANLayer: forward, mean squared error, Adam steps, in torch
operations alone.

It imports nothing of the program.  It follows ``QKANLayer(N, K,
max_degree).forward`` (``QKAN_Steps_original/QKANLayer.py:12-135``) for
one row x [N] and weights [D+1, N*K]:

- CHEB: T_0..T_D of each input (T_0 = 1, T_1 = x, T_{d+1} = 2x T_d -
  T_{d-1});
- DILATE: each input repeated K times, so slot j < N*K holds
  T_d(x[j // K]) (``ChebyshevStep.create_dilated_chebyshev``);
- MUL: slot j of degree d times ``weights[d, j]`` (``MulStep``);
- LCU: the mean over the D+1 degrees (``LCUStep``);
- SUM: the N*K slots reshaped (N, K) in Fortran order, so output k sums
  slots j = i + N*k over i < N, divided by N (``SUMStep``):

    out[k] = 1/(N(D+1)) sum_{i<N} sum_{d<=D} T_d(x[(i + N*k) // K]) weights[d, i + N*k].

Departures from ``QKANLayer.py``, none of which changes a number:

- rows come in a batch [B, N], and the diagonal matrices are kept as
  their diagonals: DILATE and SUM are applied as 0/1 matrices ([N, N*K]
  and [N*K, K]), MUL as a product with the weights;
- the reference takes cos(d arccos x) of x clipped to [-1, 1]; the
  recurrence equals it on [-1, 1], where the data lie, and nothing is
  clipped;
- the weights are trained: mean squared error over all B*K outputs, its
  gradient by autograd, Adam (b1 0.9, b2 0.999, eps 1e-8 outside the
  root) at a fixed rate, no clip; the reference only solves for the
  weights and has no trainer.

``dtype`` is the caller's: the checks run it in float64 and their
control in float32 with TF32 products (``matmul_mode``).
"""

from __future__ import annotations

from contextlib import contextmanager

import torch

B1, B2, EPS = 0.9, 0.999, 1e-8


@contextmanager
def matmul_mode(tf32: bool):
    """TF32 products on or off for the block, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def chebyshev(x: torch.Tensor, max_degree: int) -> torch.Tensor:
    """[B, N] -> [B, N, D+1]: T_0..T_D of x, unclipped."""
    cols = [torch.ones_like(x), x]
    for _ in range(2, max_degree + 1):
        cols.append(2 * x * cols[-1] - cols[-2])
    return torch.stack(cols[: max_degree + 1], dim=-1)


def dilate_matrix(N: int, K: int, dtype, device) -> torch.Tensor:
    """[N, N*K]: input n feeds slots j with j // K = n."""
    j = torch.arange(N * K, device=device)
    n = torch.arange(N, device=device)
    return (j[None, :] // K == n[:, None]).to(dtype)


def sum_matrix(N: int, K: int, dtype, device) -> torch.Tensor:
    """[N*K, K]: slot j = i + N*k adds into output k."""
    j = torch.arange(N * K, device=device)
    k = torch.arange(K, device=device)
    return (j[:, None] // N == k[None, :]).to(dtype)


def forward(x: torch.Tensor, weights: torch.Tensor, N: int,
            K: int) -> torch.Tensor:
    """QKANLayer of rows x [B, N] with weights [D+1, N*K] -> [B, K]."""
    dp1 = weights.shape[0]
    dil = dilate_matrix(N, K, weights.dtype, weights.device)
    summ = sum_matrix(N, K, weights.dtype, weights.device)
    # per degree, DILATE -> MUL -> SUM as one [N, K] map
    per_degree = torch.stack([(dil * weights[d]) @ summ for d in range(dp1)])
    basis = chebyshev(x, dp1 - 1)  # [B, N, D+1]
    return torch.einsum("bnd,dnk->bk", basis, per_degree) / (N * dp1)


def mse(out: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean((out - y) ** 2)


def train_steps(weights: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                batches: list, N: int, K: int, lr: float,
                adam: tuple | None = None) -> dict:
    """Adam on the mean squared error over ``batches`` ((start, stop) row
    ranges of x and y, each cast to the weights' dtype on its turn), from
    ``weights`` and Adam's state ``adam`` = (first moments, second
    moments, steps taken), by default a fresh one.

    Returns {"loss": [per step], "grad": the first step's gradient,
    "weights": [the weights after each step]}.
    """
    w = weights.detach().clone()
    if adam is None:
        mu, nu, count = torch.zeros_like(w), torch.zeros_like(w), 0
    else:
        mu, nu, count = adam[0].to(w), adam[1].to(w), adam[2]
    losses, grad1, after = [], None, []
    for k, (a, b) in enumerate(batches, start=count):
        xb = x[a:b].to(w.dtype)
        yb = y[a:b].to(w.dtype)
        leaf = w.clone().requires_grad_()
        loss = mse(forward(xb, leaf, N, K), yb)
        (g,) = torch.autograd.grad(loss, [leaf])
        losses.append(float(loss.detach()))
        if grad1 is None:
            grad1 = g.detach().clone()
        with torch.no_grad():
            mu = (1 - B1) * g + B1 * mu
            nu = (1 - B2) * g * g + B2 * nu
            bc1, bc2 = 1 - B1 ** (k + 1), 1 - B2 ** (k + 1)
            w = w - lr * (mu / bc1) / (torch.sqrt(nu / bc2) + EPS)
        after.append(w.clone())
    return {"loss": losses, "grad": grad1, "weights": after}
