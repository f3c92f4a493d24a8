"""The plain FixedKAN: forward, loss, Adam steps, the degree sweep and the
degree choice, in torch operations alone.

It imports nothing of the program.  It follows the model's description:

- a layer of ``out`` neurons maps x [B, in] to [B, T]:
  y = sum_o hw_o * sum_i sum_{d <= deg_o} T_d(tanh x_i) C[o, i, d, :],
  T_d the Chebyshev polynomials (T_0 = 1, T_1 = t, T_{d+1} = 2t T_d -
  T_{d-1}); the layers chain, each mapping to the T-column target;
- training: mean cross-entropy of softmax(logits); one label group for all
  horizontal weights and one for each layer's coefficients, each clipped
  by its global norm (g stays below the clip, else g * clip / |g|), then
  Adam (b1 0.9, b2 0.999, eps 1e-8 outside the root) at a cosine-decayed
  rate lr_k = lr * (1 + cos(pi k / K)) / 2 over K updates; layer i's
  coefficients learn at lr * fanin_last / fanin_i, fanin = in * (D+1) *
  out;
- structure search: every layer is fit against the target by ridge least
  squares on the cumulative-degree design [T_0..T_d of tanh x] (degree
  major), with one refinement step against the unridged normal
  equations; a degree's score is the mean squared residual over rows and
  target columns; each neuron takes argmin_d score_d + w * d^2.

``dtype`` and ``tf32`` choose the arithmetic: the checks run it in
float64, and their control in float32 with TF32 products.
"""

from __future__ import annotations

import math
from contextlib import contextmanager

import numpy as np
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


def chebyshev(t: torch.Tensor, max_degree: int) -> torch.Tensor:
    """[B, in] -> [B, in, D+1]: T_0..T_D of t, unclipped."""
    cols = [torch.ones_like(t), t]
    for _ in range(2, max_degree + 1):
        cols.append(2 * t * cols[-1] - cols[-2])
    return torch.stack(cols[: max_degree + 1], dim=-1)


def layer_weight(lp: dict, max_degree: int) -> torch.Tensor:
    """The neurons of a layer summed into one [in, D+1, T] weight."""
    d = torch.arange(max_degree + 1, device=lp["coefficients"].device)
    keep = (d[None, :] <= lp["degrees"][:, None].long())
    scale = keep.to(lp["coefficients"].dtype) * lp["horizontal_weights"][:, None]
    return torch.einsum("oidt,od->idt", lp["coefficients"], scale)


def layer(lp: dict, x: torch.Tensor, max_degree: int) -> torch.Tensor:
    basis = chebyshev(torch.tanh(x), max_degree)
    w = layer_weight(lp, max_degree)
    return basis.reshape(x.shape[0], -1) @ w.reshape(-1, w.shape[-1])


def forward(params: list, x: torch.Tensor, max_degree: int) -> torch.Tensor:
    for lp in params:
        x = layer(lp, x, max_degree)
    return x


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return -torch.mean(torch.log_softmax(logits, dim=-1).gather(
        1, labels[:, None]).squeeze(1))


def cast_params(params: list, dtype, device) -> list:
    return [{
        "degrees": lp["degrees"].to(device),
        "coefficients": lp["coefficients"].to(device, dtype).clone(),
        "horizontal_weights": lp["horizontal_weights"].to(device, dtype).clone(),
    } for lp in params]


def train_steps(params: list, x: torch.Tensor, labels: torch.Tensor,
                batches: list, max_degree: int, lr: float, clip: float,
                decay_steps: int) -> dict:
    """Run Adam over ``batches`` (row indices) from ``params``.

    Returns {"loss": [per step], "grad1": [|g| of each leaf at step 1, as
    clipped], "change": [|p_end - p_start| of each leaf], "params": the
    parameters after the steps}.  Leaves: every layer's horizontal
    weights, then every layer's coefficients.
    """
    n_layers = len(params)
    hw = [lp["horizontal_weights"].clone().requires_grad_() for lp in params]
    coef = [lp["coefficients"].clone().requires_grad_() for lp in params]
    leaves = hw + coef
    start = [t.detach().clone() for t in leaves]
    dp1 = max_degree + 1
    fanins = [float(c.shape[0] * c.shape[1] * dp1) for c in coef]
    groups = [(list(range(n_layers)), lr)] + [
        ([n_layers + i], lr * fanins[-1] / fanins[i]) for i in range(n_layers)]
    mu = [torch.zeros_like(t) for t in leaves]
    nu = [torch.zeros_like(t) for t in leaves]
    losses, grad1 = [], None
    for k, rows in enumerate(batches):
        cur = [{"degrees": lp["degrees"], "coefficients": c,
                "horizontal_weights": h}
               for lp, c, h in zip(params, coef, hw)]
        loss = cross_entropy(forward(cur, x[rows], max_degree), labels[rows])
        grads = list(torch.autograd.grad(loss, leaves))
        losses.append(float(loss.detach()))
        with torch.no_grad():
            for idx, _ in groups:
                norm = torch.sqrt(sum(torch.sum(grads[i] ** 2) for i in idx))
                if not norm < clip:
                    for i in idx:
                        grads[i] = grads[i] / norm * clip
            if grad1 is None:
                grad1 = [float(torch.linalg.vector_norm(g)) for g in grads]
            bc1, bc2 = 1 - B1 ** (k + 1), 1 - B2 ** (k + 1)
            for idx, glr in groups:
                rate = glr * 0.5 * (1 + math.cos(math.pi * min(k, decay_steps)
                                                 / decay_steps))
                for i in idx:
                    mu[i] = (1 - B1) * grads[i] + B1 * mu[i]
                    nu[i] = (1 - B2) * grads[i] ** 2 + B2 * nu[i]
                    u = (mu[i] / bc1) / (torch.sqrt(nu[i] / bc2) + EPS)
                    leaves[i].sub_(rate * u)
    return {
        "loss": losses,
        "grad1": grad1,
        "change": [float(torch.linalg.vector_norm(t.detach() - s))
                   for t, s in zip(leaves, start)],
        "params": [{"degrees": lp["degrees"], "coefficients": c.detach(),
                    "horizontal_weights": h.detach()}
                   for lp, c, h in zip(params, coef, hw)],
    }


# -- structure search ----------------------------------------------------


def layer_sweep(x: torch.Tensor, y: torch.Tensor, max_degree: int,
                ridge: float, apply_tanh: bool) -> tuple[np.ndarray, list]:
    """Scores [D+1] and coefficients ([in, d+1, T] for each d) of the
    cumulative-degree ridge fits of y on the Chebyshev design of x.

    The ridge is ``ridge`` times the mean diagonal of the whole Gram
    matrix; each fit takes one refinement step against the unridged
    normal equations.  The ridged block is solved by LU, which gives a
    number at any precision.
    """
    t = torch.tanh(x) if apply_tanh else x
    basis = chebyshev(t, max_degree)  # [B, in, D+1]
    b, n = x.shape
    X = basis.transpose(1, 2).reshape(b, -1)  # degree major
    G = X.T @ X
    bvec = X.T @ y
    lam = ridge * torch.trace(G) / G.shape[0]
    scores, coeffs = [], []
    for d in range(max_degree + 1):
        k = (d + 1) * n
        Gk = G[:k, :k]
        A = Gk + lam * torch.eye(k, dtype=G.dtype, device=G.device)
        lu, piv, _ = torch.linalg.lu_factor_ex(A)
        c = torch.linalg.lu_solve(lu, piv, bvec[:k])
        c = c + torch.linalg.lu_solve(lu, piv, bvec[:k] - Gk @ c)
        r = y - X[:, :k] @ c
        scores.append(float(torch.mean(r * r)))
        coeffs.append(c.reshape(d + 1, n, -1).transpose(0, 1))
    return np.array(scores), coeffs


def penalized(scores: np.ndarray, weight: float) -> np.ndarray:
    d = np.arange(len(scores), dtype=np.float64)
    return np.asarray(scores, dtype=np.float64) + weight * d**2
