"""The QKAN layer forward: DILATE/CHEB -> MUL -> LCU -> SUM, on torch.

Counterpart of ``qkan_implementation_tpu.ops.qkan_layer`` (its int8
serving recipes are not ported yet: ROADMAP.md, Queue 1: the int8 recipes).  The layer
is a handful of elementwise ops and one reduction, O(d*N*K) work,
differentiable, with a batched variant as one matmul.

Semantics contract (pinned by the JAX package's golden tests, and by the
port's tests against it):

  dilated_d[j]  = T_d(x[j // K])                      j in [0, N*K)
  weighted_d[j] = dilated_d[j] * w_d[j]               (MulStep.py:41-72)
  lcu[j]        = sum_d weighted_d[j] / (D+1)         (LCUStep.py:34-36)
  out[k]        = sum_{i<N} lcu[i + k*N] / N          (SUMStep.py:28-30,
                                                       Fortran-order reshape)

``x`` may carry leading batch axes ([..., N]) in every function but
``qkan_layer_forward_batched``, which takes [B, N].
"""

from __future__ import annotations

import numpy as np
import torch

from qkan_implementation_tpu_torch.ops.chebyshev import (
    chebyshev_basis,
    chebyshev_t,
    dilate,
)


def weighted_chebyshev_diag(
    x: torch.Tensor, weights: torch.Tensor, K: int, degree: int
) -> torch.Tensor:
    """Diagonal of one weighted Chebyshev term: T_degree dilated * w_degree.

    ``x``: [N]; ``weights``: [N*K] with |w| <= 1.
    """
    t = chebyshev_t(x, degree)
    return dilate(t, K) * weights


def lcu_combine_diag(x: torch.Tensor, weights: torch.Tensor, K: int) -> torch.Tensor:
    """Diagonal of the LCU-combined matrix: uniform 1/(D+1) average.

    ``x``: [..., N]; ``weights``: [D+1, N*K].  Returns [..., N*K].
    """
    max_degree = weights.shape[0] - 1
    basis = chebyshev_basis(x, max_degree)  # [..., N, D+1]
    dilated = dilate(basis.transpose(-1, -2), K)  # [..., D+1, N*K]
    return torch.mean(dilated * weights, dim=-2)


def sum_step(lcu_diag: torch.Tensor, N: int, K: int) -> torch.Tensor:
    """SUM step: Fortran-order (N, K) reshape, mean over the N inputs.

    out[k] = (1/N) * sum_i lcu_diag[i + k*N].  The C-order reshape to
    (K, N) is the transpose of the reference's Fortran-order (N, K)
    reshape (``SUMStep.py:28-30``), so summing its last axis reproduces
    the exact semantics.
    """
    return torch.sum(lcu_diag.reshape(*lcu_diag.shape[:-1], K, N), dim=-1) / N


def qkan_layer_forward(
    x: torch.Tensor, weights: torch.Tensor, N: int, K: int
) -> torch.Tensor:
    """Full QKAN layer forward: [..., N] inputs -> [..., K] outputs.

    ``weights``: [max_degree+1, N*K], |w| <= 1.
    """
    lcu = lcu_combine_diag(x, weights, K)
    return sum_step(lcu, N, K)


def qkan_weight_tensor(weights: torch.Tensor, N: int, K: int) -> torch.Tensor:
    """Fold the per-degree weight vectors into the layer's contraction
    tensor M [K, N, D+1]:

      out[b, k] = sum_{n, d} T_d(x[b, n]) * M[k, n, d]

    which is exactly the DILATE->MUL->LCU->SUM composition (the
    1/(N(D+1)) normalization and the Fortran-order SUM gather are absorbed
    into M).  Differentiable in ``weights`` (a linear scatter-add).
    """
    dp1 = weights.shape[0]
    dev = weights.device
    j_idx, k_idx, n_idx = _fold_indices(N, K, dev)
    w_g = weights[:, j_idx].permute(1, 2, 0)
    M = torch.zeros((K, N, dp1), dtype=weights.dtype, device=dev)
    M = M.index_put((k_idx, n_idx), w_g.reshape(K * N, dp1), accumulate=True)
    return M / (N * dp1)


# (N, K, device) -> the fold's index tensors, uploaded once: a pageable
# host-to-device copy costs far more than its bytes
_FOLD_INDICES: dict = {}


def _fold_indices(N: int, K: int, device: torch.device) -> tuple:
    """(j [K, N], k [K*N], n [K*N]): slot (k, i) reads weight column
    j = k*N + i and feeds input feature j // K."""
    key = (N, K, device)
    idx = _FOLD_INDICES.get(key)
    if idx is None:
        j = np.arange(K)[:, None] * N + np.arange(N)[None, :]
        k = np.broadcast_to(np.arange(K)[:, None], (K, N))
        # ordinary tensors even under inference_mode, so a later call that
        # records autograd may save them
        with torch.inference_mode(False):
            idx = tuple(torch.as_tensor(a, device=device)
                        for a in (j, k.reshape(-1), (j // K).reshape(-1)))
        _FOLD_INDICES[key] = idx
    return idx


def _compute_dtype(compute_dtype):
    if compute_dtype is None or isinstance(compute_dtype, torch.dtype):
        return compute_dtype
    dtype = getattr(torch, str(compute_dtype), None)
    if not isinstance(dtype, torch.dtype) or dtype == torch.int8:
        raise ValueError(
            f"unsupported compute_dtype {compute_dtype!r} (the int8 recipes "
            "are not ported yet: ROADMAP.md, Queue 1: the int8 recipes)"
        )
    return dtype


def qkan_layer_forward_batched(
    x: torch.Tensor, weights: torch.Tensor, N: int, K: int,
    compute_dtype=None,
) -> torch.Tensor:
    """Batched layer forward: [B, N] -> [B, K] as one matmul over the
    combined (feature, degree) axis, [B, N*(D+1)] @ [N*(D+1), K].

    ``compute_dtype``: optional multiply dtype for the mixed-precision
    recipe (``torch.bfloat16`` or its name), with ``x`` already stored in
    it: the basis and the folded weights round to it, the products and
    sums are float32 (bf16 values widened to f32 multiply exactly), and
    the output is float32.  ``None`` keeps x's dtype for storage and
    products, at torch's matmul precision for it (TF32 only if the caller
    turned it on).
    """
    compute_dtype = _compute_dtype(compute_dtype)
    max_degree = weights.shape[0] - 1
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    basis = chebyshev_basis(x, max_degree)  # [B, N, D+1]
    M = qkan_weight_tensor(weights, N, K)  # [K, N, D+1]
    b = x.shape[0]
    M2 = M.reshape(K, -1).T
    a2d = basis.reshape(b, -1)
    if compute_dtype is not None:
        M2 = M2.to(compute_dtype)
        return a2d.to(torch.float32) @ M2.to(torch.float32)
    acc = torch.promote_types(a2d.dtype, M2.dtype)
    return (a2d.to(acc) @ M2.to(acc)).to(basis.dtype)


def qkan_intermediates(
    x: torch.Tensor, weights: torch.Tensor, N: int, K: int
) -> dict:
    """Expose every stage of the pipeline for debugging: diagonals rather
    than dense matrices; ``reshaped`` uses the Fortran-order (N, K)
    layout."""
    max_degree = weights.shape[0] - 1
    basis = chebyshev_basis(x, max_degree)  # [N, D+1]
    dilated = dilate(basis.T, K)  # [D+1, N*K]
    weighted = dilated * weights
    lcu = torch.mean(weighted, dim=0)
    reshaped = lcu.reshape(K, N).T  # Fortran-order (N, K)
    final = torch.sum(reshaped, dim=0) / N
    return {
        "input": x,
        "cheb": {d: dilated[d] for d in range(max_degree + 1)},
        "weighted": {d: weighted[d] for d in range(max_degree + 1)},
        "lcu": lcu,
        "reshaped": reshaped,
        "final": final,
    }
