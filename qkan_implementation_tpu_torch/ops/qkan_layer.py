"""The QKAN layer forward: DILATE/CHEB -> MUL -> LCU -> SUM, on torch.

Counterpart of ``qkan_implementation_tpu.ops.qkan_layer``.  The layer is
a handful of elementwise ops and one reduction, O(d*N*K) work,
differentiable, with a batched variant as one matmul and the int8 serving
recipes (``qkan_layer_forward_batched_int8``, ``int8_quantized_matmul``,
``int8_residual_matmul``): int8 x int8 -> int32 products, on the card by
``torch._int_mm``.

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
            f"unsupported compute_dtype {compute_dtype!r} (int8 serving is "
            "qkan_layer_forward_batched_int8)"
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


def qkan_layer_forward_batched_int8(
    x: torch.Tensor, weights: torch.Tensor, N: int, K: int
) -> torch.Tensor:
    """Inference-only int8 path: [B, N] -> [B, K] float32.

    The basis is bounded in [-1, 1] (T_d of clipped inputs), so a static
    symmetric scale of 127 quantises it; the folded weights take a
    per-output-column symmetric scale; the product accumulates in int32
    and is dequantised once.  Rounding has no gradient: serving only.
    """
    max_degree = weights.shape[0] - 1
    basis = chebyshev_basis(x, max_degree)  # [B, N, D+1] in [-1, 1]
    b = x.shape[0]
    M2 = qkan_weight_tensor(weights, N, K).reshape(K, -1).T  # [F, K]
    return int8_quantized_matmul(basis.reshape(b, -1), M2)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def int8_matmul(qa: torch.Tensor, qw: torch.Tensor) -> torch.Tensor:
    """int8 [B, F] @ int8 [F, K] -> int32 [B, K], exact.

    On a CPU tensor: float64 products of the integer values, exact while
    127^2 * F < 2^53.  On a CUDA tensor: ``torch._int_mm``, whose cuBLASLt
    route takes more than 16 rows, F and K multiples of 8 and a
    column-major right operand; zero rows and columns pad the operands to
    that (the sums stay exact) and are cut from the result.  Where the
    card's torch refuses the product, it raises: there is no float route.
    """
    if qa.dtype != torch.int8 or qw.dtype != torch.int8:
        raise ValueError(f"int8 operands expected, got {qa.dtype}, {qw.dtype}")
    if qa.device.type == "cpu":
        return (qa.to(torch.float64) @ qw.to(torch.float64)).to(torch.int32)
    if qa.device.type != "cuda":
        raise ValueError(f"unsupported device {qa.device}: 'cpu' or 'cuda'")
    b, f = qa.shape
    k = qw.shape[1]
    bp, fp, kp = max(24, _round_up(b, 8)), _round_up(f, 8), _round_up(k, 8)
    if (bp, fp) != (b, f) or not qa.is_contiguous():
        qa_p = torch.zeros((bp, fp), dtype=torch.int8, device=qa.device)
        qa_p[:b, :f] = qa
        qa = qa_p
    qw_t = torch.zeros((kp, fp), dtype=torch.int8, device=qw.device)
    qw_t[:k, :f] = qw.T
    return torch._int_mm(qa, qw_t.T)[:b, :k]


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c rounded once, on every device.  torch's CUDA division by a
    Python number multiplies by its reciprocal, which can be an ulp off
    and move a quantisation rounding across a half; a tensor divisor on
    x's device takes the true division."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def int8_quantized_matmul(basis2d: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """``[B, F] @ [F, K] -> [B, K] float32`` on one int8 level.

    ``basis2d`` must lie in [-1, 1] (static scale 127); ``W`` takes a
    per-column symmetric scale; int32 accumulation, one float32
    dequantisation.  Shared with ``models.fixed_kan.kan_layer_apply``.
    """
    s_w = _div(torch.amax(torch.abs(W), dim=0, keepdim=True), 127.0)
    qa = torch.round(basis2d * 127.0).to(torch.int8)
    qw = torch.round(W / torch.clamp_min(s_w, 1e-30)).to(torch.int8)
    acc = int8_matmul(qa, qw)
    # the scale goes to float32 too: a float64 one would promote the
    # float32 output
    return acc.to(torch.float32) * _div(s_w, 127.0).to(torch.float32)


def int8_residual_matmul(
    basis2d: torch.Tensor, W: torch.Tensor, acts_residual: bool = True
) -> torch.Tensor:
    """``[B, F] @ [F, K] -> [B, K] float32`` on two int8 levels.

    One int8 level random-walks its ~1/254 rounding through a wide
    contraction into O(1) error (the flagship's F = 4704), so the weights
    always take a second level, an int8 encoding of the first level's
    rounding residual (|residual * 127 * 254| <= 127): ~1/254^2
    resolution.  ``acts_residual=True`` (the 'int8x2' recipe) does the
    same for the basis, three int8 products:

        a @ W ~= s/127^2 * [qa1@qw1 + (qa1@qw2 + qa2@qw1)/254]

    (qa2@qw2 is O(1/254^2) and dropped); ``False`` ('int8x2w') keeps the
    basis at one level, two products.  Same contracts as
    ``int8_quantized_matmul``.
    """
    s_w = torch.clamp_min(torch.amax(torch.abs(W), dim=0, keepdim=True), 1e-30)
    wn = W / s_w  # columns span [-1, 1]
    qw1 = torch.round(wn * 127.0)
    qw2 = torch.round((wn - _div(qw1, 127.0)) * (127.0 * 254.0))
    qa1 = torch.round(basis2d * 127.0)
    qw1, qw2 = qw1.to(torch.int8), qw2.to(torch.int8)

    def dot(a, b):
        return int8_matmul(a, b).to(torch.float32)

    if acts_residual:
        qa2 = torch.round((basis2d - _div(qa1, 127.0)) * (127.0 * 254.0))
        qa1, qa2 = qa1.to(torch.int8), qa2.to(torch.int8)
        acc = dot(qa1, qw1) + _div(dot(qa1, qw2) + dot(qa2, qw1), 254.0)
    else:
        qa1 = qa1.to(torch.int8)
        acc = dot(qa1, qw1) + _div(dot(qa1, qw2), 254.0)
    return acc * _div(s_w, 127.0 * 127.0).to(torch.float32)


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
