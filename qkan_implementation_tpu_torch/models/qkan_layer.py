"""QKANLayer training on the fused one-kernel train step (K5).

The reference's ``QKANLayer(N, K, max_degree)``
(``QKAN_Steps_original/QKANLayer.py:12-135``) maps N inputs to K outputs
through DILATE + CHEB -> MUL -> LCU -> SUM with per-degree weights
``[D+1, N*K]`` (``ops.qkan_layer``'s contract).  The reference solves for
those weights; this module trains them by gradient on the mean squared
error, one step a batch:

- fold the weights into K5's degree-major ``w2 [(D+1)*N, K]``: the
  layer's contraction tensor (``ops.qkan_layer.qkan_weight_tensor``, its
  1/(N(D+1)) factor and the Fortran-order SUM absorbed) laid out [D+1,
  N, K] as ``experimental.pallas_layer.weights_to_m3`` lays it, computed
  as a gather and a sum (no scatter: a few launches, and the same bits
  every call);
- ``kan_train_step_fused(x_b, w2, D+1, y_b, loss='mse',
  apply_tanh=False)``: the loss and dW in one library call (K5 and its
  fixed-order dW pass on a CUDA tensor, the plain version on a CPU one);
- map dW back to the weights through the fold's transpose (the fold is
  linear: weight column j = k*N + i feeds w2's slot (j // K, k), so its
  gradient is dW[d*N + j // K, k] / (N(D+1)));
- one ``AdamGroup`` step (b1 0.9, b2 0.999, eps 1e-8; no clip, no
  schedule).

K5 builds the Chebyshev basis of x unclipped; the reference clips x to
[-1, 1] first, so the data must lie in [-1, 1], where the two agree.

``qkan_layer_train`` walks the rows in contiguous batches (each a view:
nothing is gathered), keeps the step losses on the weights' device and
brings them to the host once an epoch.  ``QKANLayerTrainer.record_steps``
keeps what a caller checks the steps by (losses, the first step's
gradient, the weights after each step) without a host read and without
rebinding anything.  A float64 CPU run keeps every step in float64.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from qkan_implementation_tpu_torch.models._optim import AdamGroup
from qkan_implementation_tpu_torch.ops import fused_layer
from qkan_implementation_tpu_torch.ops._cuda_build import count_launches
from qkan_implementation_tpu_torch.utils import profiling
from qkan_implementation_tpu_torch.utils.profiling import span


@dataclass
class StepRecord:
    """What ``record_steps(n)`` keeps of the next ``n`` steps, on the
    weights' device: the weights and Adam's state (first and second
    moments, step count) before the first, each step's loss (0-dim), the
    first step's gradient w.r.t. the weights [D+1, N*K] and the weights
    after each step."""

    steps: int
    start: torch.Tensor
    mu: torch.Tensor
    nu: torch.Tensor
    count: int
    losses: List[torch.Tensor] = field(default_factory=list)
    grad: Optional[torch.Tensor] = None
    weights: List[torch.Tensor] = field(default_factory=list)

    @property
    def done(self) -> bool:
        return len(self.losses) == self.steps


class QKANLayerTrainer:
    """The weights of one QKANLayer and their Adam state.

    ``weights``: [D+1, N*K], float32 for K5 on the card (a CPU tensor may
    be float64); copied, so the caller's tensor is left as it is.
    """

    def __init__(self, weights: torch.Tensor, N: int, K: int,
                 learning_rate: float = 1e-3):
        if weights.dim() != 2 or weights.shape[1] != N * K:
            raise ValueError(
                f"weights must be [D+1, N*K] = [D+1, {N * K}], got "
                f"{tuple(weights.shape)}"
            )
        self.N, self.K = N, K
        self.dp1 = weights.shape[0]
        self.weights = weights.detach().clone()
        self.adam = AdamGroup([self.weights], learning_rate)
        # weight column j = k*N + i feeds slot (n, k) of w2's [N, K], n =
        # j // K (ops.qkan_layer's fold); a slot sums its columns in j's
        # order, padded to the fullest slot with zero coefficients
        dev = weights.device
        j = np.arange(N * K)
        slot = (j // K) * K + j // N
        width = int(np.bincount(slot).max())
        src = np.zeros((N * K, width), dtype=np.int64)
        coef = np.zeros((N * K, width))
        for s in range(N * K):
            cols = j[slot == s]
            src[s, : len(cols)] = cols
            coef[s, : len(cols)] = 1.0 / (N * self.dp1)
        self._slot = torch.as_tensor(slot, device=dev)
        self._src = torch.as_tensor(src.reshape(-1), device=dev)
        self._coef = torch.as_tensor(coef, dtype=weights.dtype, device=dev)
        self._record: Optional[StepRecord] = None

    def fold(self, weights: torch.Tensor) -> torch.Tensor:
        """[D+1, N*K] -> K5's degree-major w2 [(D+1)*N, K], contiguous:
        ``weights_to_m3(weights, N, K)`` laid out as [(D+1)*N, K], by one
        gather, one product and one sum."""
        terms = torch.index_select(weights, 1, self._src)
        terms = terms.view(self.dp1, *self._coef.shape).mul_(self._coef)
        return terms.sum(-1).view(self.dp1 * self.N, self.K)

    def unfold(self, dw: torch.Tensor) -> torch.Tensor:
        """The fold's transpose: dW [(D+1)*N, K] -> [D+1, N*K]."""
        per_col = torch.index_select(dw.view(self.dp1, -1), 1, self._slot)
        return per_col.mul_(1.0 / (self.N * self.dp1))

    def record_steps(self, steps: int) -> StepRecord:
        """Keep the state before the next ``steps`` steps, their losses,
        the first one's gradient and the weights after each, in the
        record returned (filled as the steps run)."""
        if steps < 1:
            raise ValueError(f"record at least one step, got {steps}")
        adam = self.adam
        self._record = StepRecord(steps, self.weights.detach().clone(),
                                  adam.mu[0].clone(), adam.nu[0].clone(),
                                  adam.count)
        return self._record

    def step(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """One training step on rows x [B, N] with targets y [B, K];
        returns the step's loss (before its update), 0-dim, on the
        weights' device."""
        with span(profiling.QLAYER_STEP):
            with span(profiling.QLAYER_FUSED_STEP):
                loss, dw = fused_layer.kan_train_step_fused(
                    x, self.fold(self.weights), self.dp1, y, loss="mse",
                    apply_tanh=False,
                )
                grad = self.unfold(dw)
            with span(profiling.QLAYER_ADAM):
                self.adam.step([grad])
        rec = self._record
        if rec is not None:
            if rec.grad is None:
                rec.grad = grad
            rec.losses.append(loss)
            rec.weights.append(self.weights.detach().clone())
            if rec.done:
                self._record = None
        return loss


def qkan_layer_train(trainer: QKANLayerTrainer, x: torch.Tensor,
                     y: torch.Tensor, batch_size: int,
                     epochs: int = 1) -> np.ndarray:
    """Train ``trainer`` on rows x [n, N] with targets y [n, K] for
    ``epochs`` epochs of n // batch_size contiguous batches (the rows
    past the last whole batch are left out).  The losses come to the
    host once an epoch; returns them as float64 [epochs, steps].  Counts
    the steps on ``qkan_layer_train.steps``."""
    n = x.shape[0]
    if x.dim() != 2 or x.shape[1] != trainer.N:
        raise ValueError(f"x must be [n, {trainer.N}], got {tuple(x.shape)}")
    if tuple(y.shape) != (n, trainer.K):
        raise ValueError(
            f"y must be [{n}, {trainer.K}], got {tuple(y.shape)}"
        )
    if not 1 <= batch_size <= n:
        raise ValueError(f"batch_size must be in [1, {n}], got {batch_size}")
    steps = n // batch_size
    out = np.empty((epochs, steps))
    with span(profiling.QLAYER_TRAIN):
        for e in range(epochs):
            with span(profiling.QLAYER_EPOCH):
                losses = torch.stack([
                    trainer.step(x[s * batch_size:(s + 1) * batch_size],
                                 y[s * batch_size:(s + 1) * batch_size])
                    for s in range(steps)
                ])
                with span(profiling.QLAYER_EPOCH_END):
                    out[e] = losses.cpu().numpy()
            count_launches(qkan_layer_train, "steps", steps)
    return out


qkan_layer_train.steps = 0
