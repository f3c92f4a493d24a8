"""The optax pieces ``FixedKAN.train`` uses, on torch tensors.

The JAX package trains with ``optax.multi_transform`` over label groups,
each group ``optax.chain(clip_by_global_norm, adam(lr or
cosine_decay_schedule))`` or ``set_to_zero``.  ``AdamGroup`` is one such
group, step for step to optax's arithmetic:

- clipping takes ONE global norm over the group's gradients (not over
  all parameters): g <- g if |g| < max_norm else (g / |g|) * max_norm;
- Adam with b1 = 0.9, b2 = 0.999, eps = 1e-8 outside the square root:
  mu <- (1 - b1) g + b1 mu, nu <- (1 - b2) g^2 + b2 nu, then
  u = (mu / (1 - b1^k)) / (sqrt(nu / (1 - b2^k)) + eps) at step k >= 1;
- the update is -lr_k * u with lr_k = lr * 1/2 (1 + cos(pi min(k-1, K) / K))
  under the cosine schedule over K steps, else lr.

A ``set_to_zero`` group is a parameter that is never handed to a group:
its value and its state stay as they are.  Everything runs on the
parameters' device without a host round trip.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

B1, B2, EPS = 0.9, 0.999, 1e-8


def cosine_decay(lr: float, decay_steps: int, count: int) -> float:
    """optax.cosine_decay_schedule(lr, decay_steps) at ``count``."""
    if not decay_steps > 0:
        raise ValueError(
            f"cosine decay needs positive decay_steps, got {decay_steps}"
        )
    k = min(count, decay_steps)
    return lr * (0.5 * (1 + math.cos(math.pi * k / decay_steps)))


class AdamGroup:
    """Clip-by-global-norm (optional) + Adam over one group of leaves."""

    def __init__(
        self,
        params: Sequence[torch.Tensor],
        lr: float,
        grad_clip: Optional[float] = None,
        decay_steps: Optional[int] = None,
    ):
        self.params = list(params)
        self.lr = lr
        self.grad_clip = grad_clip
        self.decay_steps = decay_steps
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def _lr(self) -> float:
        if self.decay_steps is None:
            return self.lr
        return cosine_decay(self.lr, self.decay_steps, self.count)

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        """Apply one update in place from the group's gradients."""
        grads = list(grads)
        if self.grad_clip:
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            keep = norm < self.grad_clip
            grads = [
                torch.where(keep, g, (g / norm.to(g.dtype)) * self.grad_clip)
                for g in grads
            ]
        step = -self._lr()
        self.count += 1
        bc1 = 1 - B1 ** self.count
        bc2 = 1 - B2 ** self.count
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu.copy_((1 - B1) * g + B1 * mu)
            nu.copy_((1 - B2) * (g * g) + B2 * nu)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + EPS)
            p.copy_(p + step * u)
