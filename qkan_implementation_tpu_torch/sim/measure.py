"""Measurement & sampling on statevectors, on torch.

Counterpart of ``qkan_implementation_tpu.sim.measure``: probabilities,
counts, expectation values and marginals of a state [2^q].  Sampling takes
a ``torch.Generator`` in place of a JAX key; the two draw different
samples from the same seed, so they agree in distribution only.
"""

from __future__ import annotations

import numpy as np
import torch


def probabilities(psi: torch.Tensor) -> torch.Tensor:
    """|amplitude|^2, normalized (guards simulator round-off)."""
    p = torch.abs(psi) ** 2
    return p / torch.sum(p)


def sample_counts(psi: torch.Tensor, shots: int,
                  generator: torch.Generator | None = None):
    """Measurement counts over ``shots`` samples (host-side).

    ``generator`` lives on psi's device (None: torch's default one).
    Returns (bitstring_indices [shots], counts dict {basis_index: count}).
    """
    p = probabilities(psi)
    idx = torch.multinomial(p, shots, replacement=True, generator=generator)
    idx_np = idx.cpu().numpy()
    unique, counts = np.unique(idx_np, return_counts=True)
    return idx_np, {int(u): int(c) for u, c in zip(unique, counts)}


def expectation_diagonal(psi: torch.Tensor, diag: torch.Tensor) -> torch.Tensor:
    """<psi| D |psi> for a diagonal observable D (e.g. Z-string energies)."""
    return torch.sum(probabilities(psi) * diag)


def marginal_probabilities(psi: torch.Tensor, qubits, num_qubits: int) -> torch.Tensor:
    """Probability distribution over a subset of qubits (qubits[0] = MSB of
    the result index), marginalizing the rest."""
    p = probabilities(psi).reshape(-1)
    size = p.shape[0]
    idx = np.zeros(size, dtype=np.int64)
    r = np.arange(size)
    k = len(qubits)
    for i, t in enumerate(qubits):
        idx |= ((r >> t) & 1) << (k - 1 - i)
    out = torch.zeros(2**k, dtype=p.dtype, device=p.device)
    return out.index_add(0, torch.as_tensor(idx, device=p.device), p)
