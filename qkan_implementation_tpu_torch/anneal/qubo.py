"""Analytic QUBO assembly for the QKAN degree-selection problem.

A numpy copy of ``qkan_implementation_tpu.anneal.qubo``: the port keeps
its own, so it imports nothing of the JAX package.

The reference builds its QUBO symbolically with pyqubo and compiles it with
the C++ ``cpp_pyqubo`` (``DegreeOptimizer.py:211-234``,
``KAN_w_cumulative_polynomials.py:148-162``).  The problem is structured --
per-function one-hot selection with linear reward/penalty terms -- so here Q
is assembled analytically as dense arrays, ready for the on-device annealer.

Variable layout: q[i, d] -> flat index i * (max_degree + 1) + d, for
``num_functions`` functions and degrees 0..max_degree.  Energy convention:

    E(s) = offset + h . s + 1/2 * s^T J s      (J symmetric, zero diagonal)

which for binary s equals the usual sum over i<j of J_ij s_i s_j.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

ONE_HOT_PENALTY = 10.0  # reference DegreeOptimizer.py:230
DEFINITIVE_BONUS = 100.0  # reference DegreeOptimizer.py:214-219


@dataclass
class QuboModel:
    """A compiled QUBO: symmetric coupling J, linear h, constant offset."""

    h: np.ndarray  # [n]
    J: np.ndarray  # [n, n] symmetric, zero diagonal
    offset: float

    @property
    def num_variables(self) -> int:
        return self.h.shape[0]

    def energy(self, s: np.ndarray) -> np.ndarray:
        """E(s) for one sample [n] or a batch [R, n]."""
        s = np.asarray(s, dtype=self.h.dtype)
        lin = s @ self.h
        quad = 0.5 * np.einsum("...i,ij,...j->...", s, self.J, s)
        return lin + quad + self.offset


def qubo_energy(model: QuboModel, s) -> np.ndarray:
    return model.energy(s)


def degree_selection_qubo(
    scores: np.ndarray,
    num_functions: int,
    complexity_weight: float = 0.1,
    definitive_degree: int | None = None,
    one_hot_penalty: float = ONE_HOT_PENALTY,
    objective: str = "reference",
) -> QuboModel:
    """Assemble the degree-selection QUBO of the reference optimizers.

    For each of ``num_functions`` functions and degrees d in 0..D:

      - improvement reward: -(scores[d] - scores[d-1]) * q[i,d]
        (-(scores[0]) at d=0) and complexity penalty
        ``complexity_weight * d^2 * q[i,d]``  (DegreeOptimizer.py:221-225);
      - or, when a ``definitive_degree`` is given, the +/-100 shortcut
        (DegreeOptimizer.py:214-219);
      - one-hot constraint 10 * (sum_d q[i,d] - 1)^2  (DegreeOptimizer.py:227-230).

    ``scores`` is the per-degree MSE array [D+1] (shared across functions,
    exactly as the reference applies layer-level scores to every edge).

    ``objective``:
      - ``'reference'`` replicates the reference reward exactly.  NOTE: that
        reward is degenerate -- ``improvement[0] = scores[0]`` (the raw MSE)
        makes degree 0 the QUBO optimum whenever MSE is positive, so the
        reference's structure search effectively always picks degree 0 in
        the FixedKAN path (its own MSE < 0.1 test bars pass only because the
        target variance is below 0.1).  Kept as the default for behavioral
        parity.
      - ``'penalized_mse'`` selects argmin_d scores[d] + cw*d^2 -- the
        evident intent, and the mode that makes degree search useful.
    """
    scores = np.asarray(scores, dtype=np.float64)
    dp1 = scores.shape[0]
    n = num_functions * dp1

    h = np.zeros(n)
    J = np.zeros((n, n))
    offset = 0.0

    degrees = np.arange(dp1, dtype=np.float64)
    if definitive_degree is not None:
        lin = np.full(dp1, DEFINITIVE_BONUS)
        lin[definitive_degree] = -DEFINITIVE_BONUS
    elif objective == "reference":
        improvement = np.empty(dp1)
        improvement[0] = scores[0]
        improvement[1:] = scores[1:] - scores[:-1]
        lin = -improvement + complexity_weight * degrees**2
    elif objective == "penalized_mse":
        lin = scores + complexity_weight * degrees**2
    else:
        raise ValueError(f"Unknown objective {objective!r}")

    for i in range(num_functions):
        sl = slice(i * dp1, (i + 1) * dp1)
        # one-hot: P*(sum q - 1)^2 = P*(sum q + 2*sum_{d<d'} qq' - 2*sum q + 1)
        h[sl] += lin - one_hot_penalty  # q^2 = q collapses into linear
        block = np.full((dp1, dp1), 2.0 * one_hot_penalty)
        np.fill_diagonal(block, 0.0)
        J[sl, sl] += block
        offset += one_hot_penalty

    return QuboModel(h=h, J=J, offset=offset)


def decode_degrees(
    sample: np.ndarray,
    input_dim: int,
    output_dim: int,
    max_degree: int,
) -> list[list[int]]:
    """Decode a flat binary sample into per-(out, in) degree choices.

    Matches the reference decode: function index ``out * input_dim + in``,
    first set degree bit wins (``DegreeOptimizer.py:242-254``).  A function
    with no set bit decodes to degree 0 (the reference would silently skip,
    leaving a ragged list -- a latent bug we do not replicate).
    """
    dp1 = max_degree + 1
    sample = np.asarray(sample).reshape(input_dim * output_dim, dp1)
    degrees = []
    for out_idx in range(output_dim):
        row = []
        for in_idx in range(input_dim):
            q = sample[out_idx * input_dim + in_idx]
            hits = np.flatnonzero(q)
            row.append(int(hits[0]) if hits.size else 0)
        degrees.append(row)
    return degrees
