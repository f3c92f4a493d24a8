"""QSVT neuron: classical vs quantum coefficient optimization on one neuron.

Counterpart of ``qkan_implementation_tpu.models.qsvt_neuron``:

- ``optimize_classical``: cumulative Chebyshev transform + lstsq;
- ``optimize_quantum``: block-encode the (padded, normalized) transform
  matrix with FABLE, recover it from the simulated circuit unitary
  (``alpha * dim * U[:r, :c]``), then solve -- reporting the quantum
  resource usage dict (n_qubits, depth, gate count, alpha).

The unitary is simulated on ``device`` (the card unless the caller asks
for the CPU), in torch's default precision (float64 when
``torch.get_default_dtype()`` is float64).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from qkan_implementation_tpu_torch.encoding.fable import fable
from qkan_implementation_tpu_torch.ops.chebyshev import cumulative_transform
from qkan_implementation_tpu_torch.sim.statevector import unitary


class QSVTNeuron:
    """Single KAN neuron with classical and quantum-verified optimization."""

    def __init__(self, input_dim: int, max_degree: int, device="cuda"):
        self.input_dim = input_dim
        self.max_degree = max_degree
        self.device = device
        self.coefficients: np.ndarray | None = None
        self.last_quantum_resources: Dict | None = None

    def _transform(self, x: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.asarray(x).reshape(-1, self.input_dim))
        return cumulative_transform(x, self.max_degree).numpy()

    def optimize_classical(self, x: np.ndarray, y: np.ndarray) -> np.ndarray:
        """lstsq fit; returns predictions on x."""
        X = self._transform(x)
        y = np.asarray(y).reshape(-1, 1)
        self.coefficients = np.linalg.lstsq(X, y, rcond=None)[0]
        return X @ self.coefficients

    def optimize_quantum(self, x: np.ndarray, y: np.ndarray) -> np.ndarray:
        """Fit via the block-encoded transform matrix.

        The design matrix X is FABLE-encoded, recovered from the simulated
        circuit unitary, and the least-squares problem is solved against
        the *recovered* matrix -- so any encoding error propagates into
        the fit.
        """
        X = self._transform(x)
        y = np.asarray(y).reshape(-1, 1)
        rows, cols = X.shape

        circuit, alpha = fable(X)
        u = unitary(circuit, device=self.device).cpu().numpy()
        dim = 2 ** ((circuit.num_qubits - 1) // 2)
        encoded = np.asarray(u[:dim, :dim]).real * alpha * dim
        X_rec = encoded[:rows, :cols]

        self.last_quantum_resources = {
            "n_qubits": circuit.num_qubits,
            "circuit_depth": circuit.depth(),
            "gate_count": circuit.gate_count,
            "alpha_scaling": float(alpha),
        }
        self.coefficients = np.linalg.lstsq(X_rec, y, rcond=None)[0]
        return X @ self.coefficients

    def forward(self, x: np.ndarray) -> np.ndarray:
        if self.coefficients is None:
            raise RuntimeError("Neuron coefficients not set. Run optimization first.")
        return self._transform(np.tanh(np.asarray(x))) @ self.coefficients


def compare_classical_quantum(
    x: np.ndarray, y: np.ndarray, input_dim: int = 1, max_degree: int = 2,
    device="cuda",
) -> Tuple[float, float, Dict]:
    """Fit one neuron both ways on the canonical quadratic and return
    (classical_mse, quantum_mse, resources)."""
    neuron = QSVTNeuron(input_dim=input_dim, max_degree=max_degree,
                        device=device)
    y_classical = neuron.optimize_classical(x, y)
    classical_mse = float(np.mean((np.asarray(y).reshape(-1, 1) - y_classical) ** 2))
    y_quantum = neuron.optimize_quantum(x, y)
    quantum_mse = float(np.mean((np.asarray(y).reshape(-1, 1) - y_quantum) ** 2))
    return classical_mse, quantum_mse, neuron.last_quantum_resources
