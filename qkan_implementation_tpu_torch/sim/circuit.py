"""Gate IR: circuits as data, not framework objects.

Counterpart of ``qkan_implementation_tpu.sim.circuit``.  A circuit is a
plain list of ``Gate`` records; builders (FABLE in ``encoding.fable``)
emit data and the statevector engine consumes it.  Qubit convention is
little-endian: qubit ``t`` carries bit weight ``2**t`` in the basis-state
index (top-left block = low-qubit system register).

Parameters follow one rule: a ``torch.Tensor`` passes through untouched
(it may carry grad, and a ucry/diag parameter may have a leading batch
axis, one row of angles per state of a batched simulation); anything else
becomes a static float64 numpy array.  The engine routes the two kinds
differently (``sim.statevector.simulate``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch


def _as_param_array(values):
    """Keep tensors as they are (differentiable circuit parameters);
    convert python/numpy inputs to a static flat float64 array."""
    if isinstance(values, torch.Tensor):
        return values
    return np.asarray(values).reshape(-1)


@dataclass(frozen=True, eq=False)
class Gate:
    """One gate: a name, target qubit tuple, and parameters.

    For multi-qubit gates the first qubit in ``qubits`` is the most
    significant bit of the gate matrix's index.  ``params`` is a (possibly
    empty) numpy array or tensor -- rotation angles, or the packed matrix
    of a generic unitary.

    ``eq=False``: a structural __eq__/__hash__ would call bool()/hash() on
    the parameter arrays; identity semantics are the usable contract.
    """

    name: str
    qubits: Tuple[int, ...]
    params: tuple = ()

    def __post_init__(self):
        object.__setattr__(self, "qubits", tuple(int(q) for q in self.qubits))


class Circuit:
    """A mutable gate-list builder over ``num_qubits`` qubits."""

    def __init__(self, num_qubits: int):
        if num_qubits < 1:
            raise ValueError("Circuit needs at least one qubit")
        self.num_qubits = int(num_qubits)
        self.gates: list[Gate] = []

    # -- elementary gates -------------------------------------------------
    def _check(self, *qubits):
        for q in qubits:
            if not 0 <= q < self.num_qubits:
                raise ValueError(f"Qubit {q} out of range [0, {self.num_qubits})")
        if len(set(qubits)) != len(qubits):
            raise ValueError(f"Duplicate qubits in {qubits}")

    def h(self, t: int):
        self._check(t)
        self.gates.append(Gate("h", (t,)))
        return self

    def x(self, t: int):
        self._check(t)
        self.gates.append(Gate("x", (t,)))
        return self

    def z(self, t: int):
        self._check(t)
        self.gates.append(Gate("z", (t,)))
        return self

    @staticmethod
    def _angle(theta):
        """A tensor angle passes through (the differentiable-circuit path);
        anything else becomes a float."""
        if isinstance(theta, torch.Tensor):
            return theta
        return float(theta)

    def ry(self, theta: float, t: int):
        self._check(t)
        self.gates.append(Gate("ry", (t,), (self._angle(theta),)))
        return self

    def rz(self, theta: float, t: int):
        self._check(t)
        self.gates.append(Gate("rz", (t,), (self._angle(theta),)))
        return self

    def cx(self, control: int, target: int):
        self._check(control, target)
        self.gates.append(Gate("cx", (control, target)))
        return self

    def cz(self, control: int, target: int):
        self._check(control, target)
        self.gates.append(Gate("cz", (control, target)))
        return self

    def cry(self, theta: float, control: int, target: int):
        self._check(control, target)
        self.gates.append(Gate("cry", (control, target), (self._angle(theta),)))
        return self

    def swap(self, a: int, b: int):
        self._check(a, b)
        self.gates.append(Gate("swap", (a, b)))
        return self

    # -- fused / structured gates ----------------------------------------
    def ucry(self, thetas, controls: Tuple[int, ...], target: int):
        """Uniformly-controlled Ry (multiplexed rotation).

        Rotates ``target`` by ``thetas[c]`` where ``c`` is the basis value
        of ``controls`` (controls[0] = most significant): the fused form of
        FABLE's gray-code Ry/CNOT ladder.  A tensor ``thetas`` may be
        [2^k] (shared by every state of a batch) or [B, 2^k] (one row per
        state).
        """
        self._check(target, *controls)
        thetas = _as_param_array(thetas)
        if thetas.shape[-1] != 2 ** len(controls):
            raise ValueError(
                f"ucry needs 2**{len(controls)} angles, got {thetas.shape[-1]}"
            )
        self.gates.append(Gate("ucry", (target, *controls), thetas))
        return self

    def diagonal(self, phases, qubits: Tuple[int, ...]):
        """Diagonal gate over ``qubits``: multiplies amplitude of pattern c
        by ``phases[c]`` (qubits[0] = most significant)."""
        self._check(*qubits)
        phases = _as_param_array(phases)
        if phases.shape[-1] != 2 ** len(qubits):
            raise ValueError("diagonal needs 2**k entries")
        self.gates.append(Gate("diag", tuple(qubits), phases))
        return self

    def unitary(self, matrix, qubits: Tuple[int, ...]):
        """Generic k-qubit unitary (row-major 2^k x 2^k matrix)."""
        self._check(*qubits)
        if not hasattr(matrix, "shape"):
            matrix = np.asarray(matrix)
        dim = 2 ** len(qubits)
        if tuple(matrix.shape) != (dim, dim):
            raise ValueError(f"unitary matrix must be {dim}x{dim}")
        self.gates.append(Gate("unitary", tuple(qubits), matrix))
        return self

    # -- metadata ---------------------------------------------------------
    def __len__(self):
        return len(self.gates)

    @property
    def gate_count(self) -> int:
        return len(self.gates)

    def depth(self) -> int:
        """Circuit depth: longest chain of gates sharing qubits."""
        level = [0] * self.num_qubits
        for g in self.gates:
            d = 1 + max(level[q] for q in g.qubits)
            for q in g.qubits:
                level[q] = d
        return max(level) if self.gates else 0

    def __repr__(self):
        return (
            f"Circuit(num_qubits={self.num_qubits}, gates={len(self.gates)}, "
            f"depth={self.depth()})"
        )


# Static 2x2 / 4x4 gate matrices (numpy, cast to the simulation dtype on use)
_SQ2 = 1.0 / np.sqrt(2.0)
GATE_MATRICES = {
    "h": np.array([[_SQ2, _SQ2], [_SQ2, -_SQ2]]),
    "x": np.array([[0.0, 1.0], [1.0, 0.0]]),
    "z": np.array([[1.0, 0.0], [0.0, -1.0]]),
}


def ry_matrix(theta):
    """Ry(theta); a tensor angle builds the matrix with torch (and keeps
    its grad), anything else with numpy."""
    if isinstance(theta, torch.Tensor):
        c, s = torch.cos(theta / 2.0), torch.sin(theta / 2.0)
        return torch.stack([torch.stack([c, -s]), torch.stack([s, c])])
    c, s = np.cos(theta / 2.0), np.sin(theta / 2.0)
    return np.array([[c, -s], [s, c]])


def rz_matrix(theta):
    """Rz(theta) = diag(e^{-i theta/2}, e^{i theta/2}); complex."""
    if isinstance(theta, torch.Tensor):
        return torch.diag(
            torch.stack([torch.exp(-0.5j * theta), torch.exp(0.5j * theta)])
        )
    return np.diag([np.exp(-0.5j * theta), np.exp(0.5j * theta)])


def controlled(u2: np.ndarray) -> np.ndarray:
    """4x4 controlled version of a 2x2 gate; first qubit (MSB) is control."""
    m = np.eye(4, dtype=np.result_type(u2.dtype, np.float64))
    m[2:, 2:] = u2
    return m


SWAP_MATRIX = np.array(
    [
        [1, 0, 0, 0],
        [0, 0, 1, 0],
        [0, 1, 0, 0],
        [0, 0, 0, 1],
    ],
    dtype=np.float64,
)
