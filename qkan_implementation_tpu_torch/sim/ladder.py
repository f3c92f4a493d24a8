"""Fused execution of Ry/CNOT ladders (FABLE's elementary form), on torch.

Counterpart of ``qkan_implementation_tpu.sim.ladder``.  An elementary FABLE
circuit holds 2*4^n alternating Ry/CNOT gates on a single rotation target.
A maximal run of them becomes one ``LadderSegment`` of angle and control
arrays; ``apply_ladder`` walks its steps in a loop of torch ops (the JAX
package's ``lax.scan``, which it needs to keep compile time flat -- torch
runs eagerly, so a loop is the same program), each step an Ry on the
[..., outer, 2, inner] view and a CNOT as a select on the control bit.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from qkan_implementation_tpu_torch.sim.circuit import Circuit


@dataclass
class LadderSegment:
    """A run of Ry/CNOT gates sharing one target qubit, encoded as arrays.

    Step i applies Ry(thetas[i]) on ``target`` then, if ctrls[i] >= 0,
    CNOT(ctrls[i], target).
    """

    target: int
    thetas: np.ndarray  # [L]
    ctrls: np.ndarray  # [L], -1 = no CNOT this step


def _static_theta(gate) -> float | None:
    """The gate's angle as a float, or None if it is a tensor."""
    p = gate.params[0] if isinstance(gate.params, (tuple, list)) else gate.params
    if isinstance(p, torch.Tensor):
        return None
    try:
        return float(np.asarray(p).reshape(-1)[0])
    except (TypeError, ValueError):
        return None


def fuse_ladders(circuit: Circuit, min_len: int = 8):
    """Split the gate list into LadderSegments and passthrough gates.

    A ladder is a maximal run of ``ry(target)`` / ``cx(*, target)`` gates
    on a common target; runs shorter than ``min_len`` stay as plain gates.
    Gates with tensor angles break a run -- segments need static angle
    arrays.
    """
    items = []
    i = 0
    gates = circuit.gates
    while i < len(gates):
        g = gates[i]
        target = None
        if g.name == "ry" and _static_theta(g) is not None:
            target = g.qubits[0]
        elif g.name == "cx":
            target = g.qubits[1]
        if target is not None:
            j = i
            steps = []  # (theta, ctrl)
            pending_theta = None
            while j < len(gates):
                gj = gates[j]
                if gj.name == "ry" and gj.qubits[0] == target:
                    theta = _static_theta(gj)
                    if theta is None:
                        break
                    if pending_theta is not None:
                        steps.append((pending_theta, -1))
                    pending_theta = theta
                elif gj.name == "cx" and gj.qubits[1] == target:
                    steps.append(
                        (pending_theta if pending_theta is not None else 0.0,
                         gj.qubits[0])
                    )
                    pending_theta = None
                else:
                    break
                j += 1
            if pending_theta is not None:
                steps.append((pending_theta, -1))
            if len(steps) >= min_len:
                items.append(
                    LadderSegment(
                        target=target,
                        thetas=np.array([s[0] for s in steps]),
                        ctrls=np.array([s[1] for s in steps], dtype=np.int32),
                    )
                )
                i = j
                continue
        items.append(g)
        i += 1
    return items


def apply_ladder(psi: torch.Tensor, seg: LadderSegment, num_qubits: int) -> torch.Tensor:
    """The ladder's steps in order on psi [..., 2^q]."""
    shape = psi.shape
    inner = 2**seg.target
    dim = shape[-1]
    idx = torch.arange(dim, dtype=torch.int64, device=psi.device)
    # the angles in the state's dtype, cos/sin of theta/2 taken there
    thetas = torch.as_tensor(seg.thetas, dtype=psi.dtype, device=psi.device)
    cos, sin = torch.cos(thetas / 2.0), torch.sin(thetas / 2.0)
    for step, c in enumerate(seg.ctrls.tolist()):
        v = psi.reshape(-1, dim // (2 * inner), 2, inner)
        p0, p1 = v[:, :, 0, :], v[:, :, 1, :]
        co, si = cos[step], sin[step]
        v = torch.stack([co * p0 - si * p1, si * p0 + co * p1], dim=2)
        psi = v.reshape(shape)
        if c >= 0:
            # CNOT(c, target): flip the target bit where bit c is set
            flipped = v.flip(2).reshape(shape)
            psi = torch.where(((idx >> c) & 1) == 1, flipped, psi)
    return psi


def simulate_fused(
    circuit: Circuit,
    psi0: torch.Tensor | None = None,
    dtype=None,
    min_len: int = 8,
    device="cuda",
) -> torch.Tensor:
    """Like ``statevector.simulate(backend='xla')`` but with ladder runs
    fused (``device`` places |0...0> when there is no ``psi0``)."""
    from qkan_implementation_tpu_torch.sim.statevector import (
        _circuit_device,
        apply_gate,
        default_dtype,
        zero_state,
    )

    dtype = dtype or default_dtype(circuit)
    psi = (
        zero_state(circuit.num_qubits, dtype,
                   _circuit_device(circuit, device))
        if psi0 is None
        else psi0.to(dtype)
    )
    for item in fuse_ladders(circuit, min_len=min_len):
        if isinstance(item, LadderSegment):
            psi = apply_ladder(psi, item, circuit.num_qubits)
        else:
            psi = apply_gate(psi, item, circuit.num_qubits)
    return psi
