"""Dense statevector / unitary simulation of gate-IR circuits, on torch.

Counterpart of ``qkan_implementation_tpu.sim.statevector``.  Amplitudes
live in a flat ``[2**q]`` tensor, or a batch of them ``[..., 2**q]`` (the
JAX package's ``vmap`` over states becomes leading axes here); every gate
is a small tensor contraction or one elementwise pass over a view of rank
at most 2k+1.  The unitary is the simulation of the identity's columns as
one batch.

Real circuits (H/X/Ry/CNOT/SWAP/UCRY -- everything FABLE emits) simulate
in a real dtype, halving the bytes; complex circuits promote.  The
precision follows torch's default dtype, as the JAX package's follows its
x64 flag: float64 (complex128) when ``torch.get_default_dtype()`` is
float64, else float32 (complex64).

Where the state lives: on ``psi0``'s device, else on the device of the
circuit's tensor parameters, else on ``device`` -- ``"cuda"`` unless the
caller asks for the CPU.  The dense gate contractions run as torch
matmuls, which must not drop to TF32: on a CUDA float32/complex64 state
they raise while ``torch.backends.cuda.matmul.allow_tf32`` is on.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from qkan_implementation_tpu_torch.sim.circuit import (
    Circuit,
    Gate,
    GATE_MATRICES,
    SWAP_MATRIX,
    controlled,
    ry_matrix,
    rz_matrix,
)

_REAL_GATES = {"h", "x", "z", "ry", "cx", "cz", "cry", "swap", "ucry"}
BACKENDS = ("auto", "xla", "pallas")


def _x64() -> bool:
    return torch.get_default_dtype() == torch.float64


def circuit_is_real(circuit: Circuit) -> bool:
    """True if every gate has a real matrix (so real-dtype simulation is exact)."""
    for g in circuit.gates:
        if g.name in _REAL_GATES:
            continue
        if g.name in ("diag", "unitary"):
            if isinstance(g.params, torch.Tensor):
                if g.params.is_complex():
                    return False
            elif not np.isrealobj(np.asarray(g.params)):
                return False
            continue
        return False
    return True


def default_dtype(circuit: Circuit) -> torch.dtype:
    if circuit_is_real(circuit):
        return torch.float64 if _x64() else torch.float32
    return torch.complex128 if _x64() else torch.complex64


def zero_state(num_qubits: int, dtype=None, device="cuda") -> torch.Tensor:
    """|0...0> as a flat [2**num_qubits] tensor on ``device``."""
    dtype = dtype or torch.get_default_dtype()
    psi = torch.zeros(2**num_qubits, dtype=dtype, device=device)
    psi[0] = 1.0
    return psi


def check_exact_matmul(t: torch.Tensor) -> None:
    """The gate contractions promise exact float32 products: refuse a CUDA
    float32/complex64 tensor while TF32 matmuls are on."""
    if (t.is_cuda and t.dtype in (torch.float32, torch.complex64)
            and torch.backends.cuda.matmul.allow_tf32):
        raise RuntimeError(
            "statevector gate contractions need TF32 off: set "
            "torch.backends.cuda.matmul.allow_tf32 = False"
        )


def _as_tensor(values, like: torch.Tensor) -> torch.Tensor:
    """Gate data (numpy or tensor) as a tensor on ``like``'s device; the
    dtype is kept, so the caller casts where the JAX code casts."""
    if isinstance(values, torch.Tensor):
        return values.to(like.device)
    return torch.as_tensor(np.asarray(values), device=like.device)


def _gate_matrix(gate: Gate):
    """Dense matrix of any non-fused gate (numpy, or a tensor for tensor
    parameters)."""
    if gate.name in GATE_MATRICES:
        return GATE_MATRICES[gate.name]
    if gate.name == "ry":
        return ry_matrix(gate.params[0])
    if gate.name == "rz":
        return rz_matrix(gate.params[0])
    if gate.name == "cx":
        return controlled(GATE_MATRICES["x"])
    if gate.name == "cz":
        return controlled(GATE_MATRICES["z"])
    if gate.name == "cry":
        return controlled(ry_matrix(gate.params[0]))
    if gate.name == "swap":
        return SWAP_MATRIX
    if gate.name == "unitary":
        dim = 2 ** len(gate.qubits)
        return gate.params.reshape(dim, dim)
    raise ValueError(f"Unknown gate {gate.name}")


def _grouped_view(num_qubits: int, qubits):
    """Shape for viewing a flat [2^q] state with one explicit axis per gate
    qubit and merged segments in between: at most 2k+1 dims.

    Returns (shape, axis_of_qubit dict).  Qubits must be sorted descending.
    """
    shape = []
    axes = {}
    prev = num_qubits
    for t in qubits:
        seg = 2 ** (prev - t - 1)
        if seg > 1:
            shape.append(seg)
        axes[t] = len(shape)
        shape.append(2)
        prev = t
    if prev > 0:
        shape.append(2**prev)
    return shape, axes


def _apply_dense(psi, matrix, qubits, num_qubits):
    """Apply a k-qubit dense gate to the state ``psi`` [..., 2^q].

    ``qubits[0]`` is the most significant bit of the gate index.  The
    state is viewed with one axis per gate qubit (plus merged segments and
    one leading batch axis), the gate contracts those axes, and the axes
    move back in place.
    """
    check_exact_matmul(psi)
    k = len(qubits)
    order = sorted(qubits, reverse=True)
    shape, axes = _grouped_view(num_qubits, order)
    psi_v = psi.reshape(-1, *shape)
    contract_axes = [axes[t] + 1 for t in qubits]
    m = _as_tensor(matrix, psi).to(psi.dtype).reshape((2,) * (2 * k))
    out = torch.tensordot(m, psi_v, dims=(list(range(k, 2 * k)), contract_axes))
    # tensordot puts the gate's output axes first, in qubits order
    out = torch.movedim(out, list(range(k)), contract_axes)
    return out.reshape(psi.shape)


def _pattern_index(qubits, size, skip_bit: int | None = None):
    """Parameter index per flat position: read the ``qubits`` bits of each
    index in [0, size) (qubits[0] = MSB of the parameter index).

    ``skip_bit``: the flat index enumerates a state with that qubit removed
    (bit positions above it shift down by one).
    """
    r = np.arange(size, dtype=np.int64)
    c_index = np.zeros_like(r)
    k = len(qubits)
    for i, t in enumerate(qubits):
        pos = t if skip_bit is None or t < skip_bit else t - 1
        bit = (r >> pos) & 1
        c_index = c_index | (bit << (k - 1 - i))
    return c_index


def _apply_ucry(psi, thetas, target, controls, num_qubits):
    """Fused uniformly-controlled Ry: one elementwise update over the
    [..., outer, 2, inner] view.  ``thetas`` [M] or [..., M]."""
    shape = psi.shape
    inner = 2**target
    v = psi.reshape(-1, 2 ** num_qubits // (2 * inner), 2, inner)
    p0 = v[:, :, 0, :].reshape(v.shape[0], -1)
    p1 = v[:, :, 1, :].reshape(v.shape[0], -1)

    half_size = p0.shape[-1]
    c_index = _pattern_index(controls, half_size, skip_bit=target)
    th = _as_tensor(thetas, psi)
    th = th.reshape(-1, th.shape[-1]) if th.dim() > 1 else th
    if th.shape[-1] == half_size and np.array_equal(
        c_index, np.arange(half_size)
    ):
        # FABLE's layout (controls = all rest qubits, MSB first) needs no
        # gather: the angle order is the amplitude order
        half = th / 2.0
    else:
        half = th[..., torch.as_tensor(c_index, device=psi.device)] / 2.0
    c = torch.cos(half).to(psi.dtype)
    s = torch.sin(half).to(psi.dtype)
    new0 = (c * p0 - s * p1).reshape(v.shape[0], -1, inner)
    new1 = (s * p0 + c * p1).reshape(v.shape[0], -1, inner)
    return torch.stack([new0, new1], dim=2).reshape(shape)


def _apply_diag(psi, phases, qubits, num_qubits):
    """Fused diagonal gate: elementwise multiply via one parameter gather."""
    shape = psi.shape
    flat = psi.reshape(-1, shape[-1])
    ph = _as_tensor(phases, psi)
    ph = ph.reshape(-1, ph.shape[-1]) if ph.dim() > 1 else ph
    if ph.shape[-1] != flat.shape[-1] or tuple(qubits) != tuple(
        range(num_qubits - 1, -1, -1)
    ):
        idx = _pattern_index(qubits, flat.shape[-1])
        ph = ph[..., torch.as_tensor(idx, device=psi.device)]
    return (flat * ph.to(flat.dtype)).reshape(shape)


def apply_gate(psi: torch.Tensor, gate: Gate, num_qubits: int) -> torch.Tensor:
    """Apply one gate to a state [..., 2**q]."""
    if gate.name == "ucry":
        target, controls = gate.qubits[0], gate.qubits[1:]
        return _apply_ucry(psi, gate.params, target, controls, num_qubits)
    if gate.name == "diag":
        return _apply_diag(psi, gate.params, gate.qubits, num_qubits)
    return _apply_dense(psi, _gate_matrix(gate), gate.qubits, num_qubits)


def _pallas_eligible(gate: Gate, num_qubits: int, dtype) -> bool:
    """Route to the streaming ucry kernels: a ucry on a real state with the
    target on the MSB and the full descending control run (FABLE's
    layout).  The TPU's tile-size condition has no counterpart: the
    kernels take any power-of-two size."""
    if gate.name != "ucry" or dtype.is_complex:
        return False
    if gate.qubits[0] != num_qubits - 1:
        return False
    return tuple(gate.qubits[1:]) == tuple(range(num_qubits - 2, -1, -1))


# Unroll-vs-loop threshold for Ry/CNOT ladders (elementary FABLE emits
# 2*4^n of them): runs >= this length execute as one LadderSegment under
# backend='auto', as in the JAX package.
AUTO_LADDER_MIN = 128


def _circuit_device(circuit: Circuit, device):
    """The device of the circuit's tensor parameters, else ``device``."""
    for g in circuit.gates:
        params = g.params if isinstance(g.params, tuple) else (g.params,)
        for p in params:
            if isinstance(p, torch.Tensor):
                return p.device
    return device


def simulate(
    circuit: Circuit,
    psi0: torch.Tensor | None = None,
    dtype=None,
    backend: str = "auto",
    device="cuda",
) -> torch.Tensor:
    """Run ``circuit`` on ``psi0`` [..., 2^q] (default |0...0>); returns
    the final state.

    ``backend``: 'auto' fuses ladder runs (``sim.ladder``) and register
    walls (``sim.fusion``) and sends every eligible ucry to the streaming
    kernels -- K6 (``ucry_msb_cs_pallas_pair``) for static numpy angles,
    with cos/sin taken on the host in float64 and cast, and K8
    (``ucry_msb_pallas``) for tensor angles, whose trig runs in the
    state's dtype.  On a CUDA state those are the kernels; on a CPU state
    their plain versions.  'pallas' means the same as 'auto' (the TPU
    package's 'pallas' only added interpret mode off the TPU).  'xla' is
    the unfused per-gate oracle.

    ``device`` places |0...0> when there is no ``psi0`` and no tensor
    parameter to follow.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}: one of {BACKENDS}")
    if psi0 is not None and not isinstance(psi0, torch.Tensor):
        psi0 = torch.as_tensor(np.asarray(psi0),
                               device=_circuit_device(circuit, device))
    if dtype is None:
        dtype = default_dtype(circuit)
        # the inferred dtype covers the CIRCUIT; a complex initial state
        # must promote it or the cast drops the imaginary part
        if psi0 is not None and psi0.is_complex() and not dtype.is_complex:
            dtype = torch.complex128 if _x64() else torch.complex64
    q = circuit.num_qubits
    if psi0 is None:
        psi = zero_state(q, dtype, _circuit_device(circuit, device))
    else:
        if psi0.shape[-1] != 2**q:
            raise ValueError(
                f"psi0 has {psi0.shape[-1]} amplitudes, the circuit {2**q}"
            )
        psi = psi0.to(dtype)

    items = circuit.gates
    if backend != "xla":
        from qkan_implementation_tpu_torch.sim.fusion import fuse_register_ops
        from qkan_implementation_tpu_torch.sim.ladder import fuse_ladders

        items = fuse_register_ops(fuse_ladders(circuit, min_len=AUTO_LADDER_MIN), q)
    for gate in items:
        if not isinstance(gate, Gate):  # a fused pseudo-op
            from qkan_implementation_tpu_torch.sim.fusion import (
                BitPermutation,
                HRegister,
                apply_bit_permutation,
                apply_h_register,
            )
            from qkan_implementation_tpu_torch.sim.ladder import apply_ladder

            if isinstance(gate, HRegister):
                psi = apply_h_register(psi, gate, q)
            elif isinstance(gate, BitPermutation):
                psi = apply_bit_permutation(psi, gate, q)
            else:  # a LadderSegment
                psi = apply_ladder(psi, gate, q)
        elif backend != "xla" and _pallas_eligible(gate, q, dtype):
            from qkan_implementation_tpu_torch.sim import pallas_kernels as pk

            if isinstance(gate.params, np.ndarray):
                # static angles (every host-built FABLE circuit): the trig
                # once on the host in float64, then the trig-free kernel
                half = np.asarray(gate.params).reshape(-1) / 2.0
                psi = pk.ucry_msb_cs_pallas_pair(
                    psi,
                    torch.as_tensor(np.cos(half), dtype=psi.dtype,
                                    device=psi.device),
                    torch.as_tensor(np.sin(half), dtype=psi.dtype,
                                    device=psi.device),
                )
            else:
                psi = pk.ucry_msb_pallas(psi, gate.params)
        else:
            psi = apply_gate(psi, gate, q)
    return psi


def unitary(circuit: Circuit, dtype=None, device="cuda") -> torch.Tensor:
    """Dense unitary of ``circuit``: the identity's columns simulated as one
    batch.  U[:, j] = circuit |j>."""
    dtype = dtype or default_dtype(circuit)
    dim = 2**circuit.num_qubits
    eye = torch.eye(dim, dtype=dtype, device=_circuit_device(circuit, device))
    cols = simulate(circuit, eye, dtype)
    return cols.T  # row i of cols is U|i>, i.e. column i of U


def compile_simulator(circuit: Circuit, dtype=None):
    """Return a ``psi0 -> psi_final`` function for repeated use (torch runs
    eagerly: a closure over the circuit and dtype)."""
    dtype = dtype or default_dtype(circuit)
    return partial(simulate, circuit, dtype=dtype)
