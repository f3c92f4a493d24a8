"""ctypes bindings to the C++ native runtime (``native/qkan_native.cpp``).

Counterpart of ``qkan_implementation_tpu.native_bindings``: the C++
simulated annealer, brute-force minimiser and energy evaluator, the
host-side oracles of the port's annealer on the card (the role neal's C++
sampler plays for the reference); and the circuit helpers over the port's
gate IR (``sim.Circuit``): the gate-graph optimizer
(``optimize_circuit``), circuit depth (``circuit_depth_native``) and the
dense CPU statevector engine (``sv_encode_circuit`` /
``statevector_native``), the host oracle of ``sim.simulate``.  The shared
library is built from the repository's ``native/qkan_native.cpp`` with g++
at first use, into the port's git-ignored ``_build/`` (never into
``native/``); the same source and flags as the JAX package's build, so
both bindings return the same bits.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent.parent / "native" / "qkan_native.cpp"
_BUILD_DIR = Path(__file__).resolve().parent / "_build"
_LIB_PATH = _BUILD_DIR / "libqkan_native.so"
_CXXFLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]
_lib = None
_lock = threading.Lock()


class NativeUnavailable(RuntimeError):
    pass


def _build() -> None:
    if not _SRC.exists():
        raise NativeUnavailable(f"source not found: {_SRC}")
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build beside the target and rename, so a concurrent loader never
    # opens a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        try:
            proc = subprocess.run(
                ["g++", *_CXXFLAGS, "-o", tmp, str(_SRC)],
                capture_output=True, text=True,
            )
        except FileNotFoundError as e:
            raise NativeUnavailable(f"g++ not found: {e}") from e
        if proc.returncode != 0:
            raise NativeUnavailable(f"g++ failed:\n{proc.stderr}")
        os.replace(tmp, _LIB_PATH)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_native():
    """Load (building if needed) the native library; raises
    NativeUnavailable when no toolchain is present."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not _LIB_PATH.exists():
            _build()
        lib = ctypes.CDLL(str(_LIB_PATH))
        dp = ctypes.POINTER(ctypes.c_double)
        lib.qkan_anneal.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, dp, dp,
            ctypes.c_double, ctypes.c_double, ctypes.c_uint64, dp, dp,
        ]
        lib.qkan_anneal.restype = None
        lib.qkan_brute_force.argtypes = [ctypes.c_int, dp, dp, dp]
        lib.qkan_brute_force.restype = ctypes.c_double
        lib.qkan_energies.argtypes = [
            ctypes.c_int, ctypes.c_int, dp, dp, dp, dp,
        ]
        lib.qkan_energies.restype = None
        ip = ctypes.POINTER(ctypes.c_int)
        up = ctypes.POINTER(ctypes.c_uint8)
        lp = ctypes.POINTER(ctypes.c_longlong)
        lib.qkan_optimize_circuit.argtypes = [
            ctypes.c_int, ip, ip, ip, dp, ctypes.c_double, up,
        ]
        lib.qkan_optimize_circuit.restype = ctypes.c_int
        lib.qkan_circuit_depth.argtypes = [
            ctypes.c_int, ip, ip, up, ctypes.c_int,
        ]
        lib.qkan_circuit_depth.restype = ctypes.c_int
        lib.qkan_sv_run.argtypes = [
            ctypes.c_int, ctypes.c_int, ip, lp, ip, lp, dp, dp, dp, dp,
        ]
        lib.qkan_sv_run.restype = ctypes.c_int
        _lib = lib
        return lib


def native_available() -> bool:
    try:
        load_native()
        return True
    except NativeUnavailable:
        return False


def _as_c(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _model_arrays(model):
    return (np.ascontiguousarray(model.h, dtype=np.float64),
            np.ascontiguousarray(model.J, dtype=np.float64))


def anneal_native(
    model,
    num_reads: int = 1000,
    num_sweeps: int = 1000,
    beta_range: tuple[float, float] | None = None,
    seed: int = 0,
):
    """C++ simulated annealing; same signature/semantics as
    ``anneal.sa.simulated_annealing`` (energies include the model offset)."""
    from qkan_implementation_tpu_torch.anneal.sa import default_beta_range

    lib = load_native()
    if beta_range is None:
        beta_range = default_beta_range(model)
    if beta_range[0] <= 0 or beta_range[1] <= 0:
        # the C++ schedule would compute 0 * inf = NaN betas and silently
        # return quench samples
        raise ValueError(f"beta_range must be positive, got {beta_range}")
    n = model.num_variables
    h, J = _model_arrays(model)
    samples = np.zeros((num_reads, n), dtype=np.float64)
    energies = np.zeros(num_reads, dtype=np.float64)
    lib.qkan_anneal(
        n, num_reads, num_sweeps, _as_c(h), _as_c(J),
        float(beta_range[0]), float(beta_range[1]), int(seed) & (2**64 - 1),
        _as_c(samples), _as_c(energies),
    )
    return samples, energies + model.offset


def brute_force_native(model):
    """Exact minimum via the C++ enumerator (n <= 30)."""
    lib = load_native()
    n = model.num_variables
    if n > 30:
        raise ValueError("brute force limited to 30 variables")
    h, J = _model_arrays(model)
    sample = np.zeros(n, dtype=np.float64)
    e = lib.qkan_brute_force(n, _as_c(h), _as_c(J), _as_c(sample))
    return sample, float(e) + model.offset


def energies_native(model, samples: np.ndarray) -> np.ndarray:
    """E(s) of each row of ``samples`` by the C++ evaluator, offset
    included."""
    lib = load_native()
    samples = np.ascontiguousarray(np.atleast_2d(samples), dtype=np.float64)
    h, J = _model_arrays(model)
    out = np.zeros(samples.shape[0], dtype=np.float64)
    lib.qkan_energies(
        model.num_variables, samples.shape[0], _as_c(h), _as_c(J),
        _as_c(samples), _as_c(out),
    )
    return out + model.offset


_OPCODES = {"h": 0, "x": 1, "z": 2, "ry": 3, "rz": 4, "cx": 5, "cz": 6, "swap": 7}
_INT_P = ctypes.POINTER(ctypes.c_int)
_U8_P = ctypes.POINTER(ctypes.c_uint8)
_LL_P = ctypes.POINTER(ctypes.c_longlong)


def _host_params(params) -> np.ndarray:
    """A gate's parameters (a tuple of floats or tensors, an array or a
    tensor) as one flat numpy array, tensors read to the host."""
    if isinstance(params, (tuple, list)):
        if not params:
            return np.zeros(0)
        return np.concatenate([_host_params(p) for p in params])
    if hasattr(params, "detach"):
        params = params.detach().cpu().numpy()
    return np.asarray(params).reshape(-1)


def _qubit_slots(gates):
    """The two qubit slots a gate of the native ABI carries (-1: none)."""
    q0 = np.zeros(len(gates), dtype=np.int32)
    q1 = np.full(len(gates), -1, dtype=np.int32)
    for i, g in enumerate(gates):
        q0[i] = g.qubits[0]
        if len(g.qubits) > 1:
            q1[i] = g.qubits[1]
    return q0, q1


def optimize_circuit(circuit, eps: float = 1e-12):
    """Run the C++ gate-graph optimizer over a circuit.

    Peephole passes with commutation-aware lookback: cancels self-inverse
    pairs (H-H, CX-CX, SWAP-SWAP, ...) and merges consecutive Ry/Rz on the
    same qubit, treating structured gates (ucry/diag/unitary) as opaque
    barriers.  Returns a new, equivalent ``Circuit``.
    """
    from qkan_implementation_tpu_torch.sim.circuit import Circuit, Gate

    lib = load_native()
    gates = circuit.gates
    n = len(gates)
    ops = np.array([_OPCODES.get(g.name, 8) for g in gates], dtype=np.int32)
    q0, q1 = _qubit_slots(gates)
    params = np.zeros(n, dtype=np.float64)
    for i, g in enumerate(gates):
        if g.name in ("ry", "rz"):
            params[i] = float(_host_params(g.params)[0])
    keep = np.zeros(n, dtype=np.uint8)
    lib.qkan_optimize_circuit(
        n, ops.ctypes.data_as(_INT_P), q0.ctypes.data_as(_INT_P),
        q1.ctypes.data_as(_INT_P), _as_c(params), float(eps),
        keep.ctypes.data_as(_U8_P),
    )
    out = Circuit(circuit.num_qubits)
    for i, g in enumerate(gates):
        if not keep[i]:
            continue
        if g.name in ("ry", "rz"):
            out.gates.append(Gate(g.name, g.qubits, (float(params[i]),)))
        else:
            out.gates.append(g)
    return out


def circuit_depth_native(circuit) -> int:
    """Circuit depth via the C++ level-propagation pass.

    The native ABI carries two qubit slots per gate, so any gate acting on
    3+ qubits (ucry/diag over a register) cannot be represented -- those
    circuits fall back to the Python ``Circuit.depth()`` (same definition)
    rather than silently undercounting.
    """
    if any(len(g.qubits) > 2 for g in circuit.gates):
        return circuit.depth()
    lib = load_native()
    n = len(circuit.gates)
    q0, q1 = _qubit_slots(circuit.gates)
    keep = np.ones(n, dtype=np.uint8)
    return int(lib.qkan_circuit_depth(
        n, q0.ctypes.data_as(_INT_P), q1.ctypes.data_as(_INT_P),
        keep.ctypes.data_as(_U8_P), circuit.num_qubits,
    ))


_SV_OPCODES = {
    "h": 0, "x": 1, "z": 2, "ry": 3, "rz": 4, "cx": 5, "cz": 6,
    "swap": 7, "cry": 8, "ucry": 9, "diag": 10,
}


def sv_encode_circuit(circuit):
    """Flatten a gate-IR circuit into the C statevector-engine stream.

    Returns (ops, qoff, qubits, poff, params_re, params_im) numpy arrays
    (``params_im`` None when every parameter is real); raises ValueError
    on a gate the engine does not support (``unitary``).  Encode once, run
    many times -- the encoding is reusable across ``statevector_native``
    calls.
    """
    ops, qoff, qubits_flat, poff = [], [0], [], [0]
    pr, pim = [], []
    complex_params = False
    for g in circuit.gates:
        if g.name not in _SV_OPCODES:
            raise ValueError(f"native engine does not support gate {g.name!r}")
        ops.append(_SV_OPCODES[g.name])
        qubits_flat.extend(g.qubits)
        qoff.append(len(qubits_flat))
        p = _host_params(g.params).astype(np.complex128)
        complex_params = complex_params or bool(np.any(p.imag != 0.0))
        pr.extend(p.real.tolist())
        pim.extend(p.imag.tolist())
        poff.append(len(pr))
    return (
        np.asarray(ops, dtype=np.int32),
        np.asarray(qoff, dtype=np.int64),
        np.asarray(qubits_flat, dtype=np.int32),
        np.asarray(poff, dtype=np.int64),
        np.asarray(pr, dtype=np.float64),
        np.asarray(pim, dtype=np.float64) if complex_params else None,
    )


def statevector_native(circuit, psi0=None, encoded=None) -> np.ndarray:
    """Run a circuit on the C++ dense statevector engine (Aer-class CPU
    baseline; see native/qkan_native.cpp).  Returns the final state as
    complex128 numpy [2^q].

    Same amplitude layout and gate set as ``sim.simulate``, one strided C
    loop per gate.  ``psi0``: the initial state (numpy or a tensor,
    default |0...0>).  ``encoded``: pass a ``sv_encode_circuit`` result
    to skip re-encoding on repeated runs.
    """
    lib = load_native()
    ops, qoff, qubits, poff, pr, pim = (
        encoded if encoded is not None else sv_encode_circuit(circuit)
    )
    dim = 2 ** circuit.num_qubits
    if psi0 is None:
        re = np.zeros(dim, dtype=np.float64)
        im = np.zeros(dim, dtype=np.float64)
        re[0] = 1.0
    else:
        psi0 = _host_params(psi0).astype(np.complex128).reshape(dim)
        re = np.ascontiguousarray(psi0.real)
        im = np.ascontiguousarray(psi0.imag)
    rc = lib.qkan_sv_run(
        circuit.num_qubits, len(ops), ops.ctypes.data_as(_INT_P),
        qoff.ctypes.data_as(_LL_P), qubits.ctypes.data_as(_INT_P),
        poff.ctypes.data_as(_LL_P), _as_c(pr),
        _as_c(pim) if pim is not None else None, _as_c(re), _as_c(im),
    )
    if rc != 0:
        raise RuntimeError(f"qkan_sv_run failed with code {rc}")
    return re + 1j * im
