"""FABLE block encoding (arXiv:2205.00081) as gate-IR emission.

Counterpart of ``qkan_implementation_tpu.encoding.fable``, numpy only, with
the same semantics.  Contract: ``circ, alpha = fable(A)`` yields a
(2n+1)-qubit circuit whose top-left ``N x N`` block (N = 2^n) satisfies

    U[:N, :N] * alpha * N == A            (within simulation tolerance)

with the system register on the low n qubits.  Rotation angles are computed
via a scaled fast Walsh-Hadamard transform + Gray-code permutation; the
circuit is emitted either as the fused ``ucry`` gate (one elementwise pass
on the card) or as the elementary Ry/CNOT Gray-code ladder with FABLE's
rotation-dropping + CNOT parity-merging compression.
"""

from __future__ import annotations

import numpy as np

from qkan_implementation_tpu_torch.sim.circuit import Circuit


def gray_code(i: int) -> int:
    """Binary-reflected Gray code of i."""
    return i ^ (i >> 1)


def gray_permutation(a: np.ndarray) -> np.ndarray:
    """b[i] = a[gray_code(i)]."""
    idx = np.array([gray_code(i) for i in range(len(a))])
    return np.asarray(a)[idx]


def sfwht(a: np.ndarray) -> np.ndarray:
    """Scaled fast Walsh-Hadamard transform: (1/2^k) * H_{2^k} @ a.

    Iterative butterflies with a /2 per stage; O(n log n).
    """
    a = np.array(a, dtype=np.float64, copy=True)
    n = len(a)
    h = 1
    while h < n:
        for i in range(0, n, h * 2):
            for j in range(i, i + h):
                x, y = a[j], a[j + h]
                a[j] = (x + y) / 2.0
                a[j + h] = (x - y) / 2.0
        h *= 2
    return a


def fable_alpha(a: np.ndarray) -> float:
    """Subnormalization factor: max |a_ij| when > 1, else 1.

    Matches the reference contract where the extracted block is rescaled by
    ``alpha * N`` (reference ``ChebyshevStep.py:129-131``).
    """
    m = float(np.max(np.abs(a))) if a.size else 0.0
    if m > 1.0:
        return m * (1.0 + np.sqrt(np.finfo(np.float64).eps))
    return 1.0


def _pad_to_pow2(a: np.ndarray) -> np.ndarray:
    rows, cols = a.shape
    dim = max(rows, cols, 1)
    n = max(1, int(np.ceil(np.log2(dim))))
    size = 2**n
    if (rows, cols) == (size, size):
        return a
    out = np.zeros((size, size), dtype=a.dtype)
    out[:rows, :cols] = a
    return out


def _ucry_angles(a_flat: np.ndarray) -> np.ndarray:
    """Rotation angles for the compressed uniformly-controlled Ry.

    theta_c = 2*arccos(a_c) rotated into the Gray-code/Walsh-Hadamard basis:
    phi = gray_permutation(sfwht(theta)).
    """
    thetas = 2.0 * np.arccos(np.clip(a_flat, -1.0, 1.0))
    return gray_permutation(sfwht(thetas))


def _ctrl_bit(i: int, k: int) -> int:
    """Bit position (0 = LSB) where gray(i) and gray(i+1 mod 2^k) differ."""
    nxt = 0 if i + 1 == 2**k else i + 1
    diff = gray_code(i) ^ gray_code(nxt)
    return int(diff).bit_length() - 1


def fable_runtime_params(a: np.ndarray):
    """Host-side FABLE parameters for the runtime-argument executor
    (``sim.fusion.simulate_fable_runtime``): returns
    (cos_half [4^n], sin_half [4^n], alpha, n) for the padded matrix.

    The arrays ride into the executor as tensors, so one structure serves
    any matrix of the same size.
    """
    if np.iscomplexobj(a):
        # match fable(): silently casting would block-encode Re(a)
        raise ValueError("fable encodes real matrices")
    a = np.asarray(a, dtype=np.float64)
    if a.ndim != 2:
        raise ValueError("fable expects a 2-D matrix")
    a = _pad_to_pow2(a)
    n = int(np.log2(a.shape[0]))
    alpha = fable_alpha(a)
    half = np.arccos(np.clip(a.reshape(-1) / alpha, -1.0, 1.0))
    return np.cos(half), np.sin(half), alpha, n


def fable(
    a: np.ndarray,
    compression_threshold: float = 0.0,
    fused: bool = True,
):
    """Build the FABLE block-encoding circuit of a real matrix.

    Args:
        a: real matrix, padded up to the next 2^n x 2^n.
        compression_threshold: rotations with |angle| <= threshold are dropped
            and their CNOTs parity-merged (FABLE's approximate compression;
            0.0 keeps every rotation, matching the reference's ``fable(A, 0)``).
        fused: if True emit a single ``ucry`` gate (the fast path; exact
            same unitary); if False emit the elementary Ry/CNOT Gray-code
            ladder.

    Returns:
        (Circuit, alpha): qubits [0..n-1] = system (j, then i after the swap),
        [n..2n-1] = row register, [2n] = rotation ancilla.
    """
    if np.iscomplexobj(a):
        raise ValueError(
            "fable encodes real matrices (the reference contract); "
            "complex support would need Rz phases in the ladder"
        )
    a = np.asarray(a, dtype=np.float64)
    if a.ndim != 2:
        raise ValueError("fable expects a 2-D matrix")
    a = _pad_to_pow2(a)
    size = a.shape[0]
    n = int(np.log2(size))

    alpha = fable_alpha(a)
    scaled = a / alpha

    circ = Circuit(2 * n + 1)
    anc = 2 * n
    row_reg = list(range(n, 2 * n))

    for q in row_reg:
        circ.h(q)

    # Angle index c = (i << n) | j  ->  row-major flatten of the matrix.
    flat = scaled.reshape(-1)
    if fused:
        if compression_threshold > 0.0:
            # the fused gate carries every rotation; silently returning an
            # UNcompressed encoding to a caller who asked for the
            # reference's approximate compression would be a lie
            raise ValueError(
                "compression_threshold requires the elementary ladder: "
                "call fable(a, threshold, fused=False)"
            )
        # Fused multiplexed rotation with the *raw* angles theta_c.
        thetas = 2.0 * np.arccos(np.clip(flat, -1.0, 1.0))
        controls = tuple(range(2 * n - 1, -1, -1))  # MSB = qubit 2n-1
        circ.ucry(thetas, controls, anc)
    else:
        phis = _ucry_angles(flat)
        k = 2 * n
        # controls[k-1-b] corresponds to bit b of the pattern index; bit b of
        # c = (i<<n)|j is qubit b in the little-endian layout.
        parity = 0
        for i in range(2**k):
            bit = _ctrl_bit(i, k)
            if abs(phis[i]) > compression_threshold:
                # flush pending parity-merged CNOTs before the rotation
                for b in range(k):
                    if parity & (1 << b):
                        circ.cx(b, anc)
                parity = 0
                circ.ry(phis[i], anc)
            parity ^= 1 << bit
        for b in range(k):
            if parity & (1 << b):
                circ.cx(b, anc)

    for j in range(n):
        circ.swap(j, n + j)
    for q in row_reg:
        circ.h(q)

    return circ, alpha
