"""Quantum-verified QKAN forward: the layer computed *through* the simulator.

Counterpart of ``qkan_implementation_tpu.ops.quantum``.  The FABLE
rotation angles are tensors, the statevector engine consumes them, and
gradients flow through ``arccos`` -> gate application -> amplitude
extraction.  Where the JAX package ``vmap``s a simulation over samples or
basis columns, the port simulates one batched state [..., 2^q]: a batch of
diagonals gives per-state angle rows, and the rotation of the whole batch
is one launch of the ucry kernel (K8) on the card.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from qkan_implementation_tpu_torch.ops.qkan_layer import lcu_combine_diag, sum_step
from qkan_implementation_tpu_torch.sim.circuit import Circuit
from qkan_implementation_tpu_torch.sim.statevector import default_dtype, simulate


def _next_pow2_exp(n: int) -> int:
    return max(1, int(np.ceil(np.log2(max(n, 1)))))


def fable_diag_traced(diag: torch.Tensor):
    """FABLE block encoding of a diagonal matrix with tensor angles.

    ``diag``: [..., 2^n] tensor (may require grad).  Returns (circuit,
    alpha) where the circuit's ucry parameters are tensors ([..., 4^n],
    one row per diagonal), so the whole simulation is differentiable
    w.r.t. ``diag``; alpha is a tensor of the leading shape.
    """
    flat, alpha = _diag_angles(diag)
    n = int(np.log2(diag.shape[-1]))
    circ = _build_diag_circuit(n, flat)
    return circ, alpha


def _diag_angles(diag: torch.Tensor):
    """FABLE-diagonal rotation angles: (flat [..., size^2] thetas, alpha
    [...]).  The differentiable half of ``fable_diag_traced``."""
    size = diag.shape[-1]
    n = int(np.log2(size))
    if 2**n != size:
        raise ValueError("diag length must be a power of two")

    # Dtype-aware subnormalization margin: it must survive rounding in the
    # working precision, or max|diag| >= 1 makes scaled hit exactly +/-1
    # and d(arccos)/dx = -inf poisons every gradient with NaN (in f32,
    # 1 + 1e-8 rounds to exactly 1.0).  32*eps keeps arccos' slope finite.
    margin = 32.0 * float(torch.finfo(diag.dtype).eps)

    def const(v):
        return torch.tensor(v, dtype=diag.dtype, device=diag.device)

    # maximum/minimum (not clamp): at a tie they split the gradient evenly,
    # as jnp.maximum and jnp.clip do
    alpha = torch.maximum(
        const(1.0), torch.amax(torch.abs(diag), dim=-1) * (1.0 + margin)
    )
    scaled = diag / alpha[..., None]

    # Row-major flat index of diagonal entries: i*size + i; off-diagonal
    # entries are zero -> theta = pi (constant).
    flat = torch.full((*diag.shape[:-1], size * size), math.pi,
                      dtype=scaled.dtype, device=diag.device)
    idx = torch.arange(size, device=diag.device) * (size + 1)
    clip_lim = 1.0 - margin
    clipped = torch.minimum(torch.maximum(scaled, const(-clip_lim)),
                            const(clip_lim))
    thetas = 2.0 * torch.arccos(clipped)
    flat = flat.scatter(-1, idx.expand(thetas.shape), thetas)
    return flat, alpha


def _build_diag_circuit(n: int, ucry_params) -> Circuit:
    """The FABLE-diagonal circuit structure for a 2^n diagonal."""
    circ = Circuit(2 * n + 1)
    anc = 2 * n
    for qubit in range(n, 2 * n):
        circ.h(qubit)
    circ.ucry(ucry_params, tuple(range(2 * n - 1, -1, -1)), anc)
    for j in range(n):
        circ.swap(j, n + j)
    for qubit in range(n, 2 * n):
        circ.h(qubit)
    return circ


@lru_cache(maxsize=16)
def _diag_circuit_template(n: int):
    """Structure-only FABLE-diagonal circuit (placeholder ucry angles),
    cached per size with its ucry gate index: the sharded extraction runs
    it with the angles as ``runtime_params``."""
    size = 2**n
    circ = _build_diag_circuit(
        n, np.full((size * size,), np.pi, dtype=np.float32)
    )
    (ucry_idx,) = [i for i, g in enumerate(circ.gates) if g.name == "ucry"]
    return circ, ucry_idx


def quantum_extract_diag(diag: torch.Tensor) -> torch.Tensor:
    """Round-trip a diagonal through its block encoding on the simulator.

    Returns the diagonal as recovered from circuit amplitudes:
    out[j] = <j| U |j> * alpha * 2^n, one simulation per basis column (the
    columns ride as one batch).  Differentiable w.r.t. ``diag`` [..., 2^n].
    """
    size = diag.shape[-1]
    n = int(np.log2(size))
    flat, alpha = _diag_angles(diag)
    lead = diag.shape[:-1]
    if lead:
        # every column of a diagonal shares that diagonal's angles
        flat = flat.unsqueeze(-2).expand(*lead, size, flat.shape[-1])
    circ = _build_diag_circuit(n, flat)
    dim = 2 ** (2 * n + 1)
    basis = torch.eye(size, dim, dtype=diag.dtype, device=diag.device)
    columns = simulate(circ, psi0=basis.expand(*lead, size, dim),
                       dtype=diag.dtype)  # [..., size, dim]
    j = torch.arange(size, device=diag.device)
    amps = columns[..., j, j]
    return amps * alpha[..., None] * size


def quantum_extract_diag_packed(diag: torch.Tensor) -> torch.Tensor:
    """Diagonal extraction from ONE simulation over a packed identity block.

    For a diagonal encoded matrix the off-diagonal elements of the block
    are exactly zero, so the uniform superposition over the 2^n column
    states recovers every diagonal entry at once:

        U |0_anc, 0_row> (1/sqrt(size)) sum_c |c>
          -> amp[j] = diag[j] / (alpha * size * sqrt(size))   at |0, 0, j>

    One 2^(2n+1)-amplitude simulation per diagonal instead of 2^n.
    Differentiable w.r.t. ``diag`` [..., 2^n].
    """
    size = diag.shape[-1]
    n = int(np.log2(size))
    circ, alpha = fable_diag_traced(diag)
    dim = 2 ** (2 * n + 1)
    psi0 = torch.zeros((*diag.shape[:-1], dim), dtype=diag.dtype,
                       device=diag.device)
    psi0[..., :size] = 1.0 / np.sqrt(size)
    psi = simulate(circ, psi0=psi0, dtype=diag.dtype)
    return psi[..., :size] * (alpha[..., None] * size * np.sqrt(size))


def quantum_extract_diag_packed_sharded(
    diag: torch.Tensor, mesh, exchange_impl: str = "collective"
) -> torch.Tensor:
    """Packed diagonal extraction on the mesh-sharded statevector engine.

    The math of ``quantum_extract_diag_packed``, with the 2^(2n+1)
    amplitude simulation split over the slots of ``mesh``'s first axis
    (``sim.sharded``), so an encoding larger than one device's memory
    still runs.  The packed initial state is built slot by slot: the full
    state never exists on one device.  The angles ride in as
    ``runtime_params``, keeping the path differentiable w.r.t. ``diag``
    [2^n].  ``exchange_impl='rdma'`` sends the global-target ucry and H
    gates through K11 (``sim.rdma``).
    """
    from qkan_implementation_tpu_torch.sim.sharded import sharded_simulate

    size = diag.shape[-1]
    n = int(np.log2(size))
    flat, alpha = _diag_angles(diag)
    circ, ucry_idx = _diag_circuit_template(n)
    psi = sharded_simulate(
        circ, mesh, psi0=packed_initial_shards(size, mesh, diag.dtype),
        dtype=diag.dtype, exchange_impl=exchange_impl,
        runtime_params={ucry_idx: flat},
    )
    return psi[:size] * (alpha * size * np.sqrt(size))


def packed_initial_shards(size: int, mesh, dtype) -> list:
    """The packed initial state of a 2^n diagonal's extraction (1/sqrt(size)
    on the first ``size`` amplitudes of 2^(2n+1)), built slot by slot over
    ``mesh``'s first axis."""
    n = int(np.log2(size))
    slots = mesh.axis_devices(mesh.axis_names[0])
    block = 2 ** (2 * n + 1) // len(slots)
    shards = []
    for d, dev in enumerate(slots):
        shard = torch.zeros(block, dtype=dtype, device=dev)
        shard[:min(max(size - d * block, 0), block)] = 1.0 / np.sqrt(size)
        shards.append(shard)
    return shards


def _pad_pow2(v: torch.Tensor) -> torch.Tensor:
    """Zero-pad the last axis up to the next power-of-two length (identity
    when already a power of two)."""
    size = v.shape[-1]
    padded_size = 2 ** _next_pow2_exp(size)
    if padded_size == size:
        return v
    return torch.nn.functional.pad(v, (0, padded_size - size))


def qkan_layer_forward_quantum_sharded(
    x: torch.Tensor, weights: torch.Tensor, N: int, K: int, mesh,
    exchange_impl: str = "collective",
) -> torch.Tensor:
    """Quantum-mode layer forward (``x`` [N] -> [K]) with the block
    encoding sharded over ``mesh`` (``quantum_extract_diag_packed_sharded``).
    Differentiable end to end.  ``exchange_impl='rdma'`` runs the
    circuit's global-qubit exchanges through K11."""
    lcu = _pad_pow2(lcu_combine_diag(x, weights, K))
    size = N * K
    recovered = quantum_extract_diag_packed_sharded(
        lcu, mesh, exchange_impl=exchange_impl
    )[:size]
    return sum_step(recovered, N, K)


def qkan_layer_forward_quantum(
    x: torch.Tensor, weights: torch.Tensor, N: int, K: int, packed: bool = True
) -> torch.Tensor:
    """QKAN layer forward computed through the block-encoding simulator.

    Equivalent to ``qkan_layer_forward`` but the LCU diagonal physically
    round-trips through its FABLE circuit before the SUM step.
    Differentiable end-to-end.  ``x`` [..., N].

    ``packed=True`` (default) extracts the diagonal from one packed
    simulation (``quantum_extract_diag_packed``); ``False`` runs the
    strict per-basis-column extraction (2^n simulations).
    """
    lcu = _pad_pow2(lcu_combine_diag(x, weights, K))
    size = N * K
    extract = quantum_extract_diag_packed if packed else quantum_extract_diag
    recovered = extract(lcu)[..., :size]
    return sum_step(recovered, N, K)


def qkan_layer_forward_quantum_batched(
    x: torch.Tensor, weights: torch.Tensor, N: int, K: int
) -> torch.Tensor:
    """Batched quantum-mode forward: [B, N] -> [B, K].

    Each sample's LCU diagonal rides its own packed block-encoding
    simulation, all of them as one batched state: one rotation launch for
    the batch, with per-sample angle rows."""
    return qkan_layer_forward_quantum(x, weights, N, K, packed=True)


def quantum_extract_block_columns(
    a: np.ndarray, num_rows: int | None = None, chunk: int = 64,
    return_encoding: bool = False, device="cuda",
):
    """Recover a FABLE-encoded matrix from its circuit, column by column.

    Simulates U|e_c> for exactly the columns of ``a`` (``chunk`` columns a
    batch, on ``device``) and reads the top block -- O(cols * 2^(2m+1))
    work instead of the full ``unitary()``.  The precision is
    ``default_dtype`` of the circuit.  Returns the recovered matrix with
    ``a``'s shape (or ``num_rows`` rows); with ``return_encoding=True``
    returns ``(recovered, circuit, alpha)``.
    """
    from qkan_implementation_tpu_torch.encoding.fable import fable

    a = np.asarray(a)
    rows = num_rows if num_rows is not None else a.shape[0]
    cols = a.shape[1]
    circuit, alpha = fable(a)
    dim = 2**circuit.num_qubits
    block = 2 ** ((circuit.num_qubits - 1) // 2)
    dtype = default_dtype(circuit)

    # float output regardless of a's dtype: the recovered amplitudes are
    # real-valued, and an integer buffer would truncate them
    out = np.empty((rows, cols), dtype=np.promote_types(a.dtype, np.float32))
    for start in range(0, cols, chunk):
        end = min(start + chunk, cols)
        basis = torch.zeros((end - start, dim), dtype=dtype, device=device)
        basis[torch.arange(end - start), torch.arange(start, end)] = 1.0
        amps = simulate(circuit, psi0=basis)[:, :block].cpu().numpy()
        out[:, start:end] = (amps[:, :rows].T * alpha * block).real
    if return_encoding:
        return out, circuit, alpha
    return out


def quantum_verify_pipeline(
    x: torch.Tensor, weights: torch.Tensor, N: int, K: int
) -> dict:
    """Per-stage block-encoding round-trip errors (the library counterpart
    of the reference's step-test verification, MulStep.py:115-166).

    Returns relative errors for each pipeline stage; all should sit at
    simulation precision.
    """
    from qkan_implementation_tpu_torch.ops.chebyshev import dilated_chebyshev_diag
    from qkan_implementation_tpu_torch.ops.qkan_layer import weighted_chebyshev_diag

    max_degree = weights.shape[0] - 1
    errors = {}

    def diag_error(diag):
        size = diag.shape[-1]
        rec = quantum_extract_diag(_pad_pow2(diag))[:size]
        denom = torch.linalg.norm(diag)
        return torch.where(
            denom > 1e-30, torch.linalg.norm(rec - diag) / denom,
            torch.linalg.norm(rec)
        )

    for d in range(max_degree + 1):
        cheb = dilated_chebyshev_diag(x, K, d)
        errors[f"cheb_deg{d}"] = float(diag_error(cheb))
        errors[f"mul_deg{d}"] = float(
            diag_error(weighted_chebyshev_diag(x, weights[d], K, d))
        )
    lcu = lcu_combine_diag(x, weights, K)
    errors["lcu"] = float(diag_error(lcu))
    summed = sum_step(lcu, N, K)
    errors["sum"] = float(diag_error(_pad_pow2(summed)))
    return errors
