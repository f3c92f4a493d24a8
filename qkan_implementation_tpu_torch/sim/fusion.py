"""Register-level gate fusion for the dense statevector engine, on torch.

Counterpart of ``qkan_implementation_tpu.sim.fusion``.  FABLE circuits
(``encoding.fable``) are layered: an H wall on the row register (n gates),
the fused ucry, a register swap (n swap gates), and a second H wall.
Executed gate by gate that is 3n+1 full-state passes; fused it is three:
one Walsh-Hadamard contraction per H wall (a matmul over a 2^k register
axis) and one permutation of the amplitude index for the swap run.

Pseudo-ops produced by ``fuse_register_ops``:

- ``HRegister(qubits)``: H on every listed qubit, applied per contiguous
  qubit segment as a [outer, 2^k, inner] x [2^k, 2^k] contraction.
- ``BitPermutation(perm)``: amplitude index remap new_bit[i] = old_bit
  perm[i], as a reshape + permute (few blocks) or one gather.

States may carry leading batch axes ([..., 2^q]).  The contractions are
exact float32 products: on a CUDA float32/complex64 state they raise while
TF32 matmuls are on.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from qkan_implementation_tpu_torch.sim.circuit import Gate
from qkan_implementation_tpu_torch.sim.statevector import check_exact_matmul


@dataclass(frozen=True)
class HRegister:
    qubits: Tuple[int, ...]  # sorted ascending, distinct


@dataclass(frozen=True)
class BitPermutation:
    # perm[new_position] = old_position (bit sources per destination bit)
    perm: Tuple[int, ...]


def _compose_swap(perm: list, a: int, b: int) -> None:
    perm[a], perm[b] = perm[b], perm[a]


def fuse_register_ops(gates, num_qubits: int, min_h: int = 2, min_swaps: int = 2):
    """Rewrite maximal H-walls and swap-runs into register pseudo-ops.

    Runs shorter than the thresholds stay as plain gates (a lone H is
    cheaper unfused).
    """
    items = []
    i = 0
    n = len(gates)
    while i < n:
        g = gates[i]
        if isinstance(g, Gate) and g.name == "h":
            qs = []
            j = i
            while (
                j < n
                and isinstance(gates[j], Gate)
                and gates[j].name == "h"
                and gates[j].qubits[0] not in qs
            ):
                qs.append(gates[j].qubits[0])
                j += 1
            if len(qs) >= min_h:
                items.append(HRegister(tuple(sorted(qs))))
                i = j
                continue
        if isinstance(g, Gate) and g.name == "swap":
            perm = list(range(num_qubits))
            j = i
            while j < n and isinstance(gates[j], Gate) and gates[j].name == "swap":
                _compose_swap(perm, gates[j].qubits[0], gates[j].qubits[1])
                j += 1
            if j - i >= min_swaps:
                items.append(BitPermutation(tuple(perm)))
                i = j
                continue
        items.append(g)
        i += 1
    return items


def _contiguous_segments(qubits: Tuple[int, ...]):
    segs = []
    start = prev = qubits[0]
    for q in qubits[1:]:
        if q == prev + 1:
            prev = q
            continue
        segs.append((start, prev))
        start = prev = q
    segs.append((start, prev))
    return segs


@lru_cache(maxsize=None)
def _hadamard_matrix(k: int) -> np.ndarray:
    """H^{(x)k}, built once per k (at most 2^10 x 2^10, 8 MB; the JAX
    package builds it once per compile) and read-only."""
    h = np.array([[1.0, 1.0], [1.0, -1.0]]) / np.sqrt(2.0)
    m = np.array([[1.0]])
    for _ in range(k):
        m = np.kron(m, h)
    m.flags.writeable = False
    return m


@lru_cache(maxsize=None)
def _hadamard_tensor(k: int, dtype: torch.dtype,
                     device: torch.device) -> torch.Tensor:
    """``_hadamard_matrix(k)`` on ``device``, uploaded once per
    (k, dtype, device) rather than once per wall."""
    return torch.tensor(_hadamard_matrix(k), dtype=dtype, device=device)


def apply_h_register(psi: torch.Tensor, op: HRegister, num_qubits: int) -> torch.Tensor:
    """One contraction per contiguous qubit segment (capped at 2^10 blocks:
    larger registers split so the transform matrix stays small)."""
    check_exact_matmul(psi)
    shape = psi.shape
    for lo, hi in _contiguous_segments(op.qubits):
        while lo <= hi:
            k = min(hi - lo + 1, 10)
            inner = 2**lo
            block = 2**k
            outer = psi.numel() // (inner * block)
            v = psi.reshape(outer, block, inner)
            m = _hadamard_tensor(k, psi.dtype, psi.device)
            psi = torch.einsum("ab,obi->oai", m, v).reshape(-1)
            lo += k
    return psi.reshape(shape)


def _permutation_blocks(perm: Tuple[int, ...]):
    """Contiguous runs of the bit map: [(old_start, new_start, length)]."""
    blocks = []
    i = 0
    q = len(perm)
    while i < q:
        start = perm[i]
        length = 1
        while i + length < q and perm[i + length] == start + length:
            length += 1
        blocks.append((start, i, length))
        i += length
    return blocks


def apply_bit_permutation(
    psi: torch.Tensor, op: BitPermutation, num_qubits: int
) -> torch.Tensor:
    """Amplitude remap out[idx] bit i = psi[...] bit op.perm[i].

    Few-block permutations (register swaps: 3 blocks) are a low-rank
    reshape + permute; many-block permutations one gather with its index
    computed on the state's device."""
    blocks = _permutation_blocks(op.perm)
    flat = psi.reshape(-1, psi.shape[-1])
    if len(blocks) <= 10:
        # view axes major->minor = source blocks by descending old_start
        src_order = sorted(blocks, key=lambda b: -b[0])
        shape = [2 ** b[2] for b in src_order]
        axis_of_block = {b: i + 1 for i, b in enumerate(src_order)}
        # output axes major->minor = blocks by descending new_start
        dst_order = sorted(blocks, key=lambda b: -b[1])
        axes = [0] + [axis_of_block[b] for b in dst_order]
        return flat.reshape(-1, *shape).permute(axes).reshape(psi.shape)
    idx = torch.arange(flat.shape[-1], dtype=torch.int64, device=psi.device)
    moved = [(n, o) for n, o in enumerate(op.perm) if n != o]
    src = idx
    for new_pos, old_pos in moved:
        src = src & ~(1 << old_pos)  # clear the destination bit
    for new_pos, old_pos in moved:
        src = src | (((idx >> new_pos) & 1) << old_pos)
    return flat[:, src].reshape(psi.shape)


def simulate_fable_runtime(
    cos_half: torch.Tensor,
    sin_half: torch.Tensor,
    n: int,
    psi0: torch.Tensor | None = None,
) -> torch.Tensor:
    """Fused FABLE block-encoding simulation with runtime rotation params.

    The fused circuit is exactly: H wall on the row register, one MSB
    multiplexed Ry, the register-swap permutation, H wall again -- so it
    executes here directly from (cos_half, sin_half) tensors produced by
    ``encoding.fable_runtime_params``, one structure for any matrix of the
    size.  A real state takes the rotation kernel K6
    (``ucry_msb_cs_pallas_pair``: the kernel on the card, its plain version
    on the CPU); a complex one the plain elementwise update.  The state is
    |0...0> in cos_half's dtype and device unless ``psi0`` [..., 2^(2n+1)]
    is given.  Differentiable w.r.t. cos_half/sin_half and psi0.  (The TPU
    function's ``interpret`` argument is gone: the device decides.)
    """
    q = 2 * n + 1
    m = cos_half.shape[-1]
    if m != 4**n:
        raise ValueError(f"expected 4^{n} parameters, got {m}")
    if psi0 is None:
        from qkan_implementation_tpu_torch.sim.statevector import zero_state

        psi = zero_state(q, cos_half.dtype, cos_half.device)
    else:
        psi = psi0
    hreg = HRegister(tuple(range(n, 2 * n)))
    perm = BitPermutation(
        tuple(list(range(n, 2 * n)) + list(range(n)) + [2 * n])
    )

    psi = apply_h_register(psi, hreg, q)
    if not psi.is_complex():
        from qkan_implementation_tpu_torch.sim.pallas_kernels import (
            ucry_msb_cs_pallas_pair,
        )

        psi = ucry_msb_cs_pallas_pair(
            psi, cos_half.to(psi.dtype), sin_half.to(psi.dtype)
        )
    else:
        v = psi.reshape(*psi.shape[:-1], 2, m)
        c = cos_half.to(psi.dtype)
        s = sin_half.to(psi.dtype)
        psi = torch.cat([c * v[..., 0, :] - s * v[..., 1, :],
                         s * v[..., 0, :] + c * v[..., 1, :]], dim=-1)
    psi = apply_bit_permutation(psi, perm, q)
    return apply_h_register(psi, hreg, q)
