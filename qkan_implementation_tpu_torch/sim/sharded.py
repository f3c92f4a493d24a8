"""Mesh-sharded statevector simulation, single-controller.

Counterpart of ``qkan_implementation_tpu.sim.sharded``.  Amplitudes are
laid out flat [2^q] and split contiguously over the slots of one mesh
axis (``parallel.mesh``), so with 2^k slots the top k qubits are "global"
(their bits select the slot) and the rest are local:

- gates on local qubits run on each slot's block;
- *diagonal* structure needs no communication even on global qubits: a
  ``diag`` gate and the control register of a ``ucry`` only *select* --
  the slot index bits pick the parameter slice;
- non-diagonal action on a global qubit uses the qubit-index-remapping
  exchange: a hypercube pairwise exchange swaps the global bit with a
  local one, the gate applies locally, and a layout tracker leaves the
  qubit there until ``restore``.

The JAX engine traces one program per device inside ``shard_map``; here
one controller walks the circuit once and applies each step to the list
of every slot's block, so a device bit is a Python int per slot.  With
``exchange_impl='rdma'`` a ucry or H whose target is still global runs as
K11 (``sim.rdma``); a local ucry at the local MSB runs as K6 (host
angles) or K8 (tensor angles).  The JAX package's executor cache and
``_circuit_fingerprint`` exist to skip a recompile; the port runs
eagerly and has neither.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from qkan_implementation_tpu_torch.parallel.collectives import (
    pairwise_exchange,
    pairwise_exchange_a2a,
)
from qkan_implementation_tpu_torch.sim import rdma
from qkan_implementation_tpu_torch.sim.circuit import Circuit, Gate
from qkan_implementation_tpu_torch.sim.fusion import (
    BitPermutation,
    HRegister,
    apply_bit_permutation,
    apply_h_register,
)
from qkan_implementation_tpu_torch.sim.statevector import (
    _apply_dense,
    _apply_diag,
    _apply_ucry,
    _gate_matrix,
    _x64,
    default_dtype,
)

EXCHANGE_IMPLS = ("collective", "rdma", "all_to_all")
BACKENDS = ("auto", "pallas", "xla")


class ShardedState:
    """A flat [2^q] state held as one contiguous block per mesh slot
    (``shards[i]`` on slot i's device).  ``full()`` concatenates it onto
    one device; ``state[:n]`` reads a prefix that lies in slot 0 without
    gathering.  ``exchange_count`` is the number of exchanges the run
    issued (fused ones included)."""

    def __init__(self, shards, mesh=None, exchange_count: int = 0):
        self.shards = list(shards)
        self.mesh = mesh
        self.exchange_count = exchange_count

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    def full(self) -> torch.Tensor:
        """The whole state on slot 0's device."""
        device = self.shards[0].device
        return torch.cat([s.to(device) for s in self.shards])

    def __getitem__(self, key):
        block = self.shards[0].shape[0]
        if (isinstance(key, slice) and key.start in (None, 0)
                and key.step in (None, 1) and key.stop is not None
                and 0 <= key.stop <= block):
            return self.shards[0][:key.stop]
        raise IndexError(
            f"ShardedState reads only a prefix [:n] with n <= {block} (slot "
            "0); gather with .full() for anything else"
        )


def _exchange_global_local(blocks, dev_bit: int, local_pos: int,
                           chunks: int = 1, pairwise_fn=pairwise_exchange):
    """Swap global qubit bit ``dev_bit`` (of the slot index) with local
    qubit ``local_pos``: one pairwise exchange of half a block.

    Amplitude (G=a, l=b) moves to (G=b, l=a); each slot keeps the diagonal
    half and trades the off-diagonal half with its hypercube neighbour,
    over the flat block's [outer, 2, inner] view.  ``chunks > 1`` splits
    the traded half into that many exchanges (one when it does not
    divide), as the JAX package's overlapped-exchange prototype does.
    """
    inner = 2**local_pos
    views = [b.reshape(-1, 2, inner) for b in blocks]
    bits = [(d >> dev_bit) & 1 for d in range(len(blocks))]
    sends = [v[:, 1, :] if g == 0 else v[:, 0, :] for v, g in zip(views, bits)]
    total = sends[0].numel()
    if chunks > 1 and total % chunks != 0:
        warnings.warn(
            f"exchange_chunks={chunks} does not divide the half-block "
            f"({total} elements); falling back to one unchunked exchange",
            stacklevel=2,
        )
    if chunks > 1 and total % chunks == 0:
        flats = [s.reshape(-1).chunk(chunks) for s in sends]
        parts = [pairwise_fn([f[i] for f in flats], dev_bit)
                 for i in range(chunks)]
        recvs = [torch.cat([p[d] for p in parts]).reshape(s.shape)
                 for d, s in enumerate(sends)]
    else:
        recvs = pairwise_fn(sends, dev_bit)
    out = []
    for v, g, recv in zip(views, bits, recvs):
        new0, new1 = (v[:, 0, :], recv) if g == 0 else (recv, v[:, 1, :])
        out.append(torch.stack([new0, new1], dim=1).reshape(-1))
    return out


def _select_global_control_angles(params, controls, q_local: int, slot: int):
    """Collapse the global-control axes of a ucry/diag parameter vector
    by indexing them with ``slot``'s bits.  Returns (local_params,
    local_controls).

    One flat selection: the slot bits give a base offset, a static table
    enumerates the local-control bit patterns (a plain slice when the
    local controls are the low bits of the parameter index, in order).
    ``params`` is numpy or a tensor; the result is of the same kind."""
    k = len(controls)
    th = params.reshape(-1)
    local_controls = tuple(c for c in controls if c < q_local)
    kk = len(local_controls)
    if kk == k:
        return th, local_controls
    base = 0
    shifts = []  # axis position from the right of each LOCAL control
    for axis, c in enumerate(controls):
        if c >= q_local:
            base |= ((slot >> (c - q_local)) & 1) << (k - 1 - axis)
        else:
            shifts.append(k - 1 - axis)
    if shifts == list(range(kk - 1, -1, -1)):
        return th[base:base + 2**kk], local_controls
    # the table is built where the parameters live: a tensor's on its
    # device, so nothing large crosses from the host
    if isinstance(th, torch.Tensor):
        j = torch.arange(2**kk, dtype=torch.int64, device=th.device)
    else:
        j = np.arange(2**kk, dtype=np.int64)
    # bit kk-1-i of j (local control i, MSB first) goes to bit shifts[i]
    return th[_move_bits(j, range(kk - 1, -1, -1), shifts) + base], \
        local_controls


def _move_bits(j, src, dst):
    """sum_i bit src[i] of ``j`` << dst[i], over runs of consecutive
    positions (src and dst both falling by one) at three ops a run, not
    three a bit: the tables of a 2^23-entry selection are a few passes."""
    src, dst = list(src), list(dst)
    out = j * 0
    start = 0
    for i in range(1, len(src) + 1):
        if (i == len(src) or src[i] != src[i - 1] - 1
                or dst[i] != dst[i - 1] - 1):
            mask = (1 << (i - start)) - 1
            out = out | (((j >> src[i - 1]) & mask) << dst[i - 1])
            start = i
    return out


class _QubitLayout:
    """Logical -> physical qubit placement with lazy exchanges.

    An exchange moves a logical qubit into the local region and leaves it
    there, so a run of gates on the same (originally global) qubits pays
    one exchange, not two per gate.  ``restore`` returns to the canonical
    layout: global homes via exchanges, then one local gather for the
    residual local permutation.  ``dry_run`` walks the schedule without
    touching amplitudes (``count_exchanges``).
    """

    def __init__(self, q: int, q_local: int, n_dev: int,
                 exchange_chunks: int = 1, pairwise_fn=pairwise_exchange,
                 dry_run: bool = False):
        self.q = q
        self.q_local = q_local
        self.n_dev = n_dev
        self.exchange_chunks = exchange_chunks
        self.pairwise_fn = pairwise_fn
        self.dry_run = dry_run
        self.phys = list(range(q))  # phys[logical] = physical position
        self.occupant = list(range(q))  # occupant[physical] = logical qubit
        self.exchange_count = 0

    def note_swap(self, phys_a: int, phys_b: int, count: bool = False):
        """Record (bookkeeping only) that the occupants of two physical
        slots swapped: the collective exchange, the swap-gate relabel, the
        fused kernels (which move the data themselves) and the dry run."""
        a, b = self.occupant[phys_a], self.occupant[phys_b]
        self.occupant[phys_a], self.occupant[phys_b] = b, a
        self.phys[a], self.phys[b] = phys_b, phys_a
        if count:
            self.exchange_count += 1

    def exchange(self, blocks, phys_global: int, phys_local: int):
        if not self.dry_run:
            blocks = _exchange_global_local(
                blocks, phys_global - self.q_local, phys_local,
                chunks=self.exchange_chunks, pairwise_fn=self.pairwise_fn,
            )
        self.note_swap(phys_global, phys_local, count=True)
        return blocks

    def make_local(self, blocks, logical: int, pinned: set,
                   prefer: int | None = None):
        """Ensure ``logical`` lives in the local region.  ``prefer``: the
        victim slot when an exchange is needed (the local MSB, so a
        following ucry hits the MSB kernel)."""
        p = self.phys[logical]
        if p < self.q_local:
            return blocks
        if prefer is not None and prefer not in pinned:
            return self.exchange(blocks, p, prefer)
        for victim in range(self.q_local):
            if victim not in pinned:
                return self.exchange(blocks, p, victim)
        raise ValueError("gate needs more local qubits than available")

    def restore(self, blocks):
        """Return to the canonical layout (logical i at physical i)."""
        for g in range(self.q_local, self.q):
            while self.occupant[g] != g:
                target = self.phys[g]  # where logical g currently lives
                if target < self.q_local:
                    blocks = self.exchange(blocks, g, target)
                else:
                    blocks = self.exchange(blocks, target, 0)
        if any(self.occupant[p] != p for p in range(self.q_local)):
            if not self.dry_run:
                # dest bit p <- logical p, which lives at phys[p]: a bit
                # permutation, applied on each block's device
                op = BitPermutation(tuple(self.phys[:self.q_local]))
                blocks = [apply_bit_permutation(b, op, self.q_local)
                          for b in blocks]
            for p in range(self.q_local):
                self.phys[p] = p
                self.occupant[p] = p
        return blocks


def _host_cos_sin(params):
    """cos/sin of host (numpy) half-angles: the static-angle route of the
    fused and the local MSB ucry takes the trig once per gate on the host
    in float64; each slot then selects its slice."""
    half = np.asarray(params).reshape(-1) / 2.0
    return np.cos(half), np.sin(half)


def _broadcast_local_angles(local_controls: tuple, q_local: int):
    """A function expanding a ucry coefficient vector (indexed by
    ``local_controls`` in axis order) to the [2^(q_local-1)] half-block
    index space the MSB kernels take: the identity when the controls are
    already the full descending low-bit register, else one gather.  The
    gather's index (``statevector._pattern_index``'s) is built on each
    slot's device, once: from the host it would be 2^(q_local-1) int64
    a slot through a pageable copy."""
    if local_controls == tuple(range(q_local - 2, -1, -1)):
        return lambda v: v
    k = len(local_controls)
    gathers = {}  # device -> index, built there once for every slot

    def expand(v):
        if v.device not in gathers:
            r = torch.arange(2 ** (q_local - 1), device=v.device)
            # bit local_controls[i] of r is bit k-1-i of the angle index
            gathers[v.device] = _move_bits(r, local_controls,
                                           range(k - 1, -1, -1))
        return v.reshape(-1)[gathers[v.device]]

    return expand


def _slot_coeffs(source, phys_controls, q_local: int, block, slot: int,
                 expand):
    """(cos, sin) of a ucry's half angles for ``slot``, on the block's
    device and in its dtype, expanded to the half block.  ``source``: the
    host (cos, sin) of numpy angles (``_host_cos_sin``), or the angle
    tensor, whose trig runs on the slot's selection."""
    if isinstance(source, tuple):
        cs, sn = (torch.as_tensor(_select_global_control_angles(
            v, phys_controls, q_local, slot)[0], device=block.device)
            .to(block.dtype) for v in source)
    else:
        probe, _ = _select_global_control_angles(source, phys_controls,
                                                 q_local, slot)
        probe = probe.to(block.device)
        cs, sn = (f(probe / 2.0).to(block.dtype)
                  for f in (torch.cos, torch.sin))
    return expand(cs), expand(sn)


def _coeff_source(params):
    return (_host_cos_sin(params) if isinstance(params, np.ndarray)
            else params)


def _slot_thetas(params, phys_controls, q_local: int, block, slot: int):
    thetas, _ = _select_global_control_angles(params, phys_controls, q_local,
                                              slot)
    if isinstance(thetas, torch.Tensor):
        return thetas.to(block.device)
    return thetas


def _apply_sharded_gate(blocks, gate: Gate, layout: _QubitLayout,
                        q_local: int, use_pallas: bool = False,
                        use_rdma: bool = False):
    real = not blocks[0].is_complex()
    slots = range(len(blocks))
    if gate.name == "diag":
        phys_qubits = tuple(layout.phys[t] for t in gate.qubits)
        out = []
        for d in slots:
            phases, local_qubits = _select_global_control_angles(
                gate.params, phys_qubits, q_local, d)
            out.append(_apply_diag(blocks[d], phases, local_qubits, q_local))
        return out

    if gate.name == "ucry":
        t_phys = layout.phys[gate.qubits[0]]
        if (use_rdma and t_phys >= q_local and real
                and rdma.ucry_exchange_eligible(2**q_local)):
            # the exchange that would localize the target and the rotation
            # are one kernel: the data moves inside it, the layout records
            # the swap with the local MSB first
            layout.note_swap(t_phys, q_local - 1, count=True)
            phys_controls = tuple(layout.phys[c] for c in gate.qubits[1:])
            expand = _broadcast_local_angles(
                tuple(c for c in phys_controls if c < q_local), q_local)
            source = _coeff_source(gate.params)
            coeffs = [_slot_coeffs(source, phys_controls, q_local, blocks[d],
                                   d, expand) for d in slots]
            return rdma.ucry_exchange_fused_rdma(
                blocks, [c for c, _ in coeffs], [s for _, s in coeffs],
                t_phys - q_local)
        # only the target must be local; controls select angles from
        # wherever they live.  The local MSB is the preferred victim, so
        # FABLE's layout lands on the MSB kernels.
        blocks = layout.make_local(blocks, gate.qubits[0], pinned=set(),
                                   prefer=q_local - 1)
        phys_controls = tuple(layout.phys[c] for c in gate.qubits[1:])
        local_controls = tuple(c for c in phys_controls if c < q_local)
        target = layout.phys[gate.qubits[0]]
        if use_pallas and target == q_local - 1 and real:
            from qkan_implementation_tpu_torch.sim import pallas_kernels as pk

            # any local control structure rides the MSB kernels: the
            # gather broadcasts the selected angles over the half block
            expand = _broadcast_local_angles(local_controls, q_local)
            if isinstance(gate.params, np.ndarray):
                source = _coeff_source(gate.params)
                out = []
                for d in slots:
                    c, s = _slot_coeffs(source, phys_controls, q_local,
                                        blocks[d], d, expand)
                    out.append(pk.ucry_msb_cs_pallas_pair(blocks[d], c, s))
                return out
            return [pk.ucry_msb_pallas(blocks[d], expand(_slot_thetas(
                gate.params, phys_controls, q_local, blocks[d], d)))
                for d in slots]
        return [_apply_ucry(blocks[d], _slot_thetas(
            gate.params, phys_controls, q_local, blocks[d], d), target,
            local_controls, q_local) for d in slots]

    if gate.name == "swap":
        # pure relabelling: zero compute, zero communication; ``restore``
        # realizes whatever net permutation remains
        a, b = gate.qubits
        layout.note_swap(layout.phys[a], layout.phys[b])
        return blocks

    if (gate.name == "h" and use_rdma and real
            and layout.phys[gate.qubits[0]] >= q_local
            and rdma.ucry_exchange_eligible(2**q_local)):
        return _fuse_global_h(blocks, gate.qubits[0], layout, q_local)

    # dense gate: every acting qubit must be local; pin the ones already
    # local so a later exchange does not evict them
    pinned = {layout.phys[t] for t in gate.qubits if layout.phys[t] < q_local}
    for t in gate.qubits:
        blocks = layout.make_local(blocks, t, pinned)
        pinned.add(layout.phys[t])
    phys_qubits = tuple(layout.phys[t] for t in gate.qubits)
    matrix = _gate_matrix(gate)
    return [_apply_dense(b, matrix, phys_qubits, q_local) for b in blocks]


def _h_wall_run(gates, start: int, q_local: int):
    """Maximal run of H gates on distinct qubits starting at ``start``,
    capped at q_local - 1 qubits.  None if shorter than 2."""
    qs = []
    j = start
    while (j < len(gates) and gates[j].name == "h"
           and gates[j].qubits[0] not in qs and len(qs) < q_local - 1):
        qs.append(gates[j].qubits[0])
        j += 1
    return qs if len(qs) >= 2 else None


def _fuse_global_h(blocks, t: int, layout: _QubitLayout, q_local: int):
    """The fused exchange + H (K11) for logical qubit ``t``, which must be
    global; records the swap with the local MSB."""
    t_phys = layout.phys[t]
    layout.note_swap(t_phys, q_local - 1, count=True)
    return rdma.h_exchange_fused_rdma(blocks, t_phys - q_local)


def _apply_h_wall(blocks, logicals, layout: _QubitLayout, q_local: int,
                  use_rdma: bool = False):
    """Fused H wall: global wall qubits take the fused exchange + H when
    ``use_rdma``; the local ones get ONE Walsh-Hadamard register
    contraction (``sim.fusion.apply_h_register``)."""

    def h_register(bs, positions):
        op = HRegister(tuple(sorted(positions)))
        return [apply_h_register(b, op, q_local) for b in bs]

    pending = list(logicals)
    if (use_rdma and not blocks[0].is_complex()
            and rdma.ucry_exchange_eligible(2**q_local)):
        # local wall qubits first: each fused pass evicts the local-MSB
        # occupant to global, so it must already be done
        locals_ = [t for t in pending if layout.phys[t] < q_local]
        if locals_:
            blocks = h_register(blocks, [layout.phys[t] for t in locals_])
            pending = [t for t in pending if t not in locals_]
        while True:
            glb = [t for t in pending if layout.phys[t] >= q_local]
            if not glb:
                break
            blocks = _fuse_global_h(blocks, glb[0], layout, q_local)
            pending.remove(glb[0])
    if not pending:
        return blocks
    pinned = {layout.phys[t] for t in pending if layout.phys[t] < q_local}
    for t in pending:
        blocks = layout.make_local(blocks, t, pinned)
        pinned.add(layout.phys[t])
    return h_register(blocks, [layout.phys[t] for t in pending])


def shard_memory_report(state: ShardedState) -> dict:
    """Per-slot memory accounting of a sharded state, read off the live
    shard tensors' buffers (a shard that is a view of a larger buffer
    counts the whole buffer).

    Keys as in the JAX package: ``logical_bytes`` (the state's nominal
    size), ``total_bytes`` (the sum over slots), ``devices`` (mesh slots),
    ``max_bytes_per_device`` / ``min_bytes_per_device`` and ``balanced``
    (every slot holds exactly logical/slots); plus ``cards``, the number
    of distinct torch devices the slots sit on.
    """
    shards = state.shards
    logical = sum(s.numel() * s.element_size() for s in shards)
    per_slot = [s.untyped_storage().nbytes() for s in shards]
    mx, mn = max(per_slot), min(per_slot)
    return {
        "logical_bytes": int(logical),
        "total_bytes": int(sum(per_slot)),
        "devices": len(per_slot),
        "cards": len({s.device for s in shards}),
        "max_bytes_per_device": int(mx),
        "min_bytes_per_device": int(mn),
        "balanced": bool(mx == mn and mx * len(per_slot) == logical),
    }


def _mesh_bits(n_dev: int, q: int) -> int:
    k = n_dev.bit_length() - 1
    if n_dev < 1 or 2**k != n_dev:
        raise ValueError(f"Mesh axis size {n_dev} must be a power of two")
    if q <= k:
        raise ValueError(f"Need more qubits ({q}) than mesh bits ({k})")
    return k


def count_exchanges(circuit: Circuit, n_devices: int) -> int:
    """Number of qubit exchanges the layout schedule issues for this
    circuit on ``n_devices`` slots (a dry walk, no amplitudes)."""
    q = circuit.num_qubits
    q_local = q - _mesh_bits(n_devices, q)
    layout = _QubitLayout(q, q_local, n_devices, dry_run=True)
    blocks = None  # never touched in dry_run mode
    gates = circuit.gates
    i = 0
    while i < len(gates):
        run = _h_wall_run(gates, i, q_local)
        if run:
            pinned = {layout.phys[t] for t in run if layout.phys[t] < q_local}
            for t in run:
                blocks = layout.make_local(blocks, t, pinned)
                pinned.add(layout.phys[t])
            i += len(run)
            continue
        gate = gates[i]
        i += 1
        if gate.name == "diag":
            continue
        if gate.name == "swap":
            a, b = gate.qubits
            layout.note_swap(layout.phys[a], layout.phys[b])
            continue
        if gate.name == "ucry":
            blocks = layout.make_local(blocks, gate.qubits[0], pinned=set(),
                                       prefer=q_local - 1)
            continue
        pinned = {layout.phys[t] for t in gate.qubits
                  if layout.phys[t] < q_local}
        for t in gate.qubits:
            blocks = layout.make_local(blocks, t, pinned)
            pinned.add(layout.phys[t])
    layout.restore(blocks)
    return layout.exchange_count


def _initial_blocks(psi0, devices, q: int, dtype) -> list:
    """Each slot's block of the initial state: |0...0> by default, a full
    [2^q] tensor split over the slots, or a list of shards."""
    n = len(devices)
    block = 2**q // n
    if psi0 is None:
        out = [torch.zeros(block, dtype=dtype, device=dev) for dev in devices]
        out[0][0] = 1.0
        return out
    if isinstance(psi0, (list, tuple)):
        if len(psi0) != n or any(tuple(s.shape) != (block,) for s in psi0):
            raise ValueError(f"psi0 needs {n} shards of [{block}]")
        shards = psi0
    else:
        psi0 = torch.as_tensor(psi0)
        if tuple(psi0.shape) != (2**q,):
            raise ValueError(
                f"psi0 has shape {tuple(psi0.shape)}, the circuit {2**q}")
        shards = psi0.chunk(n)
    return [s.to(device=dev, dtype=dtype) for s, dev in zip(shards, devices)]


def sharded_simulate(circuit: Circuit, mesh, axis_name: str = "d",
                     psi0=None, dtype=None, backend: str = "auto",
                     exchange_chunks: int = 1,
                     exchange_impl: str = "collective",
                     runtime_params: dict | None = None) -> ShardedState:
    """Run a circuit on a state sharded over ``mesh``'s ``axis_name``
    slots; returns the final state as a ``ShardedState``.

    The axis size must be a power of two and smaller than 2^q.
    ``backend``: 'auto' and 'pallas' send a local ucry at the local MSB
    to K6 (numpy angles) or K8 (tensor angles) -- the kernels on a CUDA
    slot, their plain versions on a CPU slot; 'xla' keeps the plain
    elementwise update.  ``exchange_chunks`` splits each collective
    exchange into that many pieces.  ``exchange_impl``: 'rdma' runs a ucry
    or H whose target is global as K11 (``sim.rdma``); 'collective' keeps
    the exchange + gate steps on ``pairwise_exchange``; 'all_to_all' on
    ``pairwise_exchange_a2a``.  ``psi0``: a full [2^q] tensor (split over
    the slots) or a list of per-slot shards.

    ``runtime_params``: {gate_index: tensor} parameter overrides.
    Gradients flow through them: every slot reads the same leaf, so
    autograd adds the slots' cotangents (the JAX package's psum).
    """
    if axis_name not in mesh.axis_names:
        raise ValueError(
            f"axis {axis_name!r} not in mesh axes {mesh.axis_names}"
        )
    devices = mesh.axis_devices(axis_name)
    n_dev = len(devices)
    q = circuit.num_qubits
    q_local = q - _mesh_bits(n_dev, q)
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}: one of {BACKENDS}")
    if exchange_impl not in EXCHANGE_IMPLS:
        raise ValueError(f"unknown exchange_impl {exchange_impl!r}")
    if dtype is None:
        dtype = default_dtype(circuit)
        # a complex initial state promotes the circuit's real dtype, as in
        # statevector.simulate
        first = psi0[0] if isinstance(psi0, (list, tuple)) else psi0
        if (first is not None and torch.as_tensor(first).is_complex()
                and not dtype.is_complex):
            dtype = torch.complex128 if _x64() else torch.complex64
    use_pallas = backend != "xla"
    use_rdma = exchange_impl == "rdma"
    pairwise_fn = (pairwise_exchange_a2a if exchange_impl == "all_to_all"
                   else pairwise_exchange)

    blocks = _initial_blocks(psi0, devices, q, dtype)
    override = dict(runtime_params or {})
    layout = _QubitLayout(q, q_local, n_dev, exchange_chunks=exchange_chunks,
                          pairwise_fn=pairwise_fn)
    gates = circuit.gates
    i = 0
    while i < len(gates):
        run = _h_wall_run(gates, i, q_local)
        if run:
            blocks = _apply_h_wall(blocks, run, layout, q_local,
                                   use_rdma=use_rdma)
            i += len(run)
            continue
        gate = gates[i]
        if i in override:
            gate = Gate(gate.name, gate.qubits, override[i])
        blocks = _apply_sharded_gate(blocks, gate, layout, q_local,
                                     use_pallas=use_pallas, use_rdma=use_rdma)
        i += 1
    blocks = layout.restore(blocks)
    return ShardedState(blocks, mesh, layout.exchange_count)
