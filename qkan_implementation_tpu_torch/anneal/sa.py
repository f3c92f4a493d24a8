"""Batched simulated annealing and parallel tempering over QUBOs, on torch.

Counterpart of ``qkan_implementation_tpu.anneal.sa``: all chains run as
one batched state on ``device`` (the card unless the caller asks for the
CPU), local fields maintained incrementally, sequential-variable
Metropolis sweeps under a geometric temperature schedule.  The JAX
package's ``lax.scan`` / ``fori_loop`` become Python loops over torch ops
on the state's device, so a sweep costs a handful of kernel launches per
sequential step (one step per variable; one per within-block variable on
block-diagonal QUBOs).

Random numbers: one ``torch.Generator`` on the state's device, seeded
from ``seed``; the initial state is one draw, and each sweep draws all
its uniforms at once ([variables, reads]), consumed in variable order.
The streams differ from JAX's, so the port is held to energies, not
samples.  Acceptance ``u < exp(-beta dE)`` is evaluated as
``dE < -log(u) / beta`` on a threshold computed once a sweep: the same
Metropolis rule (``dE <= 0`` always accepts, as ``-log(u) >= 0``) in
fewer launches a step.

Layouts: the dense kernels keep the state as [n, R] (one contiguous row a
variable), the blocked kernel as [bs, R, nb] (one contiguous [R, nb] slab
a within-block variable).

The mesh samplers (``simulated_annealing_sharded``,
``parallel_tempering_sharded``, ``parallel_tempering_mesh_ladder``) split
the chains, or one ladder, over the slots of a ``parallel.Mesh`` axis,
each slot with its own generator seeded from ``(seed, slot)``.  One
controller runs the slots one after another, so slots on one card cost
about n_slots times the launches of one slot.
"""

from __future__ import annotations

import numpy as np
import torch

from qkan_implementation_tpu_torch.anneal.qubo import QuboModel
from qkan_implementation_tpu_torch.parallel.collectives import ppermute
from qkan_implementation_tpu_torch.utils.platform import resolve_device

def default_beta_range(model: QuboModel) -> tuple[float, float]:
    """Heuristic (beta_hot, beta_cold) from the coupling magnitudes.

    Hot: even the largest single-flip |dE| is accepted with prob 1/2.
    Cold: the smallest *individual* nonzero bias (the finest energy scale in
    the problem, e.g. the complexity-weight gaps between degree choices) is
    rejected with prob 99/100.  Same heuristic family as neal's default.
    """
    abs_fields = np.abs(model.h) + np.sum(np.abs(model.J), axis=1)
    max_de = float(np.max(abs_fields)) if abs_fields.size else 1.0
    entries = np.concatenate([np.abs(model.h).ravel(), np.abs(model.J).ravel()])
    nonzero = entries[entries > 1e-12]
    min_de = float(np.min(nonzero)) if nonzero.size else 1.0
    # The finest scale that matters may be a *difference* of linear biases
    # (degree gaps), not a bias itself; include pairwise h-gaps.
    h_sorted = np.sort(np.abs(model.h))
    gaps = np.diff(h_sorted)
    gaps = gaps[gaps > 1e-9]
    if gaps.size:
        min_de = min(min_de, float(np.min(gaps)))
    max_de = max(max_de, 1e-12)
    min_de = max(min_de, 1e-9)
    beta_hot = np.log(2.0) / max_de
    beta_cold = max(np.log(100.0) / min_de, 10.0 * beta_hot)
    return (beta_hot, beta_cold)


def default_tempering_beta_range(model: QuboModel) -> tuple[float, float]:
    """Ladder-specific (beta_hot, beta_cold) for parallel tempering.

    A tempering ladder has only ``num_replicas`` (~16) rungs and works by
    adjacent-rung exchange, so its cold end is anchored to the MEDIAN
    coupling scale rather than the finest one (``default_beta_range``):
    stretched over the min-scale span, neighbours sit so far apart that
    exchanges never accept.  Callers who need the min-scale cold end can
    pass ``beta_range`` explicitly.
    """
    beta_hot, _ = default_beta_range(model)
    entries = np.concatenate(
        [np.abs(model.h).ravel(), np.abs(model.J).ravel()]
    )
    nonzero = entries[entries > 1e-12]
    med = float(np.median(nonzero)) if nonzero.size else 1.0
    beta_cold = max(np.log(100.0) / max(med, 1e-9), 20.0 * beta_hot)
    return (beta_hot, beta_cold)


def _generator(seed: int, device: torch.device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & (2**63 - 1))
    return gen


def _uniform(gen, shape, like: torch.Tensor) -> torch.Tensor:
    return torch.rand(shape, generator=gen, dtype=like.dtype,
                      device=like.device)


def _bernoulli_half(gen, shape, like: torch.Tensor) -> torch.Tensor:
    return (_uniform(gen, shape, like) < 0.5).to(like.dtype)


def _thresholds(u: torch.Tensor, beta) -> torch.Tensor:
    """-log(u) / beta: a flip with dE below it is accepted."""
    return torch.log(u).neg_().div_(beta)


def _schedule(beta_range, count: int, dtype) -> list:
    """np.geomspace rounded to ``dtype``, as Python floats (a scalar beta
    a sweep launches nothing)."""
    return torch.tensor(
        np.geomspace(beta_range[0], beta_range[1], count), dtype=dtype
    ).tolist()


def _energies(s_flat: torch.Tensor, h: torch.Tensor, J: torch.Tensor):
    """E(s) - offset of each row of s [R, n]."""
    return s_flat @ h + 0.5 * ((s_flat @ J) * s_flat).sum(dim=1)


def _reference_sweep(s, f, thr, J, de_sum=None):
    """One per-variable sequential Metropolis sweep: state and fields
    [n, R], every flip's field update applied at once (the oracle of
    ``_delayed_sweep``).  ``de_sum`` [R], when given, accumulates the
    accepted energy changes."""
    for i in range(s.shape[0]):
        sg = torch.rsub(s[i], 1.0, alpha=2.0)  # 1 - 2 s_i
        de = sg * f[i]
        accept = de < thr[i]
        delta = torch.where(accept, sg, 0.0)
        s[i].add_(delta)
        f.addcmul_(J[i][:, None], delta[None, :])
        if de_sum is not None:
            de_sum.add_(torch.where(accept, de, 0.0))


def _delayed_structs(J: torch.Tensor, block: int):
    """Per-problem structures of the delayed-update sweep: row blocks of J
    [nb, block, n] and the within-block couplings [nb, block, block]."""
    n = J.shape[0]
    nb = n // block
    J_rows = J.reshape(nb, block, n)
    idx = torch.arange(nb, device=J.device)
    J_diag = J.reshape(nb, block, nb, block)[idx, :, idx, :]
    return J_rows, J_diag


def _delayed_sweep(s, f, thr, J_rows, J_diag, block: int, de_sum=None):
    """One delayed-update sequential Metropolis sweep over all variables.

    The chain is the per-variable sequential sweep (variables in index
    order, each seeing every earlier acceptance through its field), but
    the O(R*n) global field update of a flip is DEFERRED: within a block
    only the block's own field rows are maintained, and the full-field
    update lands as one [n, block] x [block, R] matmul a block.  The JAX
    package rolls its block buffer so the current variable is row 0; here
    the rows are indexed directly, which adds the same terms in the same
    order.  ``thr`` [n, R] are the sweep's acceptance thresholds (a
    per-read beta, for tempering, is folded into them).  ``de_sum`` as in
    ``_reference_sweep``."""
    n = s.shape[0]
    for b, i0 in enumerate(range(0, n, block)):
        s_old = s[i0:i0 + block].clone()
        fblk = f[i0:i0 + block].clone()
        jd = J_diag[b]
        for j in range(block):
            sg = torch.rsub(s[i0 + j], 1.0, alpha=2.0)
            de = sg * fblk[j]
            accept = de < thr[i0 + j]
            delta = torch.where(accept, sg, 0.0)
            s[i0 + j].add_(delta)
            # rows past j get their field maintenance; processed rows are
            # never read again
            fblk.addcmul_(jd[j][:, None], delta[None, :])
            if de_sum is not None:
                de_sum.add_(torch.where(accept, de, 0.0))
        # deferred global field update (fblk was scratch, so adding the
        # full J[block, :].T @ dblk is exact for the block's rows too)
        f.add_(J_rows[b].T @ (s[i0:i0 + block] - s_old))


def _anneal_kernel(h, J, betas, gen, num_reads: int, num_sweeps: int):
    """Per-variable sequential SA (the oracle of the delayed kernel): the
    same initial state and uniforms as ``_anneal_kernel_delayed`` with the
    same generator, so both give the same chain.  Returns (samples
    [R, n], energies [R] without the offset), tensors on h's device."""
    n = h.shape[0]
    s = _bernoulli_half(gen, (n, num_reads), h)
    f = h[:, None] + J @ s
    for t in range(num_sweeps):
        u = _uniform(gen, (n, num_reads), h)
        _reference_sweep(s, f, _thresholds(u, betas[t]), J)
    s_flat = s.T.contiguous()
    return s_flat, _energies(s_flat, h, J)


def _anneal_kernel_delayed(h, J, betas, gen, num_reads: int,
                           num_sweeps: int, block: int):
    """Delayed-update sequential-sweep SA (see ``_delayed_sweep``).

    Produces the SAME Markov chain as the per-variable sweep consuming the
    same uniforms in the same variable order (pinned by the block-size
    invariance test in float64); ``block`` is a pure scheduling knob.
    """
    n = h.shape[0]
    if n % block:
        raise ValueError("caller pads n to a multiple of block")
    s = _bernoulli_half(gen, (n, num_reads), h)
    f = h[:, None] + J @ s
    structs = _delayed_structs(J, block)
    for t in range(num_sweeps):
        u = _uniform(gen, (n, num_reads), h)
        _delayed_sweep(s, f, _thresholds(u, betas[t]), *structs, block)
    s_flat = s.T.contiguous()
    return s_flat, _energies(s_flat, h, J)


def _pad_for_block(h, J, block: int):
    """Zero-pad (h, J) so the variable count is a multiple of ``block``.
    Padding variables have zero bias and zero couplings: they random-walk
    freely and contribute nothing to any energy or field."""
    n = h.shape[0]
    pad = (-n) % block
    if pad == 0:
        return h, J, n
    h2 = np.zeros(n + pad, dtype=h.dtype)
    h2[:n] = h
    J2 = np.zeros((n + pad, n + pad), dtype=J.dtype)
    J2[:n, :n] = J
    return h2, J2, n


def _prepare_delayed(model: QuboModel, dtype, sweep_block: int | None,
                     device):
    """Validate/derive the sweep block, zero-pad (h, J) to a block
    multiple at f64, and move them to ``device`` in the kernel dtype.
    Returns ``(h, J, n_orig, sweep_block)``."""
    n = model.num_variables
    if sweep_block is None:
        sweep_block = min(32, 1 << (n - 1).bit_length())
    elif not isinstance(sweep_block, int) or sweep_block < 1:
        raise ValueError(
            f"sweep_block must be a positive int, got {sweep_block!r}"
        )
    h_np, J_np, n_orig = _pad_for_block(
        model.h.astype(np.float64), model.J.astype(np.float64), sweep_block
    )
    return (
        torch.as_tensor(h_np, dtype=dtype, device=device),
        torch.as_tensor(J_np, dtype=dtype, device=device),
        n_orig,
        sweep_block,
    )


def _to_host(model, samples, energies):
    return (samples.cpu().numpy(),
            energies.cpu().numpy().astype(np.float64) + model.offset)


def simulated_annealing(
    model: QuboModel,
    num_reads: int = 1000,
    num_sweeps: int = 1000,
    beta_range: tuple[float, float] | None = None,
    seed: int = 0,
    dtype=torch.float32,
    backend: str = "torch",
    block_structure: int | None = None,
    sweep_block: int | None = None,
    device="cuda",
):
    """Sample a QUBO with batched SA.  Returns (samples [R, n], energies [R])
    as numpy arrays.

    Energies include the model offset, matching the reference's
    ``min(decoded, key=lambda x: x.energy)`` selection semantics.

    ``backend='torch'`` runs all chains on ``device``; ``'native'`` uses
    the C++ annealer (host CPU, ``native_bindings.anneal_native``).

    ``block_structure``: when the QUBO is block-diagonal with this block
    size (verified; falls back to the dense kernel otherwise), variables
    in different blocks flip simultaneously -- a sweep is block_size
    sequential steps instead of n, the latency win for the
    per-function-independent degree QUBO.

    ``sweep_block``: delayed-update block size for the dense path (see
    ``_anneal_kernel_delayed``); the chain is block-size-invariant, so this
    is a pure scheduling knob.  None = auto (min(32, next pow2 >= n)).
    """
    if backend not in ("torch", "native"):
        raise ValueError(
            f"unknown backend {backend!r}: expected 'torch' or 'native'"
        )
    if backend == "native":
        from qkan_implementation_tpu_torch.native_bindings import (
            anneal_native,
        )

        return anneal_native(model, num_reads, num_sweeps, beta_range, seed)
    device = resolve_device(device)
    if beta_range is None:
        beta_range = default_beta_range(model)
    betas = _schedule(beta_range, num_sweeps, dtype)
    gen = _generator(seed, device)
    J_blocks = (
        _block_diagonal_J(model, block_structure)
        if block_structure is not None
        else None
    )
    if J_blocks is not None:
        nb = model.num_variables // block_structure
        samples, energies = _anneal_kernel_blocked(
            torch.as_tensor(model.h.reshape(nb, block_structure),
                            dtype=dtype, device=device),
            torch.as_tensor(J_blocks, dtype=dtype, device=device),
            betas, gen, num_reads, num_sweeps,
        )
        return _to_host(model, samples, energies)
    h_d, J_d, n_orig, sweep_block = _prepare_delayed(
        model, dtype, sweep_block, device
    )
    samples, energies = _anneal_kernel_delayed(
        h_d, J_d, betas, gen, num_reads, num_sweeps, sweep_block
    )
    return _to_host(model, samples[:, :n_orig], energies)


def _anneal_kernel_blocked(h, J_blocks, betas, gen, num_reads: int,
                           num_sweeps: int):
    """SA for block-diagonal QUBOs: one variable per block flips per step.

    ``h``: [nb, bs]; ``J_blocks``: [nb, bs, bs] (symmetric, zero diagonal).
    Blocks don't interact, so a sweep is ``bs`` sequential steps instead of
    ``nb * bs``.  State and fields [bs, R, nb]: the step's variable is one
    contiguous [R, nb] slab.  Returns (samples [R, nb * bs] block-major,
    energies [R] without the offset), tensors on h's device.
    """
    nb, bs = h.shape
    shape = (bs, num_reads, nb)
    s = _bernoulli_half(gen, shape, h)
    # f[i, r, b] = h[b, i] + sum_j J_blocks[b, i, j] s[j, r, b]
    f = h.T[:, None, :] + torch.einsum("bij,jrb->irb", J_blocks, s)
    # Jrows[i][j, b] = J_blocks[b, i, j]: the field update rows per variable
    Jrows = J_blocks.permute(1, 2, 0)[:, :, None, :]  # [bs(i), bs(j), 1, nb]
    for t in range(num_sweeps):
        thr = _thresholds(_uniform(gen, shape, h), betas[t])
        for i in range(bs):
            sg = torch.rsub(s[i], 1.0, alpha=2.0)
            delta = torch.where(sg * f[i] < thr[i], sg, 0.0)
            s[i].add_(delta)
            f.addcmul_(Jrows[i], delta[None])
    energies = torch.einsum("irb,bi->r", s, h) + 0.5 * torch.einsum(
        "irb,bij,jrb->r", s, J_blocks, s
    )
    # back to flat variable order: block-major [nb, bs]
    samples = s.permute(1, 2, 0).reshape(num_reads, nb * bs)
    return samples, energies


def _block_diagonal_J(model: QuboModel, block_size: int):
    """Return J as [nb, bs, bs] blocks if couplings are block-diagonal,
    else None."""
    n = model.num_variables
    if block_size is None or n % block_size != 0:
        return None
    nb = n // block_size
    J = model.J.reshape(nb, block_size, nb, block_size)
    off = J.copy()
    for b in range(nb):
        off[b, :, b, :] = 0.0
    if np.any(off != 0.0):
        return None
    return np.stack([J[b, :, b, :] for b in range(nb)])


def _apply_replica_swaps(s, f, E, do_swap):
    """Lift pairwise exchange decisions ``do_swap`` [C, T-1] to per-slot
    replica swaps of (state, local field, energy): s and f are [n, C, T],
    E is [C, T].  Slot t takes slot t+1's replica where pair (t, t+1)
    swaps and slot t-1's where pair (t-1, t) does."""
    C, T = E.shape
    src = torch.arange(T, device=E.device).expand(C, T).clone()
    src[:, :-1] += do_swap.long()
    src[:, 1:] -= do_swap.long()
    idx = src.expand(s.shape[0], C, T)
    return s.gather(2, idx), f.gather(2, idx), E.gather(1, src)


def _tempering(h, J, betas, gen, num_chains: int, num_replicas: int,
               num_sweeps: int, sweep):
    """Parallel tempering: each chain holds a full temperature ladder.

    State [n, C*T] (read r = c*T + t holds replica t); every replica
    Metropolis-sweeps at its own fixed beta through ``sweep`` (a
    ``(s, f, thr, de_sum)`` callable), then adjacent replicas attempt a
    state exchange with probability min(1, exp((beta_i - beta_j)(E_i -
    E_j))), even pairs then odd pairs.  Energies are maintained
    incrementally from the sweep's accepted-dE sums, with an exact
    recompute at the end.  Returns (samples [C*T, n], energies without
    the offset)."""
    n = h.shape[0]
    C, T = num_chains, num_replicas
    R = C * T
    beta_r = betas.repeat(C)
    s = _bernoulli_half(gen, (n, R), h)
    f = h[:, None] + J @ s
    E = _energies(s.T, h, J)
    pair = torch.arange(T - 1, device=h.device) % 2
    dB = betas[:-1] - betas[1:]
    for _ in range(num_sweeps):
        thr = _thresholds(_uniform(gen, (n, R), h), beta_r[None, :])
        sweep(s, f, thr, E)
        for parity in (0, 1):
            E2 = E.view(C, T)
            logp = dB[None, :] * (E2[:, :-1] - E2[:, 1:])
            u2 = _uniform(gen, (C, T - 1), h)
            do_swap = (torch.log(u2) < logp) & (pair == parity)[None, :]
            s3, f3, E2 = _apply_replica_swaps(
                s.view(n, C, T), f.view(n, C, T), E2, do_swap
            )
            s, f, E = s3.reshape(n, R), f3.reshape(n, R), E2.reshape(R)
    s_flat = s.T.contiguous()
    return s_flat, _energies(s_flat, h, J)


def _tempering_kernel(h, J, betas, gen, num_chains: int, num_replicas: int,
                      num_sweeps: int):
    """Parallel tempering on the per-variable sweep (the statistical
    oracle of ``_tempering_kernel_delayed``)."""
    return _tempering(
        h, J, betas, gen, num_chains, num_replicas, num_sweeps,
        lambda s, f, thr, E: _reference_sweep(s, f, thr, J, E),
    )


def _tempering_kernel_delayed(h, J, betas, gen, num_chains: int,
                              num_replicas: int, num_sweeps: int,
                              block: int):
    """Parallel tempering on the delayed-update sweep (``_delayed_sweep``
    with the ladder folded into the per-read thresholds)."""
    structs = _delayed_structs(J, block)
    return _tempering(
        h, J, betas, gen, num_chains, num_replicas, num_sweeps,
        lambda s, f, thr, E: _delayed_sweep(s, f, thr, *structs, block, E),
    )


def parallel_tempering(
    model: QuboModel,
    num_chains: int = 64,
    num_replicas: int = 16,
    num_sweeps: int = 1000,
    beta_range: tuple[float, float] | None = None,
    seed: int = 0,
    dtype=torch.float32,
    sweep_block: int | None = None,
    kernel: str = "delayed",
    device="cuda",
):
    """Sample a QUBO with parallel tempering (replica exchange) on
    ``device``.

    The move single-flip SA lacks for rugged, NON-separable QUBOs: a
    geometric ladder of ``num_replicas`` temperatures per chain with
    adjacent-replica state exchanges after every sweep.  All
    chains x replicas run as one batched state.  Returns
    (samples [C*T, n], energies [C*T]) as numpy, offset included.

    ``kernel='delayed'`` (default) runs sweeps on the delayed-update
    schedule (``_delayed_sweep``); ``'reference'`` keeps the per-variable
    sweep (the statistical-equivalence oracle).  ``sweep_block`` as in
    ``simulated_annealing``.
    """
    if kernel not in ("delayed", "reference"):
        raise ValueError(
            f"unknown kernel {kernel!r}: expected 'delayed' or 'reference'"
        )
    device = resolve_device(device)
    if beta_range is None:
        beta_range = default_tempering_beta_range(model)
    betas = torch.tensor(
        np.geomspace(beta_range[0], beta_range[1], num_replicas),
        dtype=dtype, device=device,
    )
    gen = _generator(seed, device)
    if kernel == "reference":
        samples, energies = _tempering_kernel(
            torch.as_tensor(model.h, dtype=dtype, device=device),
            torch.as_tensor(model.J, dtype=dtype, device=device),
            betas, gen, num_chains, num_replicas, num_sweeps,
        )
        return _to_host(model, samples, energies)
    h_d, J_d, n_orig, sweep_block = _prepare_delayed(
        model, dtype, sweep_block, device
    )
    samples, energies = _tempering_kernel_delayed(
        h_d, J_d, betas, gen, num_chains, num_replicas, num_sweeps,
        sweep_block,
    )
    return _to_host(model, samples[:, :n_orig], energies)


def _slot_generator(seed: int, slot: int, device) -> torch.Generator:
    """Slot ``slot``'s own stream, seeded from ``(seed, slot)``."""
    state = np.random.SeedSequence([int(seed) & (2**63 - 1), slot])
    return _generator(int(state.generate_state(1, np.uint64)[0]), device)


def _axis_slots(mesh, axis_name: str) -> tuple:
    """The slots the chains split over: ``axis_name`` alone, at index 0
    of every other axis (the JAX samplers shard over the named axis and
    duplicate the work along the others)."""
    if axis_name not in mesh.axis_names:
        raise ValueError(
            f"axis {axis_name!r} not in mesh axes {mesh.axis_names}"
        )
    return mesh.axis_devices(axis_name)


def _gather_slots(model, results) -> tuple:
    """Per-slot (samples, energies) in slot order -> numpy, offset
    included."""
    return (np.concatenate([s.cpu().numpy() for s, _ in results]),
            np.concatenate([e.cpu().numpy().astype(np.float64)
                            for _, e in results]) + model.offset)


def parallel_tempering_sharded(
    model: QuboModel,
    mesh,
    axis_name: str = "d",
    num_chains: int = 64,
    num_replicas: int = 16,
    num_sweeps: int = 1000,
    beta_range: tuple[float, float] | None = None,
    seed: int = 0,
    dtype=torch.float32,
    sweep_block: int | None = None,
):
    """Mesh-sharded parallel tempering: chains split over the slots of
    ``axis_name``, each slot running full temperature ladders on its own
    generator (replica exchange never crosses slots) -- the tempering
    analog of ``simulated_annealing_sharded``.

    Returns (samples [C'*T, n], energies) as numpy with
    C' = ceil(C / n_slots) * n_slots, slot order.
    """
    slots = _axis_slots(mesh, axis_name)
    chains_local = -(-num_chains // len(slots))
    if beta_range is None:
        beta_range = default_tempering_beta_range(model)
    results = []
    for slot, dev in enumerate(slots):
        # same delayed-update schedule as the single-slot path
        h, J, n_orig, block = _prepare_delayed(model, dtype, sweep_block,
                                               dev)
        betas = torch.tensor(
            np.geomspace(beta_range[0], beta_range[1], num_replicas),
            dtype=dtype, device=dev,
        )
        s, e = _tempering_kernel_delayed(
            h, J, betas, _slot_generator(seed, slot, dev), chains_local,
            num_replicas, num_sweeps, block,
        )
        results.append((s[:, :n_orig], e))
    return _gather_slots(model, results)


def _boundary_swaps(s3, f3, E2, nbr, lo: bool, logp, u, active):
    """Apply one side of a boundary exchange in place: where the shared
    Metropolis test passes, the edge replica (the coldest local one if
    ``lo``, else the hottest) takes the neighbour's (s, f, E) ``nbr``."""
    if not active:
        return
    edge = -1 if lo else 0
    swap = torch.log(u) < logp  # [C]
    s3[:, :, edge] = torch.where(swap[None, :], nbr[0], s3[:, :, edge])
    f3[:, :, edge] = torch.where(swap[None, :], nbr[1], f3[:, :, edge])
    E2[:, edge] = torch.where(swap, nbr[2], E2[:, edge])


def _tempering_mesh_kernel(h, J, betas_local, gens, shared_gen, slots,
                           num_chains: int, num_sweeps: int, block: int):
    """Parallel tempering with the temperature ladder SPLIT over the
    slots: global ladder T = n_slots * t_local, slot d sweeping its
    ``t_local`` replicas (``betas_local[d]``) on its own generator.

    Within-slot adjacent pairs exchange as in ``_tempering`` (by GLOBAL
    pair parity); the BOUNDARY pair between slot d's coldest replica and
    slot d+1's hottest: both neighbours receive the other's edge replica
    (s, f, E) through ``ppermute``, read the SAME uniform (one draw a
    sweep and parity on ``shared_gen``, column d for boundary d), and each
    applies the identical Metropolis decision to its own side.  Returns
    per-slot (samples [C*t_local, n], energies without the offset)."""
    n_dev = len(slots)
    n = h[0].shape[0]
    C, Tl = num_chains, betas_local[0].shape[0]
    R = C * Tl
    structs = [_delayed_structs(J_d, block) for J_d in J]
    st = []
    for d in range(n_dev):
        s = _bernoulli_half(gens[d], (n, R), h[d])
        st.append([s, h[d][:, None] + J[d] @ s, _energies(s.T, h[d], J[d])])
    beta_r = [b.repeat(C) for b in betas_local]
    dB = [b[:-1] - b[1:] for b in betas_local]
    g_pair = [(d * Tl + torch.arange(Tl - 1, device=slots[d])) % 2
              for d in range(n_dev)]
    up = [(d + 1, d) for d in range(n_dev - 1)]  # neighbour above -> me
    dn = [(d, d + 1) for d in range(n_dev - 1)]  # me -> neighbour above
    nb_first = ppermute([b[:1] for b in betas_local], up)
    pb_last = ppermute([b[-1:] for b in betas_local], dn)
    for _ in range(num_sweeps):
        for d in range(n_dev):
            s, f, E = st[d]
            thr = _thresholds(_uniform(gens[d], (n, R), h[d]),
                              beta_r[d][None, :])
            _delayed_sweep(s, f, thr, *structs[d], block, E)
        for parity in (0, 1):
            views = []
            for d in range(n_dev):
                s, f, E = st[d]
                s3, f3, E2 = s.view(n, C, Tl), f.view(n, C, Tl), E.view(C, Tl)
                if Tl > 1:
                    logp = dB[d][None, :] * (E2[:, :-1] - E2[:, 1:])
                    u2 = _uniform(gens[d], (C, Tl - 1), h[d])
                    do_swap = (torch.log(u2) < logp) & (
                        g_pair[d] == parity)[None, :]
                    s3, f3, E2 = _apply_replica_swaps(s3, f3, E2, do_swap)
                views.append((s3, f3, E2))
            if n_dev > 1:
                u_all = _uniform(shared_gen, (C, n_dev), h[0])
                # each slot's edge replicas before any boundary swap (a
                # copy: ppermute between slots of one card moves a view)
                first = [[v[k][..., 0].clone() for v in views]
                         for k in range(3)]
                last = [[v[k][..., -1].clone() for v in views]
                        for k in range(3)]
                nf = [ppermute(first[k], up) for k in range(3)]
                pl = [ppermute(last[k], dn) for k in range(3)]
                for d, (s3, f3, E2) in enumerate(views):
                    dev = slots[d]
                    # lower side of boundary d: my last vs the first above
                    lo = (d * Tl + Tl - 1) % 2 == parity and d < n_dev - 1
                    _boundary_swaps(
                        s3, f3, E2, [nf[k][d] for k in range(3)], True,
                        (betas_local[d][-1] - nb_first[d][0])
                        * (E2[:, -1] - nf[2][d]),
                        u_all[:, min(d, n_dev - 2)].to(dev), lo,
                    )
                    # upper side of boundary d-1: the last below vs my first
                    hi = ((d - 1) * Tl + Tl - 1) % 2 == parity and d > 0
                    _boundary_swaps(
                        s3, f3, E2, [pl[k][d] for k in range(3)], False,
                        (pb_last[d][0] - betas_local[d][0])
                        * (pl[2][d] - E2[:, 0]),
                        u_all[:, max(d - 1, 0)].to(dev), hi,
                    )
            st = [[s3.reshape(n, R), f3.reshape(n, R), E2.reshape(R)]
                  for s3, f3, E2 in views]
    return [(s.T.contiguous(), _energies(s.T.contiguous(), h[d], J[d]))
            for d, (s, _, _) in enumerate(st)]


def parallel_tempering_mesh_ladder(
    model: QuboModel,
    mesh,
    axis_name: str = "d",
    num_chains: int = 64,
    num_replicas: int = 16,
    num_sweeps: int = 1000,
    beta_range: tuple[float, float] | None = None,
    seed: int = 0,
    dtype=torch.float32,
):
    """Parallel tempering with the replica ladder spanning the slots.

    Unlike ``parallel_tempering_sharded`` (independent full ladders per
    slot), ONE global geometric ladder of ``num_replicas`` temperatures is
    split contiguously over the slots of ``axis_name``; boundary replicas
    exchange through ``collectives.ppermute`` every sweep
    (``_tempering_mesh_kernel``).  State is [chains, replicas / slot, n] a
    slot.  ``num_replicas`` must divide over the slots.  Sweeps run on
    the delayed-update schedule with the auto block (the same chain as
    the per-variable sweep).  Returns (samples [n_slots * C * T_local, n],
    energies) as numpy, offset included.
    """
    slots = _axis_slots(mesh, axis_name)
    n_dev = len(slots)
    if num_replicas % n_dev != 0:
        raise ValueError(
            f"num_replicas {num_replicas} must divide over {n_dev} devices"
        )
    if beta_range is None:
        beta_range = default_tempering_beta_range(model)
    betas = np.geomspace(beta_range[0], beta_range[1], num_replicas)
    t_local = num_replicas // n_dev
    h, J, betas_local = [], [], []
    for d, dev in enumerate(slots):
        h_d, J_d, n_orig, block = _prepare_delayed(model, dtype, None, dev)
        h.append(h_d)
        J.append(J_d)
        betas_local.append(torch.tensor(
            betas[d * t_local:(d + 1) * t_local], dtype=dtype, device=dev))
    results = _tempering_mesh_kernel(
        h, J, betas_local,
        [_slot_generator(seed, d, dev) for d, dev in enumerate(slots)],
        _slot_generator(seed, n_dev, slots[0]), slots, num_chains,
        num_sweeps, block,
    )
    return _gather_slots(model, [(s[:, :n_orig], e) for s, e in results])


def simulated_annealing_sharded(
    model: QuboModel,
    mesh,
    axis_name: str = "d",
    num_reads: int = 1000,
    num_sweeps: int = 1000,
    beta_range: tuple[float, float] | None = None,
    seed: int = 0,
    dtype=torch.float32,
    sweep_block: int | None = None,
):
    """Chain-parallel SA: the ``num_reads`` chains split over the slots of
    ``axis_name`` (SURVEY.md section 2, "chain parallelism for
    annealing").

    Each slot runs an independent slice of chains on its own generator,
    seeded from ``(seed, slot)``, on the delayed-update schedule of the
    single-slot path; nothing crosses slots until the samples are
    gathered.  Returns (samples [R', n], energies [R']) as numpy with
    R' = ceil(R / n_slots) * n_slots, slot order.
    """
    slots = _axis_slots(mesh, axis_name)
    reads_local = -(-num_reads // len(slots))
    if beta_range is None:
        beta_range = default_beta_range(model)
    betas = _schedule(beta_range, num_sweeps, dtype)
    results = []
    for slot, dev in enumerate(slots):
        h, J, n_orig, block = _prepare_delayed(model, dtype, sweep_block,
                                               dev)
        s, e = _anneal_kernel_delayed(
            h, J, betas, _slot_generator(seed, slot, dev), reads_local,
            num_sweeps, block,
        )
        results.append((s[:, :n_orig], e))
    return _gather_slots(model, results)


def _greedy_kernel(h, J, s):
    """Steepest single-flip descent, all samples at once, until no sample
    has an improving flip: one round per flip, the flag read once a
    round.  The local field is carried and updated per flip (one row of
    J per sample)."""
    rows = torch.arange(s.shape[0], device=s.device)
    f = h[None, :] + s @ J  # [R, n]
    while True:
        de = (1.0 - 2.0 * s) * f  # dE of flipping each bit
        best = torch.argmin(de, dim=1)  # steepest single flip a sample
        flip = de[rows, best] < -1e-12
        dval = torch.where(flip, 1.0 - 2.0 * s[rows, best], 0.0)  # [R]
        f = f + dval[:, None] * J[best]
        s[rows, best] += dval
        if not bool(flip.any()):
            return s


def greedy_descent(model: QuboModel, samples: np.ndarray,
                   device="cuda") -> np.ndarray:
    """Steepest-descent single-flip polish to a local optimum, vectorized
    over samples, in float32 on ``device`` (what neal's C++ post-pass
    effectively buys on dense QUBOs)."""
    device = resolve_device(device)
    s = _greedy_kernel(
        torch.as_tensor(model.h, dtype=torch.float32, device=device),
        torch.as_tensor(model.J, dtype=torch.float32, device=device),
        torch.as_tensor(np.asarray(samples), dtype=torch.float32,
                        device=device).clone(),
    )
    return s.cpu().numpy().astype(np.float64)


def polish_one_hot_blocks(
    model: QuboModel, samples: np.ndarray, block_size: int
) -> np.ndarray:
    """Greedy blockwise repair for one-hot-structured QUBOs (numpy, on the
    host, as in the JAX package).

    For each consecutive block of ``block_size`` variables, fix everything
    outside the block and set the single bit minimizing the energy -- the
    natural move set for one-hot selection problems, where single-bit
    Metropolis must tunnel through the constraint penalty.  Guarantees each
    sample is blockwise-optimal (and hence globally optimal when blocks are
    independent, as in the degree-selection QUBO).
    """
    s = np.array(samples, dtype=np.float64, copy=True)
    n = model.num_variables
    if n % block_size != 0:
        raise ValueError("block_size must divide the number of variables")
    for i0 in range(0, n, block_size):
        i1 = i0 + block_size
        s[:, i0:i1] = 0.0
        fields = model.h[i0:i1][None, :] + s @ model.J[:, i0:i1]
        choice = np.argmin(fields, axis=1)
        s[np.arange(s.shape[0]), i0 + choice] = 1.0
    return s


def solve_qubo(
    model: QuboModel,
    num_reads: int = 1000,
    num_sweeps: int = 1000,
    beta_range: tuple[float, float] | None = None,
    seed: int = 0,
    one_hot_block_size: int | None = None,
    device="cuda",
) -> tuple[np.ndarray, float]:
    """Anneal on ``device`` (optionally polish one-hot blocks) and return
    the best sample."""
    samples, energies = simulated_annealing(
        model, num_reads, num_sweeps, beta_range, seed,
        block_structure=one_hot_block_size, device=device,
    )
    if one_hot_block_size is not None:
        samples = polish_one_hot_blocks(model, samples, one_hot_block_size)
        energies = model.energy(samples)
    best = int(np.argmin(energies))
    return samples[best], float(energies[best])
