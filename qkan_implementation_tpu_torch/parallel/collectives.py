"""Named collectives over the slots of a mesh axis.

Counterpart of ``qkan_implementation_tpu.parallel.collectives``.  There
each function runs inside ``shard_map`` on one device's value; here one
controller sees every slot, so each function takes the list of per-slot
tensors along the axis (slot i at index i) and returns the list of
results, each on its slot's device.  A payload bound for another device
moves with ``Tensor.to(device)``, which is no copy at all when both slots
sit on one card.  Sums run in slot order, so every slot gets the same
bits.
"""

from __future__ import annotations

import torch


def _on_each(value: torch.Tensor, xs) -> list:
    return [value.to(x.device) for x in xs]


def psum(xs) -> list:
    """All-reduce sum over the slots."""
    total = xs[0]
    for x in xs[1:]:
        total = total + x.to(total.device)
    return _on_each(total, xs)


def pmean(xs) -> list:
    return [s / len(xs) for s in psum(xs)]


def all_gather(xs, axis: int = 0, tiled: bool = True) -> list:
    """Every slot's tensor, concatenated along ``axis`` (``tiled``) or
    stacked on a new ``axis``, on every slot."""
    dev = xs[0].device
    parts = [x.to(dev) for x in xs]
    out = torch.cat(parts, dim=axis) if tiled else torch.stack(parts, dim=axis)
    return _on_each(out, xs)


def ppermute(xs, perm) -> list:
    """Point-to-point permutation: slot ``dst`` receives slot ``src``'s
    tensor for each (src, dst) in ``perm``; a slot that receives nothing
    gets zeros (``jax.lax.ppermute``)."""
    out = [torch.zeros_like(x) for x in xs]
    for src, dst in perm:
        out[dst] = xs[src].to(xs[dst].device)
    return out


def all_to_all(xs, split_axis: int, concat_axis: int) -> list:
    """Slot j receives piece j of every slot's tensor (split in
    ``len(xs)`` along ``split_axis``), concatenated in slot order along
    ``concat_axis`` (``jax.lax.all_to_all`` with ``tiled=True``)."""
    n = len(xs)
    pieces = [torch.chunk(x, n, dim=split_axis) for x in xs]
    if any(len(p) != n for p in pieces):
        raise ValueError(f"axis {split_axis} does not split in {n}")
    return [torch.cat([p[j].to(x.device) for p in pieces], dim=concat_axis)
            for j, x in enumerate(xs)]


def _check_pair(n_devices: int, partner_bit: int, name: str) -> None:
    if n_devices & (n_devices - 1):
        raise ValueError(
            f"{name} needs a power-of-two device count, got {n_devices} "
            f"(non-power counts leave some devices without a hypercube "
            f"partner)"
        )
    if (1 << partner_bit) >= n_devices:
        raise ValueError(
            f"partner_bit {partner_bit} out of range for {n_devices} "
            f"devices (need 1 << partner_bit < n_devices)"
        )


def pairwise_exchange(xs, partner_bit: int) -> list:
    """Exchange payloads with the partner slot differing in
    ``partner_bit``: slot i receives slot i ^ (1 << partner_bit)'s tensor.
    The hypercube-edge exchange of the sharded statevector's
    qubit-remapping step."""
    _check_pair(len(xs), partner_bit, "pairwise_exchange")
    bit = 1 << partner_bit
    return [xs[i ^ bit].to(x.device) for i, x in enumerate(xs)]


def pairwise_exchange_a2a(xs, partner_bit: int) -> list:
    """``pairwise_exchange`` through ``all_to_all`` over 2-slot groups:
    the second implementation behind the swappable exchange.  Each
    hypercube pair is a group; each member stacks its payload twice, the
    group's all-to-all hands member k row k of both stacks, and the
    partner's copy sits in row 1 - own."""
    _check_pair(len(xs), partner_bit, "pairwise_exchange_a2a")
    bit = 1 << partner_bit
    out = [None] * len(xs)
    for lo in range(len(xs)):
        if lo & bit:
            continue
        group = [lo, lo | bit]
        stacked = [torch.stack([xs[i], xs[i]]) for i in group]
        for k, got in zip(group, all_to_all(stacked, 0, 0)):
            own = (k >> partner_bit) & 1
            out[k] = got[1] if own == 0 else got[0]
    return out
