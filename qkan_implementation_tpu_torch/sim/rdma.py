"""The global-qubit exchange fused with its gate (K11), on the card.

Counterpart of ``qkan_implementation_tpu.sim.rdma``.  The sharded engine
(``sim.sharded``) moves a global qubit into a slot's block by exchanging
half blocks with the partner slot, then applies the gate.  When the gate
is a multiplexed Ry or a Hadamard on that qubit, the two steps are one
kernel (``csrc/exchange.cu``): each slot reads the half it keeps and the
half its partner sends, and writes the rotated pair in the post-exchange
layout (local MSB = the previously global target; the old local-MSB
qubit now lives at global position ``dev_bit`` -- the caller's layout
tracker records the swap).

- ``ucry_exchange_fused_rdma(blocks, cos_half, sin_half, dev_bit)``:
  multiplexed Ry from each slot's cos/sin(theta/2) (global control axes
  already selected by slot bits);
- ``h_exchange_fused_rdma(blocks, dev_bit)``: Hadamard.

In JAX these act on one device's block inside ``shard_map``; one
controller sees every slot, so here they take the list of every slot's
flat [2M] block (and per-slot [M] coefficients) and return the list.
The TPU kernel hides a remote DMA behind the 2x2 with double-buffered
VMEM slots and capacity credits; on one card the partner's half is
already in the card's memory and the kernel reads it in place.  Where
the partner sits on another card its half comes over first with
``Tensor.to`` (NVLink), then the same kernel runs: that route has not run
on a machine with two cards.  ``interpret`` is accepted and ignored;
``CHUNK_ROWS``, ``INTERPRET_MAX_BLOCK`` and the 8x128 tile rule are TPU
artefacts with no counterpart.

On a CPU slot the functions run their plain versions
(``ucry_exchange_reference``, ``h_exchange_reference``); on a CUDA slot
they launch the kernel (float32 or float64) or raise -- no fallback.
Both are differentiable with the JAX custom VJPs: the cotangents of c and
s are elementwise products against the post-exchange inputs, recovered by
inverse-rotating the saved outputs, and the block's is R^T g followed by
the adjoint exchange on the collective path (the exchange is an
involution).  Launch counts: ``.launches`` on each function, one per slot
launch.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from qkan_implementation_tpu_torch.ops._cuda_build import (
    count_launches,
    raise_on_error,
)
from qkan_implementation_tpu_torch.utils.platform import (
    tensor_device_type as _device_of,
)

_KERNEL_DTYPES = (torch.float32, torch.float64)
_INV_SQRT2 = 0.7071067811865476


def ucry_exchange_eligible(block_size: int, interpret: bool = False) -> bool:
    """The fused kernel takes any block with at least one pair in its half
    (the TPU's tile and interpret-mode ceilings have no counterpart)."""
    del interpret
    return block_size >= 2


# -- plain versions ---------------------------------------------------------


def _pair(kept, received, g: int):
    return (kept, received) if g == 0 else (received, kept)


def ucry_exchange_reference(kept, received, c, s, g: int):
    """Plain K11 with the multiplexed Ry: [2M] from the kept and received
    halves [M] of a slot with device bit ``g``."""
    p0, p1 = _pair(kept, received, g)
    return torch.cat([c * p0 - s * p1, s * p0 + c * p1])


def h_exchange_reference(kept, received, g: int):
    """Plain K11 with the Hadamard."""
    p0, p1 = _pair(kept, received, g)
    return torch.cat([(p0 + p1) * _INV_SQRT2, (p0 - p1) * _INV_SQRT2])


# -- the launches -------------------------------------------------------------


def _launch(entry: str, out, ptrs: tuple, m: int, g: int, owner):
    from qkan_implementation_tpu_torch.ops._cuda_build import load_library

    lib = load_library()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = getattr(lib, entry)(*ptrs, out.data_ptr(), m, g,
                                  int(out.dtype == torch.float64), stream)
    raise_on_error(lib, err, entry)
    count_launches(owner, "launches")
    return out


def _halves_for(blocks, d: int, dev_bit: int, m: int):
    """(kept, received, g) of slot ``d``: its own half g and the
    partner's half g, the latter moved to the slot's device."""
    g = (d >> dev_bit) & 1
    mine = blocks[d]
    partner = blocks[d ^ (1 << dev_bit)]
    kept = mine[g * m:(g + 1) * m]
    received = partner[g * m:(g + 1) * m].to(mine.device)
    return kept, received, g


def _check_blocks(blocks, dev_bit: int, name: str) -> int:
    """The half size M; raise on a mesh or blocks the exchange cannot
    take."""
    n = len(blocks)
    if n < 2 or n & (n - 1):
        raise ValueError(f"{name}: needs a power-of-two slot count >= 2, "
                         f"got {n}")
    if dev_bit < 0 or (1 << dev_bit) >= n:
        raise ValueError(f"{name}: dev_bit {dev_bit} out of range for {n} "
                         "slots")
    size = blocks[0].shape[-1]
    if any(b.dim() != 1 or b.shape[0] != size for b in blocks):
        raise ValueError(f"{name}: every slot's block must be flat "
                         f"[{size}]")
    if size < 2 or size & (size - 1):
        raise ValueError(f"{name}: block of {size} is not a power of two "
                         ">= 2")
    return size // 2


def _check_kernel(t: torch.Tensor, like: torch.Tensor, name: str):
    """``t`` contiguous in the block's dtype (cast as the TPU kernel casts
    its coefficients); raise if it lies on another device."""
    if t.device != like.device:
        raise ValueError(f"{name}: on {t.device}, the block on {like.device}")
    return t.to(like.dtype).contiguous()


def _ucry_slot(kept, received, c, s, g: int):
    if _device_of(kept) == "cpu":
        return ucry_exchange_reference(kept, received, c.to(kept.dtype),
                                       s.to(kept.dtype), g)
    name = "qkan_exchange_ucry"
    if kept.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"{name}: the kernel takes float32 or float64, "
                         f"got {kept.dtype}")
    m = kept.shape[0]
    kept, received, c, s = (_check_kernel(t, kept, name)
                            for t in (kept, received, c, s))
    if c.shape != (m,) or s.shape != (m,):
        raise ValueError(f"{name}: cos/sin {tuple(c.shape)}, "
                         f"{tuple(s.shape)} for a half of {m}")
    out = torch.empty(2 * m, dtype=kept.dtype, device=kept.device)
    return _launch(name, out, (kept.data_ptr(), received.data_ptr(),
                               c.data_ptr(), s.data_ptr()), m, g,
                   ucry_exchange_fused_rdma)


def _h_slot(kept, received, g: int):
    if _device_of(kept) == "cpu":
        return h_exchange_reference(kept, received, g)
    name = "qkan_exchange_h"
    if kept.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"{name}: the kernel takes float32 or float64, "
                         f"got {kept.dtype}")
    kept, received = (_check_kernel(t, kept, name) for t in (kept, received))
    m = kept.shape[0]
    out = torch.empty(2 * m, dtype=kept.dtype, device=kept.device)
    return _launch(name, out, (kept.data_ptr(), received.data_ptr()), m, g,
                   h_exchange_fused_rdma)


def _ucry_all(blocks, cs, sn, dev_bit: int):
    m = _check_blocks(blocks, dev_bit, "ucry_exchange_fused_rdma")
    outs = []
    for d in range(len(blocks)):
        kept, received, g = _halves_for(blocks, d, dev_bit, m)
        outs.append(_ucry_slot(kept, received, cs[d], sn[d], g))
    return outs


def _h_all(blocks, dev_bit: int):
    m = _check_blocks(blocks, dev_bit, "h_exchange_fused_rdma")
    outs = []
    for d in range(len(blocks)):
        kept, received, g = _halves_for(blocks, d, dev_bit, m)
        outs.append(_h_slot(kept, received, g))
    return outs


def _adjoint_exchange(dposts, dev_bit: int):
    """The exchange's cotangent: the exchange itself, on the collective
    path (``sim.sharded._exchange_global_local`` at the local MSB)."""
    from qkan_implementation_tpu_torch.sim.sharded import _exchange_global_local

    q_local = int(np.log2(dposts[0].shape[0]))
    return _exchange_global_local(dposts, dev_bit, q_local - 1)


class _UcryExchange(torch.autograd.Function):
    """inputs: dev_bit, n, then n blocks, n cos, n sin."""

    @staticmethod
    def forward(ctx, dev_bit, n, *flat):
        blocks, cs, sn = flat[:n], flat[n:2 * n], flat[2 * n:]
        outs = _ucry_all(blocks, cs, sn, dev_bit)
        ctx.dev_bit, ctx.n = dev_bit, n
        ctx.save_for_backward(*outs, *cs, *sn)
        return tuple(outs)

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        n = ctx.n
        saved = ctx.saved_tensors
        outs, cs, sn = saved[:n], saved[n:2 * n], saved[2 * n:]
        need = ctx.needs_input_grad[2:]
        want_block = any(need[:n])
        dposts, dcs, dss = [], [], []
        for out, c, s, g in zip(outs, cs, sn, grads):
            m = c.shape[0]
            if g is None:
                g = torch.zeros_like(out)
            c_, s_ = c.to(out.dtype), s.to(out.dtype)
            o0, o1 = out[:m], out[m:]
            g0, g1 = g[:m], g[m:]
            # post-exchange inputs recovered by the inverse rotation
            p0 = c_ * o0 + s_ * o1
            p1 = -s_ * o0 + c_ * o1
            dcs.append((g0 * p0 + g1 * p1).to(c.dtype))
            dss.append((g1 * p0 - g0 * p1).to(s.dtype))
            if want_block:
                dposts.append(torch.cat([c_ * g0 + s_ * g1,
                                         -s_ * g0 + c_ * g1]))
        dblocks = (_adjoint_exchange(dposts, ctx.dev_bit) if want_block
                   else [None] * n)
        return (None, None, *dblocks, *dcs, *dss)


class _HExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dev_bit, *blocks):
        ctx.dev_bit = dev_bit
        return tuple(_h_all(blocks, dev_bit))

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        hgs = []
        for g in grads:
            m = g.shape[0] // 2
            g0, g1 = g[:m], g[m:]
            hgs.append(torch.cat([(g0 + g1) * _INV_SQRT2,
                                  (g0 - g1) * _INV_SQRT2]))
        return (None, *_adjoint_exchange(hgs, ctx.dev_bit))


def _needs_grad(tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def ucry_exchange_fused_rdma(blocks, cos_half, sin_half, dev_bit: int,
                             axis_name: str | None = None,
                             n_dev: int | None = None,
                             interpret: bool = False) -> list:
    """Exchange global qubit ``dev_bit`` with the local MSB and apply the
    multiplexed Ry targeting it, in one pass per slot (K11).

    ``blocks``: every slot's flat [2M] real block (halves by the local
    MSB), slot i at index i.  ``cos_half`` / ``sin_half``: the list of
    each slot's [M] coefficients.
    ``axis_name`` and ``interpret`` are accepted and ignored; ``n_dev``,
    when given, must be the number of slots.  Returns the rotated blocks
    in post-exchange layout.  Differentiable in all three.  Counts
    ``.launches``, one per slot on the card.
    """
    del axis_name, interpret
    n = len(blocks)
    if n_dev is not None and n_dev != n:
        raise ValueError(f"n_dev {n_dev} but {n} blocks")
    cs, sn = list(cos_half), list(sin_half)
    if len(cs) != n or len(sn) != n:
        raise ValueError(f"{len(cs)}, {len(sn)} coefficient vectors for {n} "
                         "slots")
    if _needs_grad([*blocks, *cs, *sn]):
        return list(_UcryExchange.apply(dev_bit, n, *blocks, *cs, *sn))
    return _ucry_all(blocks, cs, sn, dev_bit)


ucry_exchange_fused_rdma.launches = 0


def h_exchange_fused_rdma(blocks, dev_bit: int, axis_name: str | None = None,
                          n_dev: int | None = None,
                          interpret: bool = False) -> list:
    """Exchange global qubit ``dev_bit`` with the local MSB and apply a
    Hadamard to it, in one pass per slot (K11).  Returns the blocks in
    post-exchange layout.  Differentiable in ``blocks``.  Counts
    ``.launches``, one per slot on the card."""
    del axis_name, interpret
    n = len(blocks)
    if n_dev is not None and n_dev != n:
        raise ValueError(f"n_dev {n_dev} but {n} blocks")
    if _needs_grad(blocks):
        return list(_HExchange.apply(dev_bit, *blocks))
    return _h_all(blocks, dev_bit)


h_exchange_fused_rdma.launches = 0
