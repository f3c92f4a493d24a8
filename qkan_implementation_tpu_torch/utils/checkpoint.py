"""Checkpointing helpers: npz for flat dicts, ``torch.save`` for trees.

Counterpart of ``qkan_implementation_tpu.utils.checkpoint``.
``save_npz`` / ``load_npz`` read and write the same npz as the JAX
package's (numpy's format, the same ``.npz`` suffix rule), so a file from
either package loads in the other.

``save_pytree`` / ``load_pytree`` keep a tree of tensors (dicts, lists,
tuples; ``parallel.Shards`` leaves of a per-slot layout included).  The
JAX package writes these with orbax, which the port does not use and the
card's machine does not have, so the port writes its own format:
``torch.save`` of the tree with every tensor copied to the CPU.  The two
packages' ``save_pytree`` files are therefore NOT interchangeable: an
orbax checkpoint is a directory of tensorstore arrays, this one a single
``torch.save`` file of plain containers and tensors, which
``torch.load(weights_only=True)`` reads.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any

import numpy as np
import torch

from qkan_implementation_tpu_torch.parallel.mesh import Shards


def _encode(tree):
    """The tree with tensors on the CPU and each ``Shards`` a tagged dict
    (plain containers only, so ``weights_only`` loading reads it)."""
    if isinstance(tree, Shards):
        return {"__shards__": [_encode(p) for p in tree.parts],
                "dim": tree.dim}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _encode(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_encode(v) for v in tree)
    return tree


def _decode(tree, target):
    """Undo ``_encode``; each tensor goes to the device of the matching
    leaf of ``target`` (CPU where there is none)."""
    if isinstance(tree, dict) and "__shards__" in tree:
        parts = target.parts if isinstance(target, Shards) else None
        return Shards([_decode(p, None if parts is None else parts[j])
                       for j, p in enumerate(tree["__shards__"])],
                      tree["dim"])
    if isinstance(tree, torch.Tensor):
        return tree if not isinstance(target, torch.Tensor) else tree.to(
            target.device)
    if isinstance(tree, dict):
        return {k: _decode(v, None if target is None else target[k])
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_decode(v, None if target is None else target[i])
                          for i, v in enumerate(tree))
    return tree


def save_pytree(path: str, pytree: Any) -> None:
    """Save a tree of tensors (``Shards`` leaves included) to one file."""
    torch.save(_encode(pytree), Path(path).resolve())


def load_pytree(path: str, target: Any | None = None) -> Any:
    """Restore a tree saved by ``save_pytree``, bit for bit.

    ``target``: a tree of the same structure whose leaves say where each
    restored leaf goes: each tensor onto the device of the matching
    tensor of ``target``, each ``Shards`` part onto its part's slot.
    None restores every tensor on the CPU.
    """
    tree = torch.load(Path(path).resolve(), weights_only=True)
    return _decode(tree, target)


def save_npz(path: str, tree: dict) -> None:
    """Flat dict of arrays -> npz (tensors are read to the host)."""
    np.savez(path, **{
        k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
        else np.asarray(v)
        for k, v in tree.items()
    })


def load_npz(path: str) -> dict:
    if not str(path).endswith(".npz"):
        path = str(path) + ".npz"
    with np.load(path) as data:
        return {k: data[k] for k in data.files}
