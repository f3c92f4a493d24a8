"""Mesh construction helpers.

Counterpart of ``qkan_implementation_tpu.parallel.mesh``.  The JAX
package runs one controller over a ``jax.sharding.Mesh``; so does the
port, over a ``Mesh`` of its own: a grid of slots, each slot a
``torch.device`` that holds one shard.  Several slots may name the same
device -- ``make_mesh(8, devices=["cuda:0"] * 8)`` is 8 slots on one card,
as the JAX tests' 8 virtual CPU devices share one CPU, and
``devices=["cpu"] * 8`` is the CPU test mesh.  By default a mesh takes
CUDA cards, one slot each, and raises when there are fewer cards than
slots: it never falls back to the CPU.

``Shards`` holds one tensor split over the slots of an axis (a tp
coefficient shard, a pp stage): the per-slot layouts of ``parallel.tp``
and ``parallel.pp``; ``gather_shards`` turns a tree of them back into
global tensors.
"""

from __future__ import annotations

import math

import torch


class Mesh:
    """Slots over named axes: ``devices`` (one ``torch.device`` a slot, in
    row-major order over the axes), ``axis_names`` and ``shape``, an
    axis name -> size mapping, so ``mesh.shape[axis]`` reads as in JAX."""

    def __init__(self, devices, axis_names, sizes=None):
        self.devices = tuple(torch.device(d) for d in devices)
        self.axis_names = tuple(axis_names)
        sizes = (len(self.devices),) if sizes is None else tuple(sizes)
        if len(sizes) != len(self.axis_names):
            raise ValueError(f"{len(sizes)} sizes for axes {self.axis_names}")
        if math.prod(sizes) != len(self.devices):
            raise ValueError(
                f"mesh {sizes} needs {math.prod(sizes)} slots, got "
                f"{len(self.devices)}"
            )
        self.shape = dict(zip(self.axis_names, sizes))

    def axis_devices(self, axis_name: str) -> tuple:
        """The slots along ``axis_name`` at index 0 of every other axis:
        the devices a state sharded over that axis alone lives on (the
        JAX package replicates it over the other axes; one controller
        needs one copy)."""
        return tuple(row[0] for row in self.grid(axis_name, None))

    def grid(self, row_axis: str | None, col_axis: str | None) -> list:
        """``grid[i][j]``: the slot at index i of ``row_axis`` and j of
        ``col_axis`` and index 0 of every other axis (an axis of None
        counts as size 1).  The slots a 2-D layout such as (dp, tp) runs
        on; an axis left out is unused, its slots idle."""
        strides, stride = {}, 1
        for name in reversed(self.axis_names):
            strides[name] = stride
            stride *= self.shape[name]

        def walk(axis):
            if axis is None:
                return [0]
            if axis not in self.shape:
                raise ValueError(
                    f"axis {axis!r} not in mesh axes {self.axis_names}"
                )
            return [i * strides[axis] for i in range(self.shape[axis])]

        return [[self.devices[r + c] for c in walk(col_axis)]
                for r in walk(row_axis)]


class Shards:
    """One tensor split over the slots of a mesh axis: ``parts[j]``, on
    slot j's device, is the j-th piece along ``dim``.  ``shape`` and
    ``dtype`` are the whole tensor's, so layout rules written against
    global arrays read it unchanged; ``full()`` concatenates the pieces
    onto the first one's device."""

    def __init__(self, parts, dim: int):
        self.parts = list(parts)
        self.dim = dim

    @classmethod
    def split(cls, value: torch.Tensor, devices, dim: int) -> "Shards":
        """``value`` cut in ``len(devices)`` equal pieces along ``dim``,
        each a contiguous tensor of its own on its slot's device."""
        pieces = torch.chunk(value, len(devices), dim=dim)
        return cls([p.to(d, memory_format=torch.contiguous_format,
                         copy=True) for p, d in zip(pieces, devices)], dim)

    @property
    def shape(self) -> torch.Size:
        shape = list(self.parts[0].shape)
        shape[self.dim] = sum(p.shape[self.dim] for p in self.parts)
        return torch.Size(shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    def map(self, fn) -> "Shards":
        return Shards([fn(p) for p in self.parts], self.dim)

    def full(self) -> torch.Tensor:
        device = self.parts[0].device
        return torch.cat([p.to(device) for p in self.parts], dim=self.dim)


def tree_map(fn, tree):
    """``fn`` on every tensor and ``Shards`` leaf of a tree of dicts,
    lists and tuples; None and other leaves pass through."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if isinstance(tree, (torch.Tensor, Shards)):
        return fn(tree)
    return tree


def tree_tensors(tree) -> list:
    """Every tensor of a tree in order, a ``Shards`` leaf's parts in slot
    order."""
    out = []

    def visit(leaf):
        out.extend(leaf.parts if isinstance(leaf, Shards) else [leaf])
        return leaf

    tree_map(visit, tree)
    return out


def gather_shards(tree):
    """The same tree with every ``Shards`` leaf replaced by its whole
    tensor (``Shards.full``): a per-slot layout back to global tensors."""
    return tree_map(
        lambda v: v.full() if isinstance(v, Shards) else v, tree
    )


def device_count() -> int:
    """The number of CUDA cards (0 where there is none)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def _devices(n: int, devices) -> list:
    """The first ``n`` of ``devices``, or of the CUDA cards by default."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(device_count())]
    devices = [torch.device(d) for d in devices]
    if n > len(devices):
        raise ValueError(
            f"Requested {n} devices, only {len(devices)} available"
        )
    return devices[:n]


def make_mesh(n_devices: int | None = None, axis_name: str = "d",
              devices=None) -> Mesh:
    """A 1-D mesh over the first ``n_devices`` slots of ``devices`` (the
    CUDA cards by default; every one of them when ``n_devices`` is None).
    Raises when fewer are available, and on a machine without a card
    unless ``devices`` names CPU slots."""
    if n_devices is None:
        n_devices = len(devices) if devices is not None else device_count()
        if n_devices == 0:
            raise ValueError("no CUDA card: name the mesh's devices")
    return Mesh(_devices(n_devices, devices), (axis_name,))


def make_mesh_2d(shape: tuple[int, int],
                 axis_names: tuple[str, str] = ("dp", "sv"),
                 devices=None) -> Mesh:
    """A 2-D mesh, e.g. (data parallel, statevector shard)."""
    n = shape[0] * shape[1]
    try:
        slots = _devices(n, devices)
    except ValueError:
        raise ValueError(
            f"Mesh {shape} needs {n} devices, have "
            f"{device_count() if devices is None else len(devices)}"
        ) from None
    return Mesh(slots, axis_names, shape)


def shard_batch(x: torch.Tensor, mesh: Mesh, axis_name: str = "d") -> list:
    """Split the leading (batch) axis of ``x`` over the mesh axis: one
    piece a slot, on the slot's device (as ``jax.device_put`` with
    ``P(axis_name)``, the batch must divide evenly)."""
    slots = mesh.axis_devices(axis_name)
    if x.shape[0] % len(slots):
        raise ValueError(
            f"batch {x.shape[0]} does not divide over {len(slots)} slots"
        )
    return [piece.to(dev) for piece, dev in
            zip(torch.chunk(x, len(slots)), slots)]
