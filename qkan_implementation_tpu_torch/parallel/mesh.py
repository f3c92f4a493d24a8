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
        if axis_name not in self.shape:
            raise ValueError(
                f"axis {axis_name!r} not in mesh axes {self.axis_names}"
            )
        stride = 1
        for name in reversed(self.axis_names):
            if name == axis_name:
                break
            stride *= self.shape[name]
        return tuple(self.devices[i * stride]
                     for i in range(self.shape[axis_name]))


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
