"""Mesh construction, named collectives, and tensor- and pipeline-parallel
FixedKAN, single-controller.

Counterpart of ``qkan_implementation_tpu.parallel``: a ``Mesh`` of slots
(torch devices, several of which may be one card), the collective set
over the list of per-slot tensors of a mesh axis, ``Shards`` (a tensor
split over an axis' slots) with ``gather_shards``, and the tp / pp layers
and train steps (``tp.py``, ``pp.py``).
"""

from typing import TYPE_CHECKING

from qkan_implementation_tpu_torch.parallel.mesh import (
    Mesh,
    Shards,
    gather_shards,
    make_mesh,
    make_mesh_2d,
    device_count,
    shard_batch,
)
from qkan_implementation_tpu_torch.parallel.collectives import (
    psum,
    pmean,
    all_gather,
    ppermute,
    all_to_all,
    pairwise_exchange,
    pairwise_exchange_a2a,
)

# tp and pp build on models.fixed_kan, whose package imports the simulator,
# which imports the collectives above: their names load on first use, so
# importing any module of the package first keeps working
if TYPE_CHECKING:
    from qkan_implementation_tpu_torch.parallel.tp import (
        kan_apply_tp,
        make_tp_train_step,
        shard_params,
    )
    from qkan_implementation_tpu_torch.parallel.pp import (
        kan_apply_pp,
        make_pp_train_step,
        place_pipeline_params,
        stack_pipeline_params,
    )

_LAZY = {
    "kan_apply_tp": "tp",
    "make_tp_train_step": "tp",
    "shard_params": "tp",
    "kan_apply_pp": "pp",
    "make_pp_train_step": "pp",
    "place_pipeline_params": "pp",
    "stack_pipeline_params": "pp",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module = importlib.import_module(f"{__name__}.{_LAZY[name]}")
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_LAZY))


__all__ = [
    "kan_apply_tp",
    "make_tp_train_step",
    "shard_params",
    "kan_apply_pp",
    "make_pp_train_step",
    "place_pipeline_params",
    "stack_pipeline_params",
    "Mesh",
    "Shards",
    "gather_shards",
    "make_mesh",
    "make_mesh_2d",
    "device_count",
    "shard_batch",
    "psum",
    "pmean",
    "all_gather",
    "ppermute",
    "all_to_all",
    "pairwise_exchange",
    "pairwise_exchange_a2a",
]
