"""Mesh construction and named collectives, single-controller.

Counterpart of ``qkan_implementation_tpu.parallel``: a ``Mesh`` of slots
(torch devices, several of which may be one card) and the collective set
over the list of per-slot tensors of a mesh axis.  Tensor- and
pipeline-parallel FixedKAN (``tp.py``, ``pp.py``) are not ported yet:
their functions raise (ROADMAP.md, Queue 1: the rest of the multi-device slice).
"""

from qkan_implementation_tpu_torch.parallel.mesh import (
    Mesh,
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


def _not_ported(name: str):
    def stub(*args, **kwargs):
        raise NotImplementedError(
            f"{name} is not ported to the torch package yet (ROADMAP.md, "
            "Queue 1: the rest of the multi-device slice: tensor- and "
            "pipeline-parallel FixedKAN)"
        )

    stub.__name__ = name
    return stub


kan_apply_tp = _not_ported("kan_apply_tp")
make_tp_train_step = _not_ported("make_tp_train_step")
shard_params = _not_ported("shard_params")
kan_apply_pp = _not_ported("kan_apply_pp")
make_pp_train_step = _not_ported("make_pp_train_step")
place_pipeline_params = _not_ported("place_pipeline_params")
stack_pipeline_params = _not_ported("stack_pipeline_params")

__all__ = [
    "kan_apply_tp",
    "make_tp_train_step",
    "shard_params",
    "kan_apply_pp",
    "make_pp_train_step",
    "place_pipeline_params",
    "stack_pipeline_params",
    "Mesh",
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
