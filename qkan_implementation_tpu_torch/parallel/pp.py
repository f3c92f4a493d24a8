"""Pipeline-parallel KAN layers: GPipe-style microbatching over a mesh's
``pp`` slots.

Counterpart of ``qkan_implementation_tpu.parallel.pp``, completing the
parallelism triad (dp in ``FixedKAN.train``, tp in ``parallel/tp.py``):
layers place on pipeline stages along a ``pp`` mesh axis and microbatches
stream through them.

- KAN layers after the first all map ``[B, T] -> [B, T]`` (every layer
  outputs ``target_dim``), so the activation between stages is a fixed
  ``[B_micro, T]`` tile.
- Stage parameters stack along a leading stage axis; layers with
  differing neuron counts pad ``out`` to the max with zero horizontal
  weights (exact: a padded neuron contributes ``hw = 0`` times its basis
  row).  A first layer whose ``in_dim`` differs from ``target_dim`` runs
  before the pipeline, on each dp row's first stage slot.
- The JAX ``lax.scan`` of ticks is a Python loop of ``M + S - 1`` ticks:
  inject microbatch ``t`` at stage 0, apply each stage's ``k`` layers on
  its slot, collect stage ``S-1``'s emission, move the activation ring one
  step with ``collectives.ppermute``.  A stage that holds no live
  microbatch at a tick passes its tile through without computing (the
  JAX scan computes on it and never collects the result).
- Autograd through the loop transposes every ``ppermute`` into its
  reverse move: the backward IS the reverse pipeline, with no
  hand-written 1F1B schedule.  As in ``parallel/tp.py``, each parameter
  has one master copy (a stage's on its pp slot, the lead layer's on
  slot 0) and autograd sums the gradients of its uses over dp rows.

``place_pipeline_params`` returns ``(lead, stacked)``: ``lead`` a dict of
tensors on slot 0 (or None) and ``stacked`` a dict of ``parallel.Shards``
over the pp slots, stage s's part ``[1, k, ...]`` on pp slot s;
``parallel.gather_shards`` gives the global ``[S, k, ...]`` tensors back.
"""

from __future__ import annotations

import torch

from qkan_implementation_tpu_torch.models import fixed_kan
from qkan_implementation_tpu_torch.models.fixed_kan import (
    _INT8_RECIPES,
    _compute_dtype,
)
from qkan_implementation_tpu_torch.parallel.collectives import ppermute
from qkan_implementation_tpu_torch.parallel.mesh import Mesh, Shards
from qkan_implementation_tpu_torch.parallel.tp import (
    _check_rows,
    _global_mse,
    _local,
    _resolve_axes,
    _sgd_step,
)

_KEYS = ("degrees", "coefficients", "horizontal_weights")


def stack_pipeline_params(params: list, n_stages: int):
    """Split layers into ``n_stages`` contiguous stages and stack.

    Returns ``(lead, stacked)``: ``lead`` is ``params[0]`` when its
    ``in_dim`` differs from ``target_dim`` (runs before the pipeline),
    else ``None``; ``stacked`` is a dict of tensors with leading axes
    ``[n_stages, k, ...]`` (``k`` layers per stage), neuron counts padded
    to the max with ``horizontal_weights = 0``.
    """
    t_dim = params[0]["coefficients"].shape[3]
    lead = None
    body = params
    if params[0]["coefficients"].shape[1] != t_dim:
        lead, body = params[0], params[1:]
    for lp in body:
        if lp["coefficients"].shape[1] != t_dim:
            raise ValueError(
                "pipeline body layers must map [B, target_dim] -> "
                f"[B, target_dim]; got in_dim "
                f"{lp['coefficients'].shape[1]} != {t_dim}"
            )
    if not body or len(body) % n_stages != 0:
        raise ValueError(
            f"{len(body)} pipeline layers do not split over "
            f"{n_stages} stages"
        )
    k = len(body) // n_stages
    max_out = max(lp["coefficients"].shape[0] for lp in body)

    def pad(v):
        pad_rows = max_out - v.shape[0]
        return torch.cat([v, v.new_zeros((pad_rows,) + v.shape[1:])])

    return lead, {
        key: torch.stack([pad(lp[key]) for lp in body]).reshape(
            (n_stages, k, max_out) + body[0][key].shape[1:]
        )
        for key in _KEYS
    }


def _apply_stage(stage, x, max_degree, compute_dtype):
    """Apply one stage's k layers (``stage``: [k, ...] leaves)."""
    for layer in range(stage["coefficients"].shape[0]):
        lp = {key: v[layer] for key, v in stage.items()}
        x = fixed_kan.kan_layer_apply(lp, x, max_degree, compute_dtype)
    return x


def _pipeline_local(stacked, x, max_degree, microbatches, devices,
                    compute_dtype):
    """One dp row's pipeline over its pp slots ``devices``: [b, T] ->
    [b, T] on the first slot."""
    n_pp = len(devices)
    b = x.shape[0]
    if b % microbatches != 0:
        raise ValueError(
            f"local batch {b} not divisible by microbatches={microbatches}"
        )
    stages = [{key: _local(v, s, n_pp, 0, dev)[0]
               for key, v in stacked.items()}
              for s, dev in enumerate(devices)]
    xm = torch.chunk(x, microbatches)
    ring = [(s, (s + 1) % n_pp) for s in range(n_pp)]
    state = [xm[0].new_zeros(xm[0].shape).to(dev) for dev in devices]
    outs = []
    for t in range(microbatches + n_pp - 1):
        if t < microbatches:
            state[0] = xm[t].to(devices[0])
        # stage s holds microbatch t - s; an idle stage passes its tile on
        ys = [_apply_stage(stage, state[s], max_degree, compute_dtype)
              if 0 <= t - s < microbatches else state[s]
              for s, stage in enumerate(stages)]
        if t >= n_pp - 1:
            outs.append(ys[-1].to(devices[0]))
        state = ppermute(ys, ring)
    return torch.cat(outs)


def _forward_rows(lead, stacked, x, max_degree, mesh, dp_axis, pp_axis,
                  microbatches, compute_dtype) -> list:
    """Each dp row's pipeline over its slice of the batch: the [b, T]
    outputs, row i's on its first slot."""
    outs = []
    for xb, devices in zip(torch.chunk(x, mesh.shape.get(dp_axis, 1)),
                           mesh.grid(dp_axis, pp_axis)):
        cur = xb.to(devices[0])
        if lead is not None:
            cur = fixed_kan.kan_layer_apply(
                {k: v.to(devices[0]) for k, v in lead.items()}, cur,
                max_degree, compute_dtype,
            )
        outs.append(_pipeline_local(stacked, cur, max_degree, microbatches,
                                    devices, compute_dtype))
    return outs


def kan_apply_pp(
    params,
    x: torch.Tensor,
    max_degree: int,
    mesh: Mesh,
    microbatches: int = 4,
    pp_axis: str = "pp",
    dp_axis: str | None = "auto",
    compute_dtype=None,
) -> torch.Tensor:
    """Pipeline-parallel forward: [B, in] -> [B, target_dim] on slot 0.

    Layers place over ``mesh``'s ``pp_axis`` (contiguous stages); the
    batch additionally splits over ``dp_axis`` if present (``'auto'``
    picks a ``'dp'`` mesh axis when there is one), each dp row running
    its own microbatch stream.  Equals ``kan_apply`` exactly.

    ``params`` is either the plain layer list (stacked per call) or a
    ``(lead, stacked)`` pair from ``place_pipeline_params`` /
    ``stack_pipeline_params``.
    """
    n_pp, dp_axis = _resolve_axes(mesh, pp_axis, dp_axis)
    if isinstance(params, tuple):
        lead, stacked = params
        if stacked["coefficients"].shape[0] != n_pp:
            raise ValueError(
                f"stacked params carry {stacked['coefficients'].shape[0]} "
                f"stages, mesh axis {pp_axis!r} has {n_pp}"
            )
    else:
        lead, stacked = stack_pipeline_params(params, n_pp)
    _check_rows(x, mesh, dp_axis)
    outs = _forward_rows(lead, stacked, x, max_degree, mesh, dp_axis,
                         pp_axis, microbatches, compute_dtype)
    return torch.cat([o.to(mesh.devices[0]) for o in outs])


def make_pp_train_step(
    mesh: Mesh,
    max_degree: int,
    learning_rate: float = 1e-3,
    microbatches: int = 4,
    pp_axis: str = "pp",
    dp_axis: str | None = "auto",
    compute_dtype=None,
):
    """An SGD train step with pipeline (+ optional data) parallelism.

    Returns ``step(lead_train, lead_degrees, stacked_train,
    stacked_degrees, x, y) -> ((lead_train, stacked_train), loss)`` where
    ``stacked_*`` come from ``stack_pipeline_params`` /
    ``place_pipeline_params`` split into trainable leaves and integer
    degrees (``lead_*`` may be ``None``); the layouts are kept.  The
    backward pipeline is autograd through the forward's ppermutes (module
    docstring).
    """
    if _compute_dtype(compute_dtype) in _INT8_RECIPES:
        # same guard as FixedKAN.train: the rounded int8 operands have
        # zero gradient, so "training" through them applies garbage updates
        raise ValueError("int8 rounding has zero gradient; use bf16")
    n_pp, dp_axis = _resolve_axes(mesh, pp_axis, dp_axis)

    def step(lead_train, lead_degrees, stacked_train, stacked_degrees, x, y):
        _check_rows(x, mesh, dp_axis)

        def loss_of(args):
            lead_t, stacked_t = args
            lead = None if lead_t is None else dict(lead_t,
                                                    degrees=lead_degrees)
            stacked = dict(stacked_t, degrees=stacked_degrees)
            preds = _forward_rows(lead, stacked, x, max_degree, mesh,
                                  dp_axis, pp_axis, microbatches,
                                  compute_dtype)
            return _global_mse(preds, y)

        return _sgd_step(loss_of, (lead_train, stacked_train),
                         learning_rate)

    return step


def place_pipeline_params(
    params: list,
    mesh: Mesh,
    pp_axis: str = "pp",
    dp_axis: str | None = "auto",
):
    """``stack_pipeline_params`` laid out over the slots: ``stacked`` as
    ``Shards`` over the pp slots (stage s's layers on pp slot s), ``lead``
    on slot 0 (module docstring); feed the pair straight to
    ``kan_apply_pp``."""
    n_pp, _ = _resolve_axes(mesh, pp_axis, dp_axis)
    lead, stacked = stack_pipeline_params(params, n_pp)
    slots = mesh.axis_devices(pp_axis)
    stacked = {k: Shards.split(v, slots, 0) for k, v in stacked.items()}
    if lead is not None:
        lead = {k: v.to(mesh.devices[0]) for k, v in lead.items()}
    return lead, stacked
