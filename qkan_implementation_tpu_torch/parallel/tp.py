"""Tensor-parallel KAN layers: row parallelism over a mesh's ``tp`` slots.

Counterpart of ``qkan_implementation_tpu.parallel.tp``.  A layer's
forward is one contraction ``[B, in*(D+1)] @ [in*(D+1), T]``; its natural
split is the input-feature (row) dimension:

- input features and the coefficients' ``in`` axis shard over ``tp``;
  tanh and the Chebyshev basis are elementwise in the features, so they
  stay on the shard's slot;
- each slot computes a partial ``[B, T]`` product from its feature slice
  and a ``psum`` over the tp slots completes it.  When the NEXT layer is
  sharded too the reduction is a psum-scatter over the output's T axis
  (``_psum_scatter``): each slot keeps its slice of the next layer's
  input;
- a layer whose ``in_dim`` does not divide the tp axis runs replicated
  (static per layer, ``_tp_layer_flags``); where its output feeds a
  sharded layer each slot takes its slice.

Composes with data parallelism on a 2-D ``(dp, tp)`` mesh: the batch
splits over ``dp``, one tp group (a row of ``Mesh.grid``) per dp index.

The JAX package runs one program per device under ``shard_map`` and lets
its vma-aware transpose insert the gradient psums.  Here one controller
walks every slot (``Mesh.grid``) and keeps ONE master copy of each
parameter: a tp shard on its slot of the tp axis
(``mesh.axis_devices('tp')``), every replicated leaf on slot 0.  A slot
takes its copy with ``Tensor.to(slot_device)`` (no copy at all when the
slots share a card), so autograd sums each leaf's gradient over the slots
that used it: that sum IS the psum the JAX transpose inserts, and none is
added by hand (the JAX module records an 8x double count from doing so).
A replicated layer runs once a tp group, on its first slot: every slot
of the group holds the same input, so the result is the same.

Layouts: ``shard_params`` returns the params list with each sharded
layer's ``coefficients`` as a ``parallel.Shards`` (``parts[j]``:
``[out, in / n_tp, D+1, T]`` on tp slot j, split along dim 1) and every
other leaf a tensor on slot 0; ``parallel.gather_shards`` turns such a
tree back into global tensors.  Every function here also takes plain
global tensors, which it slices per slot as it goes.
"""

from __future__ import annotations

import warnings

import torch

from qkan_implementation_tpu_torch.models import fixed_kan
from qkan_implementation_tpu_torch.models.fixed_kan import (
    _FORWARD_PRECISION_MIN_FANIN,
    _INT8_RECIPES,
    _compute_dtype,
    _resolve_forward_precision,
)
from qkan_implementation_tpu_torch.parallel.collectives import psum
from qkan_implementation_tpu_torch.parallel.mesh import (
    Mesh,
    Shards,
    tree_map,
    tree_tensors,
)


def _tp_layer_flags(params: list, n_tp: int, x_dim: int) -> list[bool]:
    """Static per-layer decision: shard the ``in`` axis over tp?"""
    flags = []
    in_dim = x_dim
    for lp in params:
        c_in = lp["coefficients"].shape[1]
        if c_in != in_dim:
            raise ValueError(
                f"layer expects in_dim={c_in}, previous layer produces "
                f"{in_dim}"
            )
        flags.append(n_tp > 1 and in_dim % n_tp == 0)
        in_dim = lp["coefficients"].shape[3]  # every layer outputs target_dim
    return flags


def _param_specs(params: list, flags: list[bool], tp_axis: str) -> list:
    """Layout of each leaf, matching ``params``: None (replicated, the
    master on slot 0) or ``(axis, dim)`` (split along ``dim`` over
    ``axis``).  Degrees and horizontal weights are replicated."""
    specs = []
    for lp, sharded in zip(params, flags):
        spec = {k: None for k in lp}
        if sharded:
            spec["coefficients"] = (tp_axis, 1)
        specs.append(spec)
    return specs


def _place(value, spec, mesh: Mesh):
    """One global tensor under its spec: a ``Shards`` over the spec's
    axis, or a tensor on slot 0."""
    if spec is None:
        return value.to(mesh.devices[0])
    axis, dim = spec
    return Shards.split(value, mesh.axis_devices(axis), dim)


def _local(value, j: int, n: int, dim: int, device):
    """Slot j's piece (of n along ``dim``) of a ``Shards`` or a global
    tensor, on ``device``."""
    if isinstance(value, Shards):
        return value.parts[j].to(device)
    return torch.chunk(value, n, dim=dim)[j].to(device)


def _psum_scatter(ys: list) -> list:
    """Reduce-scatter over the slots along the output's T axis: slot j
    gets the j-th slice of the sum (``jax.lax.psum_scatter`` with
    ``scatter_dimension=1, tiled=True``)."""
    n = len(ys)
    return [torch.chunk(s, n, dim=1)[j] for j, s in enumerate(psum(ys))]


def _forward_local(
    params, xs, max_degree, flags, devices, compute_dtype,
    matmul_precision="auto",
):
    """One tp group's forward: ``xs[j]`` is tp slot j's input (its
    feature slice where ``flags[0]``, else ``xs[0]`` the whole rows);
    returns the [b, T] output on ``devices[0]``.

    The fan-in-aware precision policy is resolved against the GLOBAL
    contraction width, not the shard's: the flagship's layer 0 on 8 tp
    slots sees 98 local features of a 4704-term contraction, and deciding
    on the local width would drop the 'high' pin.
    """
    n_tp = len(devices)
    cur = xs
    for i, (lp, sharded) in enumerate(zip(params, flags)):
        fan_in_global = lp["coefficients"].shape[1] * (max_degree + 1)
        prec = _resolve_forward_precision(matmul_precision, fan_in_global)
        next_sharded = i + 1 < len(params) and flags[i + 1]
        if sharded:
            ys = []
            for j, dev in enumerate(devices):
                local = {k: (_local(v, j, n_tp, 1, dev)
                             if k == "coefficients" else v.to(dev))
                         for k, v in lp.items()}
                ys.append(fixed_kan.kan_layer_apply(
                    local, cur[j], max_degree, compute_dtype,
                    matmul_precision=prec,
                ))
            cur = _psum_scatter(ys) if next_sharded else psum(ys)
        else:
            local = {k: v.to(devices[0]) for k, v in lp.items()}
            y = fixed_kan.kan_layer_apply(
                local, cur[0], max_degree, compute_dtype,
                matmul_precision=prec,
            )
            # replicated output feeding a sharded layer: each slot its slice
            cur = ([p.to(d) for p, d in zip(torch.chunk(y, n_tp, dim=1),
                                            devices)]
                   if next_sharded else [y])
    return cur[0]


def _resolve_axes(mesh: Mesh, tp_axis: str, dp_axis: str | None):
    """Validate the mesh against the requested axes.

    ``dp_axis='auto'`` resolves to ``'dp'`` when the mesh carries one
    (and to ``None`` on a pure-tp/pp mesh), so the default works on both
    1-D and 2-D meshes; an EXPLICIT missing axis still raises.
    Returns ``(model_axis_size, dp_axis)``.
    """
    if dp_axis == "auto":
        dp_axis = "dp" if "dp" in mesh.axis_names else None
    if tp_axis not in mesh.axis_names:
        raise ValueError(
            f"mesh has axes {mesh.axis_names}, no model axis {tp_axis!r}"
        )
    if dp_axis is not None and dp_axis not in mesh.axis_names:
        raise ValueError(
            f"mesh has axes {mesh.axis_names}, no dp axis {dp_axis!r}"
        )
    extra = set(mesh.axis_names) - {tp_axis, dp_axis}
    if extra:
        raise ValueError(
            f"unused mesh axes {sorted(extra)}: these paths shard over "
            f"(dp, {tp_axis!r}) only"
        )
    return mesh.shape[tp_axis], dp_axis


def _forward_rows(params, x, max_degree, mesh, dp_axis, tp_axis, flags,
                  compute_dtype, matmul_precision) -> list:
    """The forward of each dp row's tp group over its slice of the batch:
    a list of [b / n_dp, T] outputs, row i's on its first slot.  An axis
    of None counts as size 1."""
    grid = mesh.grid(dp_axis, tp_axis)
    n_tp = len(grid[0])
    outs = []
    for xb, devices in zip(torch.chunk(x, len(grid)), grid):
        xs = ([_local(xb, j, n_tp, 1, d) for j, d in enumerate(devices)]
              if flags[0] else [xb.to(devices[0])])
        outs.append(_forward_local(params, xs, max_degree, flags, devices,
                                   compute_dtype, matmul_precision))
    return outs


def _check_rows(x, mesh: Mesh, dp_axis: str | None) -> None:
    if dp_axis is not None and x.shape[0] % mesh.shape[dp_axis] != 0:
        raise ValueError(
            f"batch {x.shape[0]} not divisible by dp axis "
            f"{mesh.shape[dp_axis]}"
        )


def kan_apply_tp(
    params: list,
    x: torch.Tensor,
    max_degree: int,
    mesh: Mesh,
    tp_axis: str = "tp",
    dp_axis: str | None = "auto",
    compute_dtype=None,
    matmul_precision: str | None = "auto",
) -> torch.Tensor:
    """Tensor-parallel forward: [B, in] -> [B, target_dim] on slot 0.

    ``mesh`` must carry ``tp_axis`` (and ``dp_axis`` if given; the batch
    then splits over it).  ``params``: global tensors or ``shard_params``'
    layout.  Equals ``kan_apply`` up to reduction order in float dtypes.
    ``compute_dtype=int8`` is the one exception: each slot quantizes its
    own row slice of W, so outputs drift from single-slot int8.
    """
    n_tp, dp_axis = _resolve_axes(mesh, tp_axis, dp_axis)
    flags = _tp_layer_flags(params, n_tp, x.shape[1])
    if _compute_dtype(compute_dtype) == "int8":
        # kan_layer_apply's warning checks the LOCAL shard's W rows, which
        # an n_tp-way shard can pull below the threshold while the psum'd
        # contraction is still global-wide: warn on the GLOBAL fan-in here
        for lp in params:
            fan_in_global = lp["coefficients"].shape[1] * (max_degree + 1)
            if fan_in_global >= _FORWARD_PRECISION_MIN_FANIN:
                warnings.warn(
                    f"int8 tp serving at GLOBAL fan-in {fan_in_global} >= "
                    f"{_FORWARD_PRECISION_MIN_FANIN}: quantization noise "
                    "at this contraction width measured CHANCE accuracy "
                    "on the flagship shape; use compute_dtype=None",
                    stacklevel=2,
                )
                break
    _check_rows(x, mesh, dp_axis)
    outs = _forward_rows(params, x, max_degree, mesh, dp_axis, tp_axis,
                         flags, compute_dtype, matmul_precision)
    return torch.cat([o.to(mesh.devices[0]) for o in outs])


def _sgd_step(loss_of, train_params, learning_rate: float):
    """``(params - lr * grad, loss)`` of ``loss_of(params)`` over every
    tensor of the tree: each leaf a fresh autograd leaf, so the gradient
    of a leaf used on several slots is their sum."""
    params = tree_map(
        lambda v: v.map(lambda p: p.detach().requires_grad_())
        if isinstance(v, Shards) else v.detach().requires_grad_(),
        train_params,
    )
    leaves = tree_tensors(params)
    loss = loss_of(params)
    grads = iter(torch.autograd.grad(loss, leaves))

    def update(p):
        return (p - learning_rate * next(grads)).detach()

    new = tree_map(
        lambda v: v.map(update) if isinstance(v, Shards) else update(v),
        params,
    )
    return new, loss.detach()


def _global_mse(preds: list, y: torch.Tensor) -> torch.Tensor:
    """Mean squared error over the whole batch from the dp rows' outputs:
    each row's sum of squares on its slot, summed in row order on the
    first row's slot."""
    dev = preds[0].device
    sse = sum(torch.sum((p - yb.to(p.device)) ** 2).to(dev)
              for p, yb in zip(preds, torch.chunk(y, len(preds))))
    return sse / (y.shape[0] * y.shape[1])


def make_tp_train_step(
    mesh: Mesh,
    max_degree: int,
    learning_rate: float = 1e-3,
    tp_axis: str = "tp",
    dp_axis: str | None = "auto",
    compute_dtype=None,
    matmul_precision: str | None = "auto",
):
    """An SGD train step over the (dp, tp) mesh.

    Returns ``step(train_params, degrees, x, y) -> (new_params, loss)``
    where ``train_params`` is the params list WITHOUT the integer
    ``degrees`` leaves (passed alongside), global tensors or laid out by
    ``shard_params``; ``new_params`` keeps the layout.  Loss is the global
    MSE; the gradient sums over dp and tp come from autograd over the
    master copies (module docstring).
    """
    if _compute_dtype(compute_dtype) in _INT8_RECIPES:
        # same guard as FixedKAN.train: the rounded int8 operands have
        # zero gradient, so "training" through them applies garbage updates
        raise ValueError("int8 rounding has zero gradient; use bf16")

    def step(train_params, degrees, x, y):
        n_tp, dp_ax = _resolve_axes(mesh, tp_axis, dp_axis)
        full = [dict(tp_, degrees=d) for tp_, d in zip(train_params, degrees)]
        flags = _tp_layer_flags(full, n_tp, x.shape[1])
        _check_rows(x, mesh, dp_ax)

        def loss_of(tps):
            full = [dict(tp_, degrees=d) for tp_, d in zip(tps, degrees)]
            preds = _forward_rows(full, x, max_degree, mesh, dp_ax, tp_axis,
                                  flags, compute_dtype, matmul_precision)
            return _global_mse(preds, y)

        return _sgd_step(loss_of, train_params, learning_rate)

    return step


def shard_params(
    params: list,
    x_dim: int,
    mesh: Mesh,
    tp_axis: str = "tp",
    dp_axis: str | None = "auto",
) -> list:
    """The params under their tp layout: the coefficients of divisible
    layers as ``Shards`` over ``tp`` (split along the ``in`` axis), every
    other leaf on slot 0 (module docstring)."""
    n_tp, _ = _resolve_axes(mesh, tp_axis, dp_axis)
    flags = _tp_layer_flags(params, n_tp, x_dim)
    specs = _param_specs(params, flags, tp_axis)
    return [
        {k: _place(v, spec[k], mesh) for k, v in lp.items()}
        for lp, spec in zip(params, specs)
    ]
