"""FixedKAN forward, gradient training and checkpoints on torch tensors.

Counterpart of ``qkan_implementation_tpu.models.fixed_kan``, cut to the
serving and training paths: the config with its presets, the forward
precision policy, ``kan_layer_apply`` / ``kan_apply`` on the ``'xla'``
fold and the ``'fused'`` / ``'fused_dw'`` kernel backends, ``train`` and
``train_horizontal_weights`` (Adam with per-group clipping, fan-in
learning rates and the cosine schedule of the JAX package's optax chain,
``models._optim``), and the npz checkpoint format, which stays
byte-compatible with the JAX package so a model saved by either loads in
the other.  Structure search (``optimize``), ``analyze_network`` and
``visualize_analysis`` are not ported yet (ROADMAP.md queue 1).

Parameters are a list of per-layer dicts, as in the JAX package:
``degrees [out]`` (int), ``coefficients [out, in, D+1, T]`` and
``horizontal_weights [out]``.  ``FixedKAN`` keeps them as module buffers.
"""

from __future__ import annotations

import json
import logging
from dataclasses import asdict, dataclass
from typing import List, Optional

import numpy as np
import torch
from torch import nn

from qkan_implementation_tpu_torch.models._optim import AdamGroup
from qkan_implementation_tpu_torch.ops.chebyshev import chebyshev_basis
from qkan_implementation_tpu_torch.ops.fused_layer import (
    kan_layer_fused,
    kan_layer_fused_dw,
)
from qkan_implementation_tpu_torch.utils.convert import (
    params_from_numpy,
    params_to_numpy,
)
from qkan_implementation_tpu_torch.utils.platform import resolve_device


@dataclass
class FixedKANConfig:
    """Configuration for the fixed-architecture KAN.

    The same fields, defaults and presets as the JAX package's
    ``FixedKANConfig``: its JSON form is what checkpoints carry, so the
    two must not diverge.  ``layer_backend`` 'xla' is the plain fold +
    matmul; 'fused' and 'fused_dw' run the v1 and degree-wise CUDA
    kernels on the card.
    """

    network_shape: List[int]
    max_degree: int
    complexity_weight: float = 0.1
    consistent_tanh: bool = False
    degree_objective: str = "reference"
    lstsq_method: str = "svd"
    lstsq_ridge: float = 1e-8
    quantum_sample_cap: int = 256
    compute_dtype: Optional[str] = None
    layer_backend: str = "xla"
    forward_matmul_precision: Optional[str] = "auto"

    PRESETS = {
        "reference": {},
        "recommended": {
            "consistent_tanh": True,
            "degree_objective": "penalized_mse",
            "lstsq_method": "normal",
        },
    }

    TRAIN_PRESETS = {
        "reference": {
            "trainable": "horizontal",
            "lr_scale": "none",
            "lr_schedule": "none",
            "grad_clip": None,
        },
        "recommended": {
            "trainable": "all",
            "lr_scale": "fanin",
            "lr_schedule": "cosine",
            "grad_clip": 1.0,
            "learning_rate": 0.002,
            "epochs": 30,
        },
    }

    @classmethod
    def preset(
        cls, name: str, network_shape: List[int], max_degree: int, **overrides
    ) -> "FixedKANConfig":
        """Build a config from a named preset; explicit overrides win."""
        if name not in cls.PRESETS:
            raise ValueError(
                f"Unknown preset {name!r}; choose from {sorted(cls.PRESETS)}"
            )
        kwargs = {**cls.PRESETS[name], **overrides}
        return cls(
            network_shape=network_shape, max_degree=max_degree, **kwargs
        )


# Fan-in threshold of the forward precision policy (JAX package,
# fixed_kan.py:307-315): layers whose contraction width in*(D+1) reaches
# it get 'high'.  On the card 'high' is true FP32 (TF32 off).
_FORWARD_PRECISION_MIN_FANIN = 512

# compute_dtype recipes that need ops/qkan_layer.py, not ported yet
_INT8_RECIPES = ("int8", "int8x2", "int8x2w")


def _resolve_forward_precision(matmul_precision, fan_in: int):
    if matmul_precision == "auto":
        return (
            "high" if fan_in >= _FORWARD_PRECISION_MIN_FANIN else None
        )
    return matmul_precision


def _compute_dtype(compute_dtype):
    """None, an int8 recipe name, or a torch dtype, from a name or dtype."""
    if compute_dtype is None or compute_dtype in _INT8_RECIPES:
        return compute_dtype
    if compute_dtype == torch.int8:
        return "int8"
    if isinstance(compute_dtype, torch.dtype):
        return compute_dtype
    dtype = getattr(torch, str(compute_dtype), None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown compute_dtype {compute_dtype!r}")
    return "int8" if dtype == torch.int8 else dtype


def _check_fp32_matmul(a2d: torch.Tensor) -> None:
    """'high'/'highest' promise true FP32 products.  torch leaves TF32 off
    for CUDA matmuls by default; refuse to run if the caller turned it on,
    rather than flip the process-wide switch under other threads."""
    if a2d.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "matmul_precision 'high'/'highest' needs TF32 off: set "
            "torch.backends.cuda.matmul.allow_tf32 = False"
        )


def _dot_f32(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Low-precision operands, f32 accumulation.  Widened bf16 values
    multiply exactly in f32 and in TF32 alike, so TF32 may stay on."""
    return p.to(torch.float32) @ q.to(torch.float32)


def _xla_matmul(a2d, W, prec):
    """The 'xla' backend's f32/f64 layer product under a precision name."""
    if prec in ("bf16x2_w", "bf16x2_x"):
        # manual two-pass bf16: split ONE operand into a bf16 value and a
        # bf16 residual, keep the other at plain bf16 (fixed_kan.py:459-482)
        split, keep = (W, a2d) if prec == "bf16x2_w" else (a2d, W)
        hi = split.to(torch.bfloat16)
        lo = (split - hi.to(split.dtype)).to(torch.bfloat16)
        kb = keep.to(torch.bfloat16)
        if prec == "bf16x2_w":
            return _dot_f32(kb, hi) + _dot_f32(kb, lo)
        return _dot_f32(hi, kb) + _dot_f32(lo, kb)
    dtype = torch.promote_types(a2d.dtype, W.dtype)
    a2d, W = a2d.to(dtype), W.to(dtype)
    if prec in ("high", "highest"):
        _check_fp32_matmul(a2d)
        return a2d @ W
    if prec in (None, "default"):
        return a2d @ W
    raise ValueError(
        f"unknown matmul_precision {prec!r}: None, 'auto', 'default', "
        "'high', 'highest', 'bf16x2_w' or 'bf16x2_x'"
    )


def kan_layer_apply(
    layer_params: dict,
    x: torch.Tensor,
    max_degree: int,
    compute_dtype=None,
    backend: str = "xla",
    matmul_precision: str | None = "auto",
) -> torch.Tensor:
    """Apply one KAN layer: [B, in] -> [B, target_dim].

    y = sum_o hw_o * (cumulative_transform(tanh(x))[<=d_o] @ C_o), folded
    over ``o`` into one [in*(D+1), T] weight.  ``backend='xla'`` folds it
    dim-major and multiplies the materialized basis; ``'fused'`` and
    ``'fused_dw'`` fold it degree-major and run
    ``ops.fused_layer.kan_layer_fused`` / ``kan_layer_fused_dw`` (the CUDA
    kernels on the card), whose output is float32.  ``'fused'`` takes x
    as it is (or in ``compute_dtype``) and ignores ``matmul_precision``,
    as the JAX package's v1 kernel does.

    ``matmul_precision``: 'auto' gives 'high' at fan-in >= 512 and the
    device default below; 'high'/'highest' are true FP32 (TF32 off);
    'bf16x2_w'/'bf16x2_x' are the manual two-pass bf16 split.
    ``compute_dtype=torch.bfloat16`` casts the final product's operands
    to bf16 ('xla') or selects the kernel's 'bf16' mode ('fused_dw').
    """
    if backend not in ("xla", "fused", "fused_dw"):
        raise ValueError(
            f"unknown backend {backend!r}: expected 'xla', 'fused', or "
            "'fused_dw'"
        )
    compute_dtype = _compute_dtype(compute_dtype)
    degs = layer_params["degrees"]  # [out]
    coeffs = layer_params["coefficients"]  # [out, in, D+1, T]
    hw = layer_params["horizontal_weights"]  # [out]
    mask = (
        torch.arange(max_degree + 1, device=degs.device)[None, :]
        <= degs[:, None]
    )  # [out, D+1]
    scale = mask.to(coeffs.dtype) * hw[:, None].to(coeffs.dtype)
    if backend in ("fused", "fused_dw"):
        if compute_dtype in _INT8_RECIPES:
            raise ValueError(
                f"backend={backend!r} has no int8 path; use backend='xla'"
            )
        # degree-major [dp1*in, T] fold for the kernel's basis layout
        w_dm = torch.einsum("oidt,od->dit", coeffs, scale).reshape(
            -1, coeffs.shape[-1]
        ).to(torch.float32).contiguous()
        if backend == "fused":
            xin = x if compute_dtype is None else x.to(compute_dtype)
            return kan_layer_fused(xin.contiguous(), w_dm, max_degree + 1)
        if compute_dtype == torch.bfloat16:
            prec = "bf16"
        else:
            prec = _resolve_forward_precision(
                matmul_precision, w_dm.shape[0]
            ) or "default"
            # xla-only multi-pass names map to the kernel's nearest mode
            prec = {
                "highest": "high", "bf16x2_w": "high", "bf16x2_x": "high",
            }.get(prec, prec)
        # the kernel runs tanh + recurrence in x's dtype: bf16 mode takes
        # a bf16 x, the others an f32 x
        xin = x.to(torch.bfloat16 if prec == "bf16" else torch.float32)
        return kan_layer_fused_dw(
            xin.contiguous(), w_dm, max_degree + 1, True, prec
        )
    if compute_dtype in _INT8_RECIPES:
        raise NotImplementedError(
            f"compute_dtype={compute_dtype!r} needs the int8 matmuls of "
            "ops/qkan_layer.py, not ported yet (ROADMAP.md queue 1)"
        )
    t = torch.tanh(x)
    basis = chebyshev_basis(t, max_degree, clip=False)  # [B, in, D+1]
    b = x.shape[0]
    # dim-major fold: sum over o collapses the layer to ONE
    # [B, in*(D+1)] @ [in*(D+1), T] product
    W = torch.einsum("oidt,od->idt", coeffs, scale).reshape(
        -1, coeffs.shape[-1]
    )
    a2d = basis.reshape(b, -1)
    if compute_dtype is None:
        prec = _resolve_forward_precision(matmul_precision, W.shape[0])
        return _xla_matmul(a2d, W, prec)
    # bf16io: cast the final product's operands, accumulate in f32
    return _dot_f32(a2d.to(compute_dtype), W.to(compute_dtype))


def kan_apply(
    params: list,
    x: torch.Tensor,
    max_degree: int,
    compute_dtype=None,
    backend: str = "xla",
    matmul_precision: str | None = "auto",
) -> torch.Tensor:
    """Full forward pass through all layers."""
    current = x
    for layer_params in params:
        current = kan_layer_apply(
            layer_params, current, max_degree, compute_dtype, backend,
            matmul_precision,
        )
    return current


_PARAM_KEYS = ("degrees", "coefficients", "horizontal_weights")


class FixedKAN(nn.Module):
    """FixedKAN module: params as buffers, forward = kan_apply, ``train``.

    ``device`` defaults to the card: without one, ``resolve_device``
    raises rather than run on the CPU, which must be asked for.
    Assigning ``params`` (a list of per-layer dicts of tensors, or None)
    registers them as buffers ``layer{i}_{key}`` on this module's device.
    """

    def __init__(self, config: FixedKANConfig, *, device="cuda"):
        super().__init__()
        self.config = config
        self.device = resolve_device(device)
        self._num_layers: Optional[int] = None
        self.last_train_diverged = False
        self.last_train_losses: list = []
        # resolved by train(); None means "never trained"
        self.last_matmul_precision = None

    @property
    def params(self) -> Optional[list]:
        if self._num_layers is None:
            return None
        return [
            {k: getattr(self, f"layer{i}_{k}") for k in _PARAM_KEYS}
            for i in range(self._num_layers)
        ]

    @params.setter
    def params(self, params: Optional[list]) -> None:
        for i in range(self._num_layers or 0):
            for k in _PARAM_KEYS:
                delattr(self, f"layer{i}_{k}")
        self._num_layers = None
        if params is None:
            return
        for i, lp in enumerate(params):
            for k in _PARAM_KEYS:
                self.register_buffer(
                    f"layer{i}_{k}", torch.as_tensor(lp[k], device=self.device)
                )
        self._num_layers = len(params)

    def forward(self, x) -> torch.Tensor:
        if self.params is None:
            raise RuntimeError(
                "Neuron degree not set. Run optimization first."
            )
        cfg = self.config
        return kan_apply(
            self.params,
            torch.as_tensor(x, device=self.device),
            cfg.max_degree,
            compute_dtype=cfg.compute_dtype,
            backend=cfg.layer_backend,
            matmul_precision=cfg.forward_matmul_precision,
        )

    # -- gradient training -------------------------------------------------
    def train(
        self,
        x_data=True,
        y_data=None,
        epochs: int = 10,
        batch_size: int = 64,
        learning_rate: float = 0.01,
        loss: str = "cross_entropy",
        trainable: str = "all",
        grad_clip: float | None = None,
        lr_scale: str = "none",
        lr_schedule: str = "none",
        seed: int = 0,
        verbose: bool = False,
        backend: str = "xla",
        compute_dtype=None,
        matmul_precision: str | None = "auto",
        mesh=None,
        mesh_axis: str | None = None,
        tensor_axis: str | None = "auto",
    ):
        """Gradient training with Adam; returns the per-epoch mean losses.

        The JAX package's ``FixedKAN.train``, with its signature, defaults
        and results (``last_train_losses``, ``last_train_diverged``,
        ``last_matmul_precision``).  Called as ``train(mode)`` with one
        bool, as torch's ``eval()`` and parent modules call it, it sets
        the module's training flag like ``nn.Module.train`` instead.

        - ``trainable``: 'all' moves every coefficient and horizontal
          weight; 'horizontal' only the horizontal weights.  Degrees never
          move.
        - ``grad_clip``: global-norm clipping WITHIN each label group, as
          ``optax.multi_transform`` clips: one norm over all horizontal
          weights, one per layer's coefficients.
        - ``lr_scale='fanin'``: layer i's coefficients learn at
          lr * fanin_last / fanin_i, fanin = in * (D+1) * out.
        - ``lr_schedule='cosine'``: every group decays from its own lr to
          zero over epochs * steps updates.
        - batches: ``np.random.default_rng(seed)``; each epoch takes
          ``permutation(n)[:steps * batch_size]``; the data goes to the
          device once and each step gathers its rows there.
        - a non-finite loss in an epoch stops the run and restores the
          last finite epoch's parameters.
        - precision: 'xla' runs 'auto' as 'high' (true FP32; on the card
          TF32 must be off, else it raises); 'fused' always 'high';
          'fused_dw' maps 'auto'/'highest'/'bf16x2_*' to 'high' and a
          bf16 ``compute_dtype`` to 'bf16'.

        ``mesh`` (data and tensor parallelism) is not ported yet.
        """
        if isinstance(x_data, bool) and y_data is None:
            return nn.Module.train(self, x_data)
        if mesh is not None:
            raise NotImplementedError(
                "train(mesh=...) needs the multi-device slice, ROADMAP.md "
                "queue 1 item 10"
            )
        if self.params is None:
            raise RuntimeError("Run optimization first.")
        x = torch.as_tensor(x_data, device=self.device)
        y = torch.as_tensor(y_data, device=self.device)
        max_degree = self.config.max_degree
        compute_dtype = _compute_dtype(compute_dtype)
        if compute_dtype in _INT8_RECIPES:
            raise ValueError("int8 rounding has zero gradient; use bf16")
        if compute_dtype is not None:
            x = x.to(compute_dtype)  # store once, the bf16io recipe

        # the precision each backend runs (JAX fixed_kan.py:1074-1090); the
        # port has no ambient matmul context, so 'xla' passes it through
        # kan_apply like the fused backends
        if backend == "xla":
            if matmul_precision == "auto":
                matmul_precision = "high"
        elif backend == "fused":
            matmul_precision = "high"  # what the v1 kernel runs
        elif backend == "fused_dw":
            if matmul_precision in ("auto", "highest", "bf16x2_w",
                                    "bf16x2_x"):
                matmul_precision = "high"
            if compute_dtype == torch.bfloat16:
                matmul_precision = "bf16"
        else:
            raise ValueError(
                f"unknown backend {backend!r}: expected 'xla', 'fused', or "
                "'fused_dw'"
            )
        self.last_matmul_precision = matmul_precision

        def forward(params, xb):
            return kan_apply(params, xb, max_degree, compute_dtype, backend,
                             matmul_precision=matmul_precision)

        if loss == "cross_entropy":
            if y.dim() == 1:
                onehot_dtype = (
                    torch.float64 if x.dtype == torch.float64
                    else torch.float32
                )
                y_train = torch.nn.functional.one_hot(
                    y.long(), self.config.network_shape[-1]
                ).to(onehot_dtype)
            else:
                y_train = y

            def loss_fn(params, xb, yb):
                logp = torch.log_softmax(forward(params, xb), dim=-1)
                return torch.mean(-torch.sum(yb * logp, dim=-1))
        elif loss == "mse":
            y_train = y if y.dim() > 1 else y[:, None]

            def loss_fn(params, xb, yb):
                return torch.mean((forward(params, xb) - yb) ** 2)
        else:
            raise ValueError(f"Unknown loss {loss!r}")

        if trainable not in ("all", "horizontal"):
            raise ValueError(f"Unknown trainable {trainable!r}")
        if lr_schedule not in ("none", "cosine"):
            raise ValueError(f"Unknown lr_schedule {lr_schedule!r}")
        n = x.shape[0]
        batch_size = min(batch_size, n)  # a batch can't exceed the dataset
        steps = max(1, n // batch_size)

        # leaves built from the buffers; the integer degrees stay outside
        params = [
            {
                "degrees": lp["degrees"],
                "coefficients": lp["coefficients"].detach().clone()
                .requires_grad_(trainable == "all"),
                "horizontal_weights": lp["horizontal_weights"].detach()
                .clone().requires_grad_(),
            }
            for lp in self.params
        ]
        decay = epochs * steps if lr_schedule == "cosine" else None
        groups = [AdamGroup(
            [lp["horizontal_weights"] for lp in params], learning_rate,
            grad_clip, decay,
        )]
        if trainable == "all":
            dp1 = max_degree + 1
            fanins = [
                float(lp["coefficients"].shape[1] * dp1
                      * lp["coefficients"].shape[0])
                for lp in params
            ]
            for lp, fanin in zip(params, fanins):
                lr = (learning_rate * fanins[-1] / fanin
                      if lr_scale == "fanin" else learning_rate)
                groups.append(AdamGroup(
                    [lp["coefficients"]], lr, grad_clip, decay
                ))
        leaves = [p for grp in groups for p in grp.params]

        def train_step(idx_row):
            l = loss_fn(params, x[idx_row], y_train[idx_row])
            grads = torch.autograd.grad(l, leaves)
            k = 0
            for grp in groups:
                grp.step(grads[k : k + len(grp.params)])
                k += len(grp.params)
            return l.detach()

        rng = np.random.default_rng(seed)
        losses, diverged = self._run_epochs(
            train_step, params, rng, epochs, n, steps, batch_size, verbose
        )
        self.params = [
            {k: v.detach() for k, v in lp.items()} for lp in params
        ]
        self.last_train_diverged = diverged
        self.last_train_losses = list(losses)
        return losses

    def _run_epochs(
        self, train_step, params, rng, epochs, n, steps, batch_size, verbose
    ):
        """Epoch loop with divergence detection: the step losses come to
        the host once per epoch; a non-finite one restores the last finite
        epoch's parameters in place.  Returns (losses, diverged)."""
        losses = []
        keys = ("coefficients", "horizontal_weights")
        last_good = [{k: lp[k].detach().clone() for k in keys}
                     for lp in params]
        diverged = False
        for epoch in range(epochs):
            perm = rng.permutation(n)[: steps * batch_size]
            idx = torch.from_numpy(perm.reshape(steps, batch_size)).to(
                self.device
            )
            ls = torch.stack([train_step(row) for row in idx])
            ls = ls.cpu().numpy().astype(np.float64)
            if not np.isfinite(ls).all():
                bad = int(np.argmax(~np.isfinite(ls)))
                logging.getLogger(__name__).warning(
                    "Non-finite loss at epoch %d step %d; stopping and "
                    "restoring the last finite epoch's parameters",
                    epoch, bad,
                )
                with torch.no_grad():
                    for lp, good in zip(params, last_good):
                        for k in keys:
                            lp[k].copy_(good[k])
                diverged = True
                break
            for lp, good in zip(params, last_good):
                for k in keys:
                    good[k].copy_(lp[k].detach())
            losses.append(float(ls.mean()))
            if verbose:
                print(f"Epoch {epoch+1}/{epochs}, avg Loss: {losses[-1]:.4f}")
        return losses, diverged

    def train_horizontal_weights(
        self, x_data, y_data, epochs: int, learning_rate: float = 0.01, **kw
    ) -> list:
        """Reference-parity trainer: Adam + cross-entropy on the horizontal
        weights only (FixedKAN.train_horizontal_weights:309-333)."""
        return self.train(
            x_data,
            y_data,
            epochs=epochs,
            learning_rate=learning_rate,
            loss="cross_entropy",
            trainable="horizontal",
            **kw,
        )

    # -- checkpointing (npz, the JAX package's format) -------------------
    def save_model(self, filepath: str) -> None:
        """Save config + params: a ``config_json`` uint8 entry and
        ``layer{i}/{key}`` arrays, as the JAX package writes them."""
        if self.params is None:
            raise RuntimeError("Run optimization first.")
        arrays = {"config_json": np.frombuffer(
            json.dumps(asdict(self.config)).encode(), dtype=np.uint8
        )}
        for i, lp in enumerate(params_to_numpy(self.params)):
            for k, v in lp.items():
                arrays[f"layer{i}/{k}"] = v
        np.savez(filepath, **arrays)

    @classmethod
    def load_model(cls, filepath: str, *, device="cuda") -> "FixedKAN":
        """Rebuild a model from a checkpoint onto ``device``, arrays in
        the dtypes they were stored in."""
        path = str(filepath)
        data = np.load(path if path.endswith(".npz") else path + ".npz")
        cfg_dict = json.loads(bytes(data["config_json"]).decode())
        model = cls(FixedKANConfig(**cfg_dict), device=device)
        layers = []
        i = 0
        while f"layer{i}/degrees" in data:
            layers.append({k: data[f"layer{i}/{k}"] for k in _PARAM_KEYS})
            i += 1
        model.params = params_from_numpy(layers, model.device)
        return model
