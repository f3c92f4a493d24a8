"""FixedKAN on torch tensors: structure search, forward, gradient
training and checkpoints.

Counterpart of ``qkan_implementation_tpu.models.fixed_kan``: the config
with its presets; structure search (``optimize``: the per-degree least
squares sweep on the Gram, QR or SVD route, the degree-selection QUBO and
the annealer of ``anneal/``, layer by layer); the forward precision
policy, ``kan_layer_apply`` / ``kan_apply`` on the ``'xla'`` fold and the
``'fused'`` / ``'fused_dw'`` kernel backends; ``train`` and
``train_horizontal_weights`` (Adam with per-group clipping, fan-in
learning rates and the cosine schedule of the JAX package's optax chain,
``models._optim``), on one device or over the slots of a
``parallel.Mesh`` (``train(mesh=)``: rows over a batch axis, the
coefficients' ``in`` axis over a ``tp`` axis; ``optimize(mesh=)``: rows
over the first axis, per-slot Gram partials, the sharded annealer);
``analyze_network`` and ``visualize_analysis``; and the npz checkpoint
format, which stays byte-compatible with the JAX package so a model saved
by either loads in the other.

Parameters are a list of per-layer dicts, as in the JAX package:
``degrees [out]`` (int), ``coefficients [out, in, D+1, T]`` and
``horizontal_weights [out]``.  ``FixedKAN`` keeps them as module buffers.
"""

from __future__ import annotations

import json
import logging
import time
import warnings
from dataclasses import asdict, dataclass
from typing import List, Optional

import numpy as np
import torch
from torch import nn

from qkan_implementation_tpu_torch.anneal import (
    degree_selection_qubo,
    polish_one_hot_blocks,
    simulated_annealing_sharded,
    solve_qubo,
)
from qkan_implementation_tpu_torch.models._optim import AdamGroup
from qkan_implementation_tpu_torch.ops.chebyshev import chebyshev_basis
from qkan_implementation_tpu_torch.ops.fused_layer import (
    kan_layer_fused,
    kan_layer_fused_dw,
)
from qkan_implementation_tpu_torch.ops.qkan_layer import (
    int8_quantized_matmul,
    int8_residual_matmul,
)
from qkan_implementation_tpu_torch.parallel.collectives import psum
from qkan_implementation_tpu_torch.parallel.mesh import Shards, shard_batch
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

# compute_dtype recipes served by the int8 products of ops/qkan_layer.py
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


# -- the degree sweep's solves -------------------------------------------
# Every solve-path product is true FP32 on the card (TF32 off, checked by
# _check_fp32_matmul), as the JAX package pins "highest" on each: the Gram
# system is conditioned near 1/ridge, so one-pass products would turn
# multiply noise into large coefficient error.


def _min_norm_lstsq(X: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """numpy.linalg.lstsq's answer (rcond=None) from an SVD: singular
    values at or below eps * max(B, F) * s_max count as zero, so a
    rank-deficient design gets the minimum-norm solution.  torch's own
    lstsq on CUDA has only 'gels', which assumes full rank."""
    U, S, Vh = torch.linalg.svd(X, full_matrices=False)
    cutoff = torch.finfo(X.dtype).eps * max(X.shape) * S[:1]
    inv = torch.where(S > cutoff, 1.0 / S, 0.0)
    return Vh.mT @ (inv[:, None] * (U.mT @ y))


def _lstsq(X: torch.Tensor, y: torch.Tensor, method: str,
           ridge: float) -> torch.Tensor:
    """Least-squares solve, [B, F] x [B, T] -> [F, T].

    'svd' gives numpy.linalg.lstsq's min-norm answer (reference
    KANLayer._optimize_coefficients_classical:190-193); 'normal' solves
    the ridge-regularized normal equations with Cholesky (NaN where the
    factorization breaks down, as JAX's solve gives).
    """
    if method == "svd":
        _check_fp32_matmul(X)
        return _min_norm_lstsq(X, y)
    if method == "normal":
        _check_fp32_matmul(X)
        f = X.shape[1]
        gram = X.T @ X
        scale = torch.trace(gram) / f + 1e-30
        gram = gram + (ridge * scale) * torch.eye(
            f, dtype=X.dtype, device=X.device
        )
        L, info = torch.linalg.cholesky_ex(gram)
        c = torch.cholesky_solve(X.T @ y, L)
        return torch.where(info == 0, c, torch.nan)
    raise ValueError(f"Unknown lstsq method {method!r}")


# Relative ridge floor for the f32 QR degree sweep (the JAX package's
# _QR_RIDGE_F32): a hard R-diagonal drop fits tighter but with max|c| ~
# 2e5 on the flagship layer 0, coefficients that turn bf16 serving noise
# into O(1) output error, so the small-norm ridge solution is kept.
_QR_RIDGE_F32 = 1e-6


def _degree_major(basis: torch.Tensor) -> torch.Tensor:
    """[B, in, D+1] -> [B, (D+1)*in]: cumulative degrees are leading
    column blocks."""
    return basis.transpose(1, 2).reshape(basis.shape[0], -1)


def _dim_major(c, k: int, d: int, in_dim: int, t_dim: int):
    """Reorder a degree-major solution's leading-block rows into the
    dim-major layout the forward pass stores: [d+1, in, T] -> [in, d+1, T]
    flattened to [k, T].  Shared by the Gram and QR sweeps so the two
    solver paths cannot diverge in layout."""
    return c[:k].reshape(d + 1, in_dim, t_dim).transpose(0, 1).reshape(
        k, t_dim
    )


def _layer_qr_factor(X: torch.Tensor, ridge: float):
    """R of the ridge-augmented design [X; sqrt(lam) I] (Householder,
    R only, on X's device): its leading [k, k] block satisfies R_k'R_k =
    X_k'X_k + lam*I, so ONE factorization serves every cumulative degree,
    backward-stable where the f32 Gram Cholesky breaks down.  At f32 the
    relative ridge is at least ``_QR_RIDGE_F32``."""
    f = X.shape[1]
    lam = ridge if X.dtype != torch.float32 else max(ridge, _QR_RIDGE_F32)
    s = torch.sqrt(lam * torch.sum(X * X) / f)
    eye = torch.eye(f, dtype=X.dtype, device=X.device)
    return torch.linalg.qr(torch.cat([X, s * eye]), mode="r").R


def _qr_solve(X, R, bvec, y, k: int):
    """Coefficients of the leading k columns (two triangular solves on
    R[:k, :k] plus one refinement step against the UNRIDGED normal
    equations, which cancels most of the ridge bias) and the honest
    full-data MSE.  The JAX package masks R to a traced block size; the
    leading block's solution is the same, with c[k:] = 0."""
    Rk, Xk, bk = R[:k, :k], X[:, :k], bvec[:k]

    def rsolve(v):
        z = torch.linalg.solve_triangular(Rk.mT, v, upper=False)
        return torch.linalg.solve_triangular(Rk, z, upper=True)

    c = rsolve(bk)
    c = c + rsolve(bk - Xk.T @ (Xk @ c))
    return c, torch.mean((y - Xk @ c) ** 2)


def _gram_solve(G, bvec, yy, scale, ridge: float, k: int):
    """Leading-block ridge Cholesky solve of the normal equations with one
    refinement step against the unridged block, and the residual sum of
    squares yy - 2 c'b + c'Gc.  ``scale`` is trace(G)/F of the WHOLE Gram
    matrix, as in the JAX package.  A breakdown (info != 0, where JAX's
    cho_factor gives NaN) makes the residual NaN, which sends the sweep to
    its fallback."""
    Gk, bk = G[:k, :k], bvec[:k]
    eye = torch.eye(k, dtype=G.dtype, device=G.device)
    L, info = torch.linalg.cholesky_ex(Gk + (ridge * scale) * eye)
    c = torch.cholesky_solve(bk, L)
    c = c + torch.cholesky_solve(bk - Gk @ c, L)
    res = yy - 2.0 * torch.sum(c * bk) + torch.sum(c * (Gk @ c))
    return c, torch.where(info == 0, res, torch.nan)


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
    ``'int8'`` / ``'int8x2'`` / ``'int8x2w'`` ('xla' only) serve the
    product through ``ops.qkan_layer``'s int8 recipes (float32 output).
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
    if compute_dtype in ("int8x2", "int8x2w"):
        return int8_residual_matmul(
            a2d, W, acts_residual=compute_dtype == "int8x2"
        )
    if compute_dtype == "int8":
        if W.shape[0] >= _FORWARD_PRECISION_MIN_FANIN:
            # one int8 level's ~4e-3 rounding noise random-walks through a
            # contraction this wide into O(1) logit error: the JAX package
            # measured chance accuracy on the flagship with it
            warnings.warn(
                f"int8 serving at fan-in {W.shape[0]} >= "
                f"{_FORWARD_PRECISION_MIN_FANIN}: quantization noise at "
                "this contraction width measured CHANCE accuracy on the "
                "flagship shape; use compute_dtype=None or 'int8x2'",
                stacklevel=2,
            )
        return int8_quantized_matmul(a2d, W)
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


def _leaf_tensors(v) -> list:
    """A leaf of a mesh layout (a tensor or a ``Shards``) as tensors."""
    return list(v.parts) if isinstance(v, Shards) else [v]


def _whole(v) -> torch.Tensor:
    return v.full() if isinstance(v, Shards) else v


def _cat_rows(parts: list, device) -> torch.Tensor:
    """Row shards gathered onto ``device``; one shard passes through."""
    if len(parts) == 1:
        return parts[0]
    return torch.cat([p.to(device) for p in parts])


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
        # set by optimize()
        self.last_quantum_resources = None
        self.last_search_stats: list = []
        self._sweep_log: list = []

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

    # -- structure search ------------------------------------------------
    def _as_input(self, a) -> torch.Tensor:
        """A tensor on this model's device; float64 numpy takes torch's
        default dtype, as ``jnp.asarray`` takes JAX's."""
        if isinstance(a, torch.Tensor):
            return a.to(self.device)
        a = np.asarray(a)
        dtype = torch.get_default_dtype() if a.dtype == np.float64 else None
        return torch.as_tensor(a, dtype=dtype, device=self.device)

    def _log_sweep(self, route: str, *tensors) -> None:
        self._sweep_log.append(
            {"route": route, "devices": [str(t.device) for t in tensors]}
        )

    def _evaluate_layer_degrees(self, x_fit, y):
        """Per-cumulative-degree lstsq + MSE scores.

        One solve per degree serves every neuron (they share the transform
        and the target; reference KANLayer.optimize_degrees :127-146).
        Returns (scores [D+1] numpy, coeffs list of [in*(d+1), T] in
        dim-major layout, on x_fit's (first) device).

        Routing, as the JAX package's: 'qr' takes the QR sweep (the SVD
        one when rows < columns); 'svd' the SVD sweep; 'normal' the Gram
        sweep (one Gram pass, a leading-block Cholesky a degree), except
        that at float32 its ridge is raised to 1e-4 and a layer with
        dp1*in*2.4e-7 above it goes to the QR sweep (rows >= columns) or
        the SVD one, and NaN scores fall back the same way.

        ``x_fit`` and ``y`` may be lists of row shards, one a mesh slot
        (``optimize(mesh=)``): the Gram pass then forms each slot's Gram
        partial on its slot and sums them in slot order, one sum a layer;
        the QR and SVD routes gather the rows onto the first slot.
        """
        cfg = self.config
        xs, ys = (x_fit, y) if isinstance(x_fit, list) else ([x_fit], [y])
        dev = xs[0].device

        def gathered():
            return (chebyshev_basis(_cat_rows(xs, dev), cfg.max_degree,
                                    clip=False), _cat_rows(ys, dev))

        b, in_dim = sum(t.shape[0] for t in xs), xs[0].shape[1]
        dp1 = cfg.max_degree + 1
        square_or_tall = b >= dp1 * in_dim
        if cfg.lstsq_method == "qr":
            # underdetermined: keep the reference's min-norm SVD semantics
            if not square_or_tall:
                return self._svd_fallback(*gathered())
            return self._qr_sweep(*gathered())
        if cfg.lstsq_method != "normal":
            return self._svd_fallback(*gathered(), method=cfg.lstsq_method)

        t_dim = ys[0].shape[1]
        # The design is structurally rank-deficient (T_0 of every input
        # dim is the same all-ones column), so the Cholesky needs a ridge
        # above the working precision's floor: 1e-8 at f64, 1e-4 at f32;
        # and f32 Cholesky breaks down by SIZE once 2 eps_f32 * F exceeds
        # the relative ridge (F = 4704, the flagship layer 0): those layers
        # go straight to the QR sweep (JAX fixed_kan.py:610-640).
        ridge = float(cfg.lstsq_ridge)
        if xs[0].dtype == torch.float32:
            ridge = max(ridge, 1e-4)
            if dp1 * in_dim * 2.4e-7 > ridge:
                if square_or_tall:
                    return self._qr_sweep(*gathered())
                return self._svd_fallback(*gathered())
        stats, logged = [], []
        for xj, yj in zip(xs, ys):
            X = _degree_major(chebyshev_basis(xj, cfg.max_degree, clip=False))
            _check_fp32_matmul(X)
            stats.append((X.T @ X, X.T @ yj, torch.sum(yj**2)))
            logged += [X, stats[-1][0]]
        if len(stats) == 1:
            G, bvec, yy = stats[0]
        else:
            f = stats[0][0].shape[0]
            flat = psum([torch.cat([g.reshape(-1), bv.reshape(-1), s[None]])
                         for g, bv, s in stats])[0]
            G = flat[: f * f].reshape(f, f)
            bvec = flat[f * f: f * f + f * t_dim].reshape(f, t_dim)
            yy = flat[-1]
        self._log_sweep("gram", *logged)
        scale = torch.trace(G) / G.shape[0] + 1e-30
        res, coeffs = [], []
        for d in range(dp1):
            k = (d + 1) * in_dim
            c, r = _gram_solve(G, bvec, yy, scale, ridge, k)
            res.append(r)
            coeffs.append(_dim_major(c, k, d, in_dim, t_dim))
        # res pools squared residuals over B rows AND T target columns:
        # normalize by both (the svd and quantum paths' mean); one read to
        # the host a layer
        scores = torch.clamp_min(torch.stack(res), 0.0) / (b * t_dim)
        scores = scores.cpu().numpy().astype(np.float64)
        if not np.all(np.isfinite(scores)):
            # conditioning defeated the fast path: never hand NaN scores
            # to the QUBO
            if square_or_tall:
                return self._qr_sweep(*gathered())
            return self._svd_fallback(*gathered())
        return scores, coeffs

    def _qr_sweep(self, basis: torch.Tensor, y: torch.Tensor):
        """One-QR-all-degrees scoring: ridge-augmented Householder QR of
        the degree-major design matrix (``_layer_qr_factor``), two
        triangular solves + one unridged refinement per cumulative degree
        (``_qr_solve``), honest full-data MSE scores.  Requires rows >=
        columns.  NaN scores fall back to the SVD sweep."""
        in_dim = basis.shape[1]
        dp1 = self.config.max_degree + 1
        t_dim = y.shape[1]
        X = _degree_major(basis)
        _check_fp32_matmul(X)
        R = _layer_qr_factor(X, float(self.config.lstsq_ridge))
        bvec = X.T @ y
        self._log_sweep("qr", X, R)
        res, coeffs = [], []
        for d in range(dp1):
            k = (d + 1) * in_dim
            c, r = _qr_solve(X, R, bvec, y, k)
            res.append(r)
            coeffs.append(_dim_major(c, k, d, in_dim, t_dim))
        scores = torch.stack(res).cpu().numpy().astype(np.float64)
        if not np.all(np.isfinite(scores)):
            return self._svd_fallback(basis, y)
        return scores, coeffs

    def _svd_fallback(self, basis: torch.Tensor, y: torch.Tensor,
                      method: str = "svd"):
        """Per-degree lstsq sweep over a precomputed [B, in, D+1] basis:
        the 'svd' scoring path, and the last-resort fallback of the
        'normal'/'qr' fast paths."""
        cfg = self.config
        b = basis.shape[0]
        res, coeffs = [], []
        for d in range(cfg.max_degree + 1):
            X_d = basis[:, :, : d + 1].reshape(b, -1)
            c = _lstsq(X_d, y, method, cfg.lstsq_ridge)
            res.append(torch.mean((y - X_d @ c) ** 2))
            coeffs.append(c)
        self._log_sweep(method, X_d)
        return torch.stack(res).cpu().numpy().astype(np.float64), coeffs

    def _evaluate_layer_degrees_quantum(self, x_fit: torch.Tensor,
                                        y: torch.Tensor):
        """Quantum-verified coefficient solves: the design matrix of each
        cumulative degree is FABLE-encoded, recovered column by column from
        circuit simulations on this model's device
        (``ops.quantum.quantum_extract_block_columns``), and used for the
        solve; the fit is scored on the FULL data classically.  Rows are
        capped at ``config.quantum_sample_cap`` (evenly strided).  The
        encoding is built on the host, so this route copies the design
        matrix there.  Resources per degree go to
        ``self.last_quantum_resources``.
        """
        from qkan_implementation_tpu_torch.ops.quantum import (
            quantum_extract_block_columns,
        )

        cfg = self.config
        basis = chebyshev_basis(x_fit, cfg.max_degree, clip=False)
        b = basis.shape[0]
        cap = cfg.quantum_sample_cap
        sub = (
            np.linspace(0, b - 1, cap).round().astype(int)
            if cap and b > cap
            else np.arange(b)
        )
        y_np = y.cpu().numpy()
        scores, coeffs = [], []
        for d in range(cfg.max_degree + 1):
            X = basis[:, :, : d + 1].reshape(b, -1).cpu().numpy()
            X_rec, circuit, alpha = quantum_extract_block_columns(
                X[sub], return_encoding=True, device=self.device
            )
            self.last_quantum_resources.append(
                {
                    "n_qubits": circuit.num_qubits,
                    "circuit_depth": circuit.depth(),
                    "gate_count": circuit.gate_count,
                    "alpha_scaling": float(alpha),
                    "rows_encoded": int(len(sub)),
                    "columns_simulated": int(X.shape[1]),
                }
            )
            c = np.linalg.lstsq(X_rec, y_np[sub], rcond=None)[0]
            pred = X @ c  # score the quantum-fit coefficients on full data
            scores.append(float(np.mean((y_np - pred) ** 2)))
            coeffs.append(torch.as_tensor(c, device=self.device))
        return np.array(scores), coeffs

    def optimize(
        self,
        x_data,
        y_data,
        num_reads: int = 1000,
        num_sweeps: int = 1000,
        seed: int = 0,
        solver: str = "anneal",
        use_quantum: bool = False,
        mesh=None,
    ) -> None:
        """QUBO degree selection, layer by layer (FixedKAN.optimize:335-353).

        Every layer is fit against the same target ``y`` and maps [B, in]
        to [B, target_dim].  The sweep runs on this model's device (the
        design matrix, its Gram matrix or QR factor, the solves); the
        scores come to the host once a layer for the QUBO.

        ``solver``: 'anneal' runs the batched annealer on this model's
        device with the one-hot polish (``anneal.solve_qubo``); 'exact'
        takes the blockwise optimum directly (the QUBO is per-neuron
        separable).  ``use_quantum``: route the per-degree solves through
        the FABLE block-encoding simulator
        (``_evaluate_layer_degrees_quantum``).

        ``self.last_search_stats`` gets one dict a layer: the sweep's
        route(s) with the devices of its tensors, the row slots, the
        scores, the degrees, and the host seconds of the sweep and of the
        degree selection.

        ``mesh``: data-parallel structure search.  The rows shard over the
        mesh's first axis (one piece a slot of it): the Gram pass forms
        each slot's partial on its slot and sums them in slot order, one
        sum a layer, and every layer's forward runs slot by slot; the QR
        and SVD sweeps gather the rows onto the first slot (no distributed
        TSQR).  A row count that does not divide the axis warns and runs
        unsharded.  With ``solver='anneal'`` the chains split over the
        same axis (``anneal.simulated_annealing_sharded``) before the
        one-hot polish.
        """
        if solver not in ("anneal", "exact"):
            raise ValueError(f"Unknown solver {solver!r}")
        cfg = self.config
        x = self._as_input(x_data)
        y = self._as_input(y_data)
        if y.dim() == 1:
            y = y[:, None]
        # coefficients are float regardless of the target dtype: integer
        # labels must not truncate the fitted coefficients (numpy's
        # promotion in the JAX package gives them the default float)
        c_dtype = (torch.promote_types(y.dtype, torch.float32)
                   if y.is_floating_point() else torch.get_default_dtype())
        if not y.is_floating_point():
            y = y.to(torch.promote_types(x.dtype, y.dtype))
        xs, ys = [x], [y]
        if mesh is not None:
            axis = mesh.axis_names[0]
            if x.shape[0] % mesh.shape[axis] == 0:
                xs = shard_batch(x, mesh, axis)
                ys = shard_batch(y, mesh, axis)
            else:
                # documented degradation, but never a SILENT one (train()
                # raises for the same condition)
                warnings.warn(
                    f"row count {x.shape[0]} not divisible by mesh axis "
                    f"{axis!r} ({mesh.shape[axis]} devices): structure "
                    "search runs unsharded"
                )

        params = []
        current = xs
        dp1 = cfg.max_degree + 1
        self.last_quantum_resources = [] if use_quantum else None
        self.last_search_stats = []
        for layer_idx in range(len(cfg.network_shape) - 1):
            out_dim = cfg.network_shape[layer_idx + 1]
            x_fit = [torch.tanh(c) if cfg.consistent_tanh else c
                     for c in current]
            self._sweep_log = []
            t0 = time.perf_counter()
            if use_quantum:
                scores, coeffs = self._evaluate_layer_degrees_quantum(
                    _cat_rows(x_fit, self.device), _cat_rows(ys, self.device)
                )
            elif len(x_fit) == 1:
                scores, coeffs = self._evaluate_layer_degrees(x_fit[0], y)
            else:
                scores, coeffs = self._evaluate_layer_degrees(x_fit, ys)
            t1 = time.perf_counter()
            model = degree_selection_qubo(
                scores,
                num_functions=out_dim,
                complexity_weight=cfg.complexity_weight,
                objective=cfg.degree_objective,
            )
            if solver == "anneal" and mesh is not None:
                # pre-polish energies are recomputed after the one-hot
                # polish; the sampler's own energies don't enter selection
                samples, _ = simulated_annealing_sharded(
                    model, mesh, axis_name=mesh.axis_names[0],
                    num_reads=num_reads, num_sweeps=num_sweeps,
                    seed=seed + layer_idx,
                )
                samples = polish_one_hot_blocks(model, samples, dp1)
                sample = samples[int(np.argmin(model.energy(samples)))]
            elif solver == "anneal":
                sample, _ = solve_qubo(
                    model,
                    num_reads=num_reads,
                    num_sweeps=num_sweeps,
                    seed=seed + layer_idx,
                    one_hot_block_size=dp1,
                    device=self.device,
                )
            else:
                lin = model.h[:dp1] + 0.0  # blocks are identical
                sample = np.zeros(out_dim * dp1)
                sample[int(np.argmin(lin))::dp1] = 1.0
            t2 = time.perf_counter()

            degrees = np.argmax(sample.reshape(out_dim, dp1), axis=1).astype(
                np.int32
            )
            in_dim = current[0].shape[1]
            t_dim = y.shape[1]
            C = torch.zeros((out_dim, in_dim, dp1, t_dim), dtype=c_dtype,
                            device=self.device)
            for d in np.unique(degrees):
                rows = torch.as_tensor(
                    np.flatnonzero(degrees == d), device=self.device
                )
                C[rows, :, : d + 1, :] = coeffs[d].reshape(
                    in_dim, d + 1, t_dim
                ).to(C.device, C.dtype)
            layer_params = {
                "degrees": torch.as_tensor(degrees, device=self.device),
                "coefficients": C,
                "horizontal_weights": torch.ones(
                    out_dim, dtype=C.dtype, device=self.device
                ),
            }
            params.append(layer_params)
            current = [
                kan_layer_apply({k: v.to(c.device)
                                 for k, v in layer_params.items()},
                                c, cfg.max_degree)
                for c in current
            ]
            self.last_search_stats.append({
                "layer": layer_idx,
                "sweeps": self._sweep_log,
                "route": "+".join(e["route"] for e in self._sweep_log)
                or "quantum",
                "slots": len(x_fit),
                "scores": [float(v) for v in scores],
                "degrees": degrees.tolist(),
                "solve_seconds": t1 - t0,
                "select_seconds": t2 - t1,
            })

        self.params = params

    def calculate_layer_complexity_weight(self, layer_idx: int,
                                          degree: int) -> float:
        """Depth-dependent parabolic complexity weight.

        Port of FixedKAN._calculate_layer_complexity_weight (reference
        :354-368).  Like the reference, the degree optimizer does not
        consume it (optimize uses the flat complexity_weight).
        """
        num_layers = len(self.config.network_shape) - 1
        layer_pos = layer_idx / (num_layers - 1) if num_layers > 1 else 0.0
        layer_scale = 4 * (layer_pos - 0.5) ** 2
        degree_penalty = degree * (1 + np.log(degree + 1))
        return self.config.complexity_weight * layer_scale * degree_penalty

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

        ``mesh`` (a ``parallel.Mesh``) turns on data-parallel training:
        each minibatch splits over ``mesh_axis`` (default: the mesh's
        first axis that is not the tensor axis), one piece a slot, with
        one master copy of each parameter on slot 0; every slot takes its
        copy with ``Tensor.to`` and autograd sums the gradients over the
        slots.  The batches are the single-slot run's, in its order, so
        the updates follow its trajectory up to the order of the sums.
        ``tensor_axis``: 'auto' uses an axis named 'tp' when the mesh
        carries one, None opts out (the axis is then left unused), an
        explicit name requires that axis.  With tensor parallelism on, the
        coefficients' ``in`` axis and x's features split over it for the
        layers whose in_dim divides it (``parallel.tp``'s layout rule,
        reused), each shard's master and its Adam moments on its tp slot.
        ``'xla'`` only.
        """
        if isinstance(x_data, bool) and y_data is None:
            return nn.Module.train(self, x_data)
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
        if mesh is not None:
            params, batch_loss = self._mesh_loss(
                params, mesh, mesh_axis, tensor_axis, backend, batch_size,
                x, y_train, loss, compute_dtype, matmul_precision,
            )
        else:
            def batch_loss(params, idx_row):
                return loss_fn(params, x[idx_row], y_train[idx_row])

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
                # a tp-split leaf is one tensor a shard: one moment each
                groups.append(AdamGroup(
                    _leaf_tensors(lp["coefficients"]), lr, grad_clip, decay
                ))
        leaves = [p for grp in groups for p in grp.params]

        def train_step(idx_row):
            l = batch_loss(params, idx_row)
            grads = torch.autograd.grad(l, leaves)
            k = 0
            for grp in groups:
                grp.step(grads[k : k + len(grp.params)])
                k += len(grp.params)
            return l.detach()

        rng = np.random.default_rng(seed)
        losses, diverged = self._run_epochs(
            train_step,
            [t for lp in params for key in ("coefficients",
                                            "horizontal_weights")
             for t in _leaf_tensors(lp[key])],
            rng, epochs, n, steps, batch_size, verbose,
        )
        self.params = [
            {k: _whole(v).detach() for k, v in lp.items()} for lp in params
        ]
        self.last_train_diverged = diverged
        self.last_train_losses = list(losses)
        return losses

    def _mesh_loss(self, params, mesh, mesh_axis, tensor_axis, backend,
                   batch_size, x, y_train, loss, compute_dtype,
                   matmul_precision):
        """The parameters laid out over ``mesh`` and the batch loss over
        its slots, for ``train(mesh=)``: returns (params, batch_loss)
        with ``batch_loss(params, idx_row)`` the mean loss of the rows
        ``idx_row``, each slot's share formed on its slot and summed in
        slot order on slot 0."""
        from qkan_implementation_tpu_torch.parallel import tp as tp_mod

        if backend in ("fused", "fused_dw"):
            raise ValueError(
                "mesh= dp training composes with backend='xla' only: the "
                "fused kernels take one slot's batch per call, so they "
                "would need a per-slot step, as shard_map gives the JAX "
                "package's, to extend"
            )
        axes = list(mesh.axis_names)
        if tensor_axis == "auto":
            tp_ax = "tp" if "tp" in axes else None
        else:
            tp_ax = tensor_axis
            if tp_ax is not None and tp_ax not in axes:
                raise ValueError(
                    f"mesh has axes {axes}, no tensor axis {tp_ax!r}"
                )
        if tp_ax is not None and axes == [tp_ax]:
            raise ValueError(
                f"a 1-D mesh whose only axis is the tensor axis {tp_ax!r} "
                "is ambiguous here: train(mesh=) shards the batch over "
                "the remaining axis, so add a batch axis (Mesh(devices, "
                "('dp', 'tp'), (1, n))), pass tensor_axis=None for pure "
                "dp, or use parallel.tp.make_tp_train_step for a pure "
                "tensor-parallel step"
            )
        axis = mesh_axis or next(a for a in axes if a != tp_ax)
        if axis == tp_ax:
            raise ValueError(
                f"mesh_axis {axis!r} is the tensor-parallel axis; pass the "
                "batch axis (or tensor_axis=None)"
            )
        n_dev = mesh.shape[axis]
        if batch_size % n_dev or x.shape[0] % n_dev:
            raise ValueError(
                f"dp training needs batch_size ({batch_size}) and the row "
                f"count ({x.shape[0]}) divisible by mesh axis {axis!r} "
                f"({n_dev} devices)"
            )
        # parallel/tp.py's layout rule verbatim, so the two routes cannot
        # desynchronize; without a tensor axis every leaf is replicated
        flags = (tp_mod._tp_layer_flags(params, mesh.shape[tp_ax],
                                        x.shape[1])
                 if tp_ax is not None else [False] * len(params))
        specs = tp_mod._param_specs(params, flags, tp_ax)

        def place(v, spec):
            leaf = tp_mod._place(v.detach(), spec, mesh)
            for t in _leaf_tensors(leaf):
                t.requires_grad_(v.requires_grad)
            return leaf

        params = [{k: place(v, sp[k]) for k, v in lp.items()}
                  for lp, sp in zip(params, specs)]
        max_degree = self.config.max_degree

        def batch_loss(params, idx_row):
            preds = tp_mod._forward_rows(
                params, x[idx_row], max_degree, mesh, axis, tp_ax, flags,
                compute_dtype, matmul_precision,
            )
            dev = preds[0].device
            total = 0.0
            for p, yb in zip(preds, torch.chunk(y_train[idx_row], n_dev)):
                yb = yb.to(p.device)
                if loss == "cross_entropy":
                    part = -torch.sum(yb * torch.log_softmax(p, dim=-1))
                else:
                    part = torch.sum((p - yb) ** 2)
                total = total + part.to(dev)
            denom = idx_row.shape[0] * (1 if loss == "cross_entropy"
                                        else y_train.shape[1])
            return total / denom

        return params, batch_loss

    def _run_epochs(
        self, train_step, leaves, rng, epochs, n, steps, batch_size, verbose
    ):
        """Epoch loop with divergence detection: the step losses come to
        the host once per epoch; a non-finite one restores the last finite
        epoch's values of ``leaves`` in place.  Returns (losses,
        diverged)."""
        losses = []
        last_good = [t.detach().clone() for t in leaves]
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
                    for t, good in zip(leaves, last_good):
                        t.copy_(good)
                diverged = True
                break
            for t, good in zip(leaves, last_good):
                good.copy_(t.detach())
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

    # -- analysis ---------------------------------------------------------
    def analyze_network(self, x_data) -> dict:
        """Per-layer neuron contributions (FixedKAN.analyze_network:376-435).

        ``analysis['layer_{i}']``: ``neuron_outputs`` [out, B, T] (each
        neuron's term of the layer), ``degrees`` (ints), the
        ``combined_output`` [B, T] (their sum, the layer's output) and the
        ``input_dim``; tensors on this model's device.
        """
        if self.params is None:
            raise RuntimeError("Run optimization first.")
        cfg = self.config
        analysis = {}
        current = torch.as_tensor(x_data, device=self.device)
        for layer_idx, lp in enumerate(self.params):
            basis = chebyshev_basis(torch.tanh(current), cfg.max_degree,
                                    clip=False)
            mask = (
                torch.arange(cfg.max_degree + 1, device=self.device)[None, :]
                <= lp["degrees"][:, None]
            )
            weighted = (
                lp["coefficients"]
                * mask[:, None, :, None]
                * lp["horizontal_weights"][:, None, None, None]
            )
            dtype = torch.promote_types(basis.dtype, weighted.dtype)
            neuron_outputs = torch.einsum(
                "bid,oidt->obt", basis.to(dtype), weighted.to(dtype)
            )
            combined = neuron_outputs.sum(dim=0)
            analysis[f"layer_{layer_idx}"] = {
                "neuron_outputs": neuron_outputs,
                "degrees": [int(d) for d in lp["degrees"].tolist()],
                "combined_output": combined,
                "input_dim": int(current.shape[1]),
            }
            current = combined
        return analysis

    def visualize_analysis(
        self, analysis: dict, x_data, y_data=None, save_path: str | None = None
    ):
        """Plot the per-layer analysis (FixedKAN.visualize_analysis:437-548).

        2-D inputs get 3-D scatter + contour + degree-histogram panels per
        layer; other dims get output-scatter + histogram panels.  Headless
        (Agg); returns the figure, optionally saving it.  Needs matplotlib,
        imported here: without it this raises ``ImportError``.
        """
        try:
            import matplotlib
        except ImportError as e:
            raise ImportError(
                "visualize_analysis needs matplotlib, which is not "
                "installed here; analyze_network's numbers need no plot"
            ) from e

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        def host(a):
            return (a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
                    else np.asarray(a))

        def first_col(a):
            a = host(a).squeeze()
            return a if a.ndim == 1 else a[:, 0]

        num_layers = len(self.params)
        x_np = host(x_data)
        input_dim = x_np.shape[1]
        bins = range(self.config.max_degree + 2)

        if input_dim == 2:
            fig = plt.figure(figsize=(20, 8 * num_layers))
            gs = plt.GridSpec(num_layers, 3)
            sort_idx = np.lexsort((x_np[:, 1], x_np[:, 0]))
            x_plot = x_np[sort_idx]
            for layer_idx in range(num_layers):
                layer_data = analysis[f"layer_{layer_idx}"]
                ax1 = fig.add_subplot(gs[layer_idx, 0], projection="3d")
                neuron_outputs = host(layer_data["neuron_outputs"])
                for i, degree in enumerate(layer_data["degrees"]):
                    out = first_col(neuron_outputs[i][sort_idx])
                    ax1.scatter(
                        x_plot[:, 0], x_plot[:, 1], out,
                        alpha=0.3, label=f"Neuron {i} (deg={degree})",
                    )
                combined = first_col(
                    host(layer_data["combined_output"])[sort_idx])
                ax1.scatter(
                    x_plot[:, 0], x_plot[:, 1], combined,
                    c="red", alpha=0.7, label="Layer Output",
                )
                if layer_idx == num_layers - 1 and y_data is not None:
                    y_plot = first_col(host(y_data)[sort_idx])
                    ax1.scatter(
                        x_plot[:, 0], x_plot[:, 1], y_plot,
                        c="black", alpha=0.5, label="Target",
                    )
                ax1.set_title(f"Layer {layer_idx+1} Contributions")
                ax1.legend()

                ax2 = fig.add_subplot(gs[layer_idx, 1])
                sc = ax2.tricontourf(
                    x_plot[:, 0], x_plot[:, 1], combined, levels=20,
                    cmap="viridis",
                )
                fig.colorbar(sc, ax=ax2)
                ax2.set_title(f"Layer {layer_idx+1} Output Contours")

                ax3 = fig.add_subplot(gs[layer_idx, 2])
                ax3.hist(layer_data["degrees"], bins=bins, alpha=0.7,
                         rwidth=0.8)
                ax3.set_title(f"Layer {layer_idx+1} Degree Distribution")
        else:
            fig = plt.figure(figsize=(15, 5 * num_layers))
            gs = plt.GridSpec(num_layers, 2)
            for layer_idx in range(num_layers):
                layer_data = analysis[f"layer_{layer_idx}"]
                ax1 = fig.add_subplot(gs[layer_idx, 0])
                combined = first_col(layer_data["combined_output"])
                if input_dim == 1:
                    ax1.scatter(x_np[:, 0], combined, alpha=0.5)
                else:
                    sc = ax1.scatter(
                        x_np[:, 0], x_np[:, 1], c=combined, cmap="viridis",
                        alpha=0.5,
                    )
                    fig.colorbar(sc, ax=ax1)
                ax1.set_title(f"Layer {layer_idx+1} Output")
                ax2 = fig.add_subplot(gs[layer_idx, 1])
                ax2.hist(layer_data["degrees"], bins=bins, alpha=0.7,
                         rwidth=0.8)
                ax2.set_title(f"Layer {layer_idx+1} Degree Distribution")

        fig.tight_layout()
        if save_path:
            fig.savefig(save_path)
        return fig

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
