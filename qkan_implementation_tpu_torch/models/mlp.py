"""MLP comparison baseline: BatchNorm -> (Linear -> tanh)* -> Linear.

Counterpart of ``qkan_implementation_tpu.models.mlp``: Adam (lr 8e-5 by
default) with a per-epoch reduce-on-plateau schedule (factor 0.5,
patience 2, relative threshold 1e-4), global-norm gradient clipping at
1.0 as optax clips (``models._optim.AdamGroup``), weighted MSE, early
stopping at patience 10 with the best state restored, and per-epoch
validation MSE and weighted competition-R^2 traces.

The model is an ``nn.Module`` on an explicit device.  Batch norm is
written out rather than ``nn.BatchNorm1d``: it normalises with the biased
batch variance and keeps running statistics with the unbiased one
(momentum 0.1, eps 1e-5) as the JAX package does, and takes a batch of
one row.  Weights are [in, out] (``h @ w + b``), the JAX layout, so
``utils.convert.mlp_from_numpy`` / ``mlp_to_numpy`` carry parameters
across unchanged.  The training loop is one Python step a batch.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch
from torch import nn

from qkan_implementation_tpu_torch.models._optim import AdamGroup
from qkan_implementation_tpu_torch.utils.metrics import (
    weighted_competition_r2,
)
from qkan_implementation_tpu_torch.utils.platform import resolve_device

_BN_EPS = 1e-5
_BN_MOMENTUM = 0.1  # torch BatchNorm1d default
_CLIP_NORM = 1.0
_EARLY_STOP_PATIENCE = 10


@dataclass
class MLPConfig:
    input_dim: int
    hidden_dims: List[int]
    output_dim: int = 1
    learning_rate: float = 8e-5
    batch_size: int = 32
    n_epochs: int = 10


class MLP(nn.Module):
    """BatchNorm -> (Linear -> tanh)* -> Linear with [in, out] weights.

    ``forward`` normalises with the batch statistics in training mode
    (and updates the running ones) and with the running statistics in
    eval mode.
    """

    def __init__(self, config: MLPConfig, device="cuda",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        dev = resolve_device(device)
        dims = [config.input_dim, *config.hidden_dims, config.output_dim]
        kw = {"device": dev, "dtype": dtype}
        self.bn_scale = nn.Parameter(torch.ones(config.input_dim, **kw))
        self.bn_bias = nn.Parameter(torch.zeros(config.input_dim, **kw))
        self.weights = nn.ParameterList(
            [nn.Parameter(torch.zeros(dims[i], dims[i + 1], **kw))
             for i in range(len(dims) - 1)])
        self.biases = nn.ParameterList(
            [nn.Parameter(torch.zeros(dims[i + 1], **kw))
             for i in range(len(dims) - 1)])
        self.register_buffer("running_mean",
                             torch.zeros(config.input_dim, **kw))
        self.register_buffer("running_var",
                             torch.ones(config.input_dim, **kw))

    def leaves(self) -> list:
        """The parameters in the JAX pytree's leaf order (bn_bias,
        bn_scale, then each layer's b and w): the order of the global
        norm's sum."""
        out = [self.bn_bias, self.bn_scale]
        for w, b in zip(self.weights, self.biases):
            out += [b, w]
        return out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            mean = torch.mean(x, dim=0)
            var = torch.var(x, dim=0, unbiased=False)
            n = x.shape[0]
            with torch.no_grad():
                m = _BN_MOMENTUM
                self.running_mean.copy_(
                    (1 - m) * self.running_mean + m * mean)
                self.running_var.copy_(
                    (1 - m) * self.running_var + m * (var * n / max(n - 1, 1)))
        else:
            mean, var = self.running_mean, self.running_var
        h = (x - mean) / torch.sqrt(var + _BN_EPS)
        h = h * self.bn_scale + self.bn_bias
        for w, b in zip(self.weights[:-1], self.biases[:-1]):
            h = torch.tanh(h @ w + b)
        return h @ self.weights[-1] + self.biases[-1]


def init_mlp(config: MLPConfig, seed: int = 0, dtype=torch.float32,
             device="cuda") -> MLP:
    """A new MLP: weights U(-1/sqrt(fan_in), 1/sqrt(fan_in)) from a
    ``torch.Generator`` seeded with ``seed`` on ``device``, zero biases,
    batch-norm scale 1 and bias 0, running mean 0 and variance 1.  The
    distributions of the JAX package's ``init_mlp``; its ``jax.random``
    numbers cannot be drawn here (``utils.convert.mlp_from_numpy`` carries
    them across)."""
    model = MLP(config, device=device, dtype=dtype)
    dev = model.bn_scale.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    with torch.no_grad():
        for w in model.weights:
            bound = 1.0 / np.sqrt(w.shape[0])
            u = torch.rand(w.shape, generator=gen, device=dev, dtype=dtype)
            w.copy_((2 * u - 1) * bound)
    return model


def mlp_apply(model: MLP, x: torch.Tensor, train: bool) -> torch.Tensor:
    """Forward pass in training (batch statistics, running statistics
    updated in place) or eval mode."""
    model.train(train)
    return model(x)


def _as_input(a, device) -> torch.Tensor:
    """A tensor on ``device``; float64 numpy takes torch's default dtype,
    as ``jnp.asarray`` takes JAX's."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.asarray(a)
    dtype = torch.get_default_dtype() if a.dtype == np.float64 else None
    return torch.as_tensor(a, dtype=dtype, device=device)


def train_mlp(
    config: MLPConfig,
    x_train,
    y_train,
    weights=None,
    x_val=None,
    y_val=None,
    w_val=None,
    seed: int = 0,
    verbose: bool = False,
    device="cuda",
    init_model: Optional[MLP] = None,
):
    """Train the MLP baseline; returns (scores, compr2_scores, model).

    ``scores`` / ``compr2_scores``: the per-epoch validation MSE and
    weighted competition-R^2.  ``model``: the trained ``MLP`` (the best
    validation epoch's state where there is a validation set).
    ``init_model``: a starting model (copied), else ``init_mlp(config,
    seed)`` in x's dtype.  Batches: ``np.random.default_rng(seed)``, each
    epoch ``permutation(n)[:steps * batch_size]``, as the JAX package.
    """
    dev = resolve_device(device)
    x = _as_input(x_train, dev)
    y = _as_input(y_train, dev).reshape(-1, 1)
    w = None
    if weights is not None:
        w = _as_input(weights, dev).reshape(-1, 1)
        w = w / torch.mean(w)  # normalised like the reference

    if init_model is None:
        model = init_mlp(config, seed=seed, dtype=x.dtype, device=dev)
    else:
        model = copy.deepcopy(init_model).to(dev)
    params = model.leaves()
    opt = AdamGroup(params, config.learning_rate, grad_clip=_CLIP_NORM)

    xv = yv = wv = None
    if x_val is not None and y_val is not None:
        xv = _as_input(x_val, dev)
        yv = _as_input(y_val, dev).reshape(-1, 1)
        if w_val is not None:
            wv = _as_input(w_val, dev).reshape(-1)
            wv = wv / torch.mean(wv)

    n = x.shape[0]
    batch_size = min(config.batch_size, n)
    steps = max(1, n // batch_size)
    rng = np.random.default_rng(seed)
    scores, compr2_scores = [], []
    best_val = np.inf
    best = None  # only with a validation set
    patience_counter = 0
    lr_scale = 1.0
    sched_best = np.inf  # the per-epoch plateau schedule's state
    sched_wait = 0

    for epoch in range(config.n_epochs):
        perm = rng.permutation(n)[: steps * batch_size]
        idx = torch.as_tensor(perm.reshape(steps, batch_size), device=dev)
        # the plateau scale multiplies Adam's update: a power of two, so
        # scaling the rate instead rounds the same
        opt.lr = config.learning_rate * lr_scale
        model.train()
        losses = []
        for rows in idx:
            pred = model(x[rows])
            sq = (pred - y[rows]) ** 2
            loss = torch.mean(w[rows] * sq) if w is not None else torch.mean(sq)
            opt.step(torch.autograd.grad(loss, params))
            if verbose:
                losses.append(loss.detach())

        if xv is not None:
            model.eval()
            with torch.no_grad():
                pred = model(xv)
            val_mse = float(torch.mean((pred - yv) ** 2))
            scores.append(val_mse)
            if wv is not None:
                compr2_scores.append(weighted_competition_r2(yv, pred, wv))
            if val_mse < best_val:
                best_val = val_mse
                best = {k: v.clone() for k, v in model.state_dict().items()}
                patience_counter = 0
            else:
                patience_counter += 1
            if patience_counter >= _EARLY_STOP_PATIENCE:
                if verbose:
                    print(f"Early stopping triggered at epoch {epoch}")
                break
            # per-epoch plateau schedule on the validation MSE (relative
            # threshold 1e-4; the rate halves after 2 epochs without
            # improvement); without validation data the rate never decays
            if val_mse < sched_best * (1 - 1e-4):
                sched_best = val_mse
                sched_wait = 0
            else:
                sched_wait += 1
                if sched_wait >= 2:
                    lr_scale *= 0.5
                    sched_wait = 0
        if verbose:
            total = float(torch.stack(losses).double().sum())
            msg = f"Epoch {epoch}, Loss: {total / steps:.4f}"
            if scores:
                msg += f", Val MSE: {scores[-1]:.4f}"
            if compr2_scores:
                msg += f", Val compR2: {compr2_scores[-1]:.4f}"
            print(msg)

    if best is not None:
        # best-state restore; with no validation set the final weights stay
        model.load_state_dict(best)
    model.eval()
    return scores, compr2_scores, model


def mlp_predict(model: MLP, x) -> torch.Tensor:
    """The model's eval-mode output on x (on the model's device)."""
    model.eval()
    with torch.no_grad():
        return model(_as_input(x, model.bn_scale.device))
