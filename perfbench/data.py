"""The inputs of every cell, made from the seed by the benchmark itself.

- ``digits_784``: the committed UCI handwritten-digits corpus (1797 8x8
  scans, the raw ``digits.csv.gz`` beside the program's data loader),
  its first 80 % grown to ``rows`` images by random +/-2 pixel shifts
  (zero-filled edges) and N(0, 0.02) noise clipped to [0, 1], then
  bilinearly upsampled to 28x28 = 784 features.  The recipe of the
  program's ``data.mnist.load_digits_784``, vectorised: the same kind of
  rows, not the same draws.
- ``market_columns`` and ``market_arrays``: Jane-Street-shaped columns
  in the 'hard' profile, and their preparation into train and
  validation arrays: copies of the program's generator and pipeline.
- ``kan_params``: FixedKAN parameters drawn on the device with a
  ``torch.Generator``: a degree per neuron, coefficients, horizontal
  weights.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
DIGITS_CSV = ROOT / "qkan_implementation_tpu_torch" / "data" / "digits.csv.gz"


def _bilinear_upsample(imgs: np.ndarray, size: int) -> np.ndarray:
    """[N, s, s] -> [N, size, size], bilinear with aligned corners."""
    s = imgs.shape[1]
    xs = np.linspace(0.0, s - 1.0, size)
    i0 = np.floor(xs).astype(int)
    i1 = np.minimum(i0 + 1, s - 1)
    f = xs - i0
    rows = (imgs[:, i0, :] * (1.0 - f)[None, :, None]
            + imgs[:, i1, :] * f[None, :, None])
    return (rows[:, :, i0] * (1.0 - f)[None, None, :]
            + rows[:, :, i1] * f[None, None, :])


def _shift(imgs: np.ndarray, dy: int, dx: int) -> np.ndarray:
    """Shift [n, s, s] images by (dy, dx) pixels, zero-filling the edges."""
    out = np.zeros_like(imgs)
    s = imgs.shape[1]
    ys, yd = slice(max(0, -dy), s - max(0, dy)), slice(max(0, dy), s - max(0, -dy))
    xs, xd = slice(max(0, -dx), s - max(0, dx)), slice(max(0, dx), s - max(0, -dx))
    out[:, yd, xd] = imgs[:, ys, xs]
    return out


def digits_784(rows: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """(x [rows, 784] float32 in [0, 1], labels [rows] int64)."""
    data = np.loadtxt(DIGITS_CSV, delimiter=",")
    imgs = data[:, :-1].reshape(-1, 8, 8) / 16.0
    labels = data[:, -1].astype(np.int64)
    n_train = int(0.8 * len(imgs))
    imgs, labels = imgs[:n_train], labels[:n_train]
    rng = np.random.default_rng(seed)
    if rows > len(imgs):
        idx = rng.integers(0, len(imgs), rows - len(imgs))
        shifts = rng.integers(-2, 3, (len(idx), 2))
        extra = np.empty((len(idx), 8, 8))
        for dy in range(-2, 3):
            for dx in range(-2, 3):
                sel = np.flatnonzero((shifts[:, 0] == dy) & (shifts[:, 1] == dx))
                extra[sel] = _shift(imgs[idx[sel]], dy, dx)
        extra = np.clip(extra + rng.normal(0, 0.02, extra.shape), 0.0, 1.0)
        imgs = np.concatenate([imgs, extra])
        labels = np.concatenate([labels, labels[idx]])
    imgs, labels = imgs[:rows], labels[:rows]
    x = _bilinear_upsample(imgs, 28).reshape(len(imgs), 784)
    return np.ascontiguousarray(x, dtype=np.float32), labels


def market_columns(n_rows: int, n_features: int, n_dates: int, seed: int,
                   signal_frac: float) -> dict:
    """Jane-Street-shaped columns in the 'hard' profile: date_id (sorted),
    weight, feature_00.. (~2 % NaN) and the target ``responder_6``.

    A copy of the program's ``data.pipeline.market_columns(profile=
    'hard')``, one ``np.random.default_rng(seed)`` stream drawn in its
    order: heavy-tailed (t(4)) sparse 8-factor features, a signal of six
    terms on the first six features (one an interaction) whose
    coefficients drift by date, t(3) noise, ``signal_frac`` of the
    target's variance from the signal, volatility-scaled lognormal
    weights.
    """
    rng = np.random.default_rng(seed)
    dates = np.sort(rng.integers(0, n_dates, n_rows))
    n_factors = 8
    loadings = rng.normal(0, 1, (n_features, n_factors)) * (
        rng.uniform(size=(n_features, n_factors)) < 0.3)
    factors = rng.standard_t(4, size=(n_rows, n_factors))
    feats = 0.6 * factors @ loadings.T + rng.standard_t(
        4, size=(n_rows, n_features))
    k_sig = 6
    betas = rng.normal(0, 1, k_sig) + np.cumsum(
        rng.normal(0, 0.12, (n_dates, k_sig)), axis=0)
    s = feats[:, :k_sig]
    terms = np.column_stack([s[:, 0], s[:, 1] ** 2 - 1.0, np.tanh(s[:, 2]),
                             s[:, 3], s[:, 4] * s[:, 5], s[:, 5]])
    signal = (betas[dates] * terms).sum(axis=1)
    signal /= signal.std() + 1e-12
    noise = rng.standard_t(3, size=n_rows)
    noise /= noise.std() + 1e-12
    target = (np.sqrt(signal_frac) * signal
              + np.sqrt(1.0 - signal_frac) * noise)
    weight = rng.lognormal(0.0, 0.4, n_rows) / (np.abs(factors[:, 0]) + 0.5)
    cols = {"date_id": dates, "weight": weight}
    for i in range(n_features):
        col = feats[:, i].copy()
        col[rng.uniform(size=n_rows) < 0.02] = np.nan
        cols[f"feature_{i:02d}"] = col
    cols["responder_6"] = target
    return cols


def market_arrays(cols: dict, n_features: int, train_ratio: float):
    """(train x [n, F], target [n, 1], weight [n, 1], then the same for
    the validation rows), float64.

    A copy of the program's ``DataPipeline.load_and_preprocess_data`` on
    a column dict: NaN becomes 3, rows sort by date, every feature and the
    target are normalised to [-1, 1] by their 5 % and 95 % quantiles
    (values beyond them clamp to +/-1), and the first ``train_ratio`` of
    the unique dates are the training rows.
    """
    order = np.argsort(cols["date_id"], kind="quicksort")
    dates = cols["date_id"][order]

    def normalized(name):
        v = np.asarray(cols[name], dtype=np.float64)[order]
        v = np.where(np.isnan(v), 3.0, v)
        q05, q95 = np.quantile(v, [0.05, 0.95])
        std = v.std()
        center = (q95 + q05) / 2
        if abs(q95 - q05) > 1e-10:
            scale = (q95 - q05) / 2
        elif std > 1e-10:
            scale = std
        else:
            scale = 1.0
        return np.where(v > q95, 1.0,
                        np.where(v < q05, -1.0, (v - center) / scale))

    feats = np.stack([normalized(f"feature_{i:02d}")
                      for i in range(n_features)], axis=1)
    target = normalized("responder_6").reshape(-1, 1)
    weight = np.asarray(cols["weight"], dtype=np.float64)[order].reshape(-1, 1)
    unique = np.unique(dates)
    train = np.isin(dates, unique[: int(len(unique) * train_ratio)])
    return (feats[train], target[train], weight[train],
            feats[~train], target[~train], weight[~train])


def kan_params(dims: list[tuple[int, int]], widths: list[int],
               max_degree: int, seed: int, device) -> list[dict]:
    """FixedKAN parameters: layer i maps dims[i] = (in, T) through
    widths[i] neurons.  Degrees uniform in 0..D; coefficients
    N(0, 1/(in*(D+1)*out)), so each layer's output is O(1); horizontal
    weights uniform in [0.5, 1.5].  Drawn on ``device`` in float32."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    dp1 = max_degree + 1
    params = []
    for (n, t), out in zip(dims, widths):
        c = torch.randn((out, n, dp1, t), generator=gen, device=device)
        params.append({
            "degrees": torch.randint(0, dp1, (out,), generator=gen,
                                     device=device, dtype=torch.int32),
            "coefficients": c * (1.0 / np.sqrt(n * dp1 * out)) * np.sqrt(3.0),
            "horizontal_weights": 0.5 + torch.rand(
                (out,), generator=gen, device=device),
        })
    return params
