"""Market-data pipeline: load, quantile normalisation, date split.

Counterpart of ``qkan_implementation_tpu.data.pipeline``, on numpy
columns instead of DataFrames:

- missing values become 3 (the reference's sentinel), the last
  ``n_rows`` rows are kept and sorted by date (pandas' quicksort order);
- every feature and the target are normalised to [-1, 1]: center =
  (q95 + q05) / 2, scale = (q95 - q05) / 2 with std and 1.0 as
  fallbacks, values beyond the quantiles clamped to exactly +/-1;
- the rows are split into train and validation by ``train_ratio`` over
  the unique dates.

The data are a dict of column name -> numpy array.  ``DataPipeline``
reads them from the config's parquet file (pandas and pyarrow, imported
by the reader) or takes the dict itself: the second route exists so a
machine without pandas can run the harness on the same columns
``market_columns`` generates and ``generate_market_parquet`` would write.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional, Tuple

import numpy as np

Columns = Dict[str, np.ndarray]


def read_parquet_columns(path, columns) -> Columns:
    """The named columns of a parquet file as numpy arrays (pandas)."""
    import pandas as pd

    df = pd.read_parquet(path, columns=list(columns))
    return {c: df[c].to_numpy() for c in columns}


class DataPipeline:
    """``load_and_preprocess_data`` returns (train features [n, F], train
    target [n, 1], train weight [n, 1], and the same three for the
    validation rows), float64; ``last_train_dates`` / ``last_val_dates``
    keep each row's date for time-fold cross-validation."""

    def __init__(
        self,
        config,
        logger: logging.Logger | None = None,
        columns: Optional[Columns] = None,
    ):
        self.config = config
        self.logger = logger or logging.getLogger(__name__)
        self.columns = columns

    def load_and_preprocess_data(self) -> Tuple[np.ndarray, ...]:
        cfg = self.config
        names = [cfg.date_col, cfg.target_col, cfg.weight_col,
                 *cfg.feature_cols]
        if self.columns is None:
            cols = read_parquet_columns(cfg.data_path, names)
        else:
            cols = {c: np.asarray(self.columns[c]) for c in names}
        n = len(cols[cfg.date_col])
        keep = slice(max(n - cfg.n_rows, 0), n)  # tail(n_rows)
        cols = {c: _fill_missing(v)[keep] for c, v in cols.items()}
        # pandas' sort_values: a quicksort argsort of the date column
        order = np.argsort(cols[cfg.date_col], kind="quicksort")
        cols = {c: v[order] for c, v in cols.items()}
        return self._train_val_split(self._normalize_features(cols))

    def _normalize_features(self, cols: Columns) -> Columns:
        """Quantile clamp of the features and the target to [-1, 1]."""
        cfg = self.config
        out = {cfg.date_col: cols[cfg.date_col],
               cfg.weight_col: cols[cfg.weight_col]}
        for col in [*cfg.feature_cols, cfg.target_col]:
            vals = np.asarray(cols[col], dtype=np.float64)
            q05, q95 = np.quantile(vals, [0.05, 0.95])
            std = vals.std()
            center = (q95 + q05) / 2
            if abs(q95 - q05) > 1e-10:
                scale = (q95 - q05) / 2
            elif std > 1e-10:
                scale = std
            else:
                scale = 1.0
            out[f"{col}_normalized"] = np.where(
                vals > q95,
                1.0,
                np.where(vals < q05, -1.0, (vals - center) / scale),
            )
        return out

    def _train_val_split(self, cols: Columns):
        cfg = self.config
        dates = cols[cfg.date_col]
        unique_dates = np.unique(dates)  # sorted
        split_idx = int(len(unique_dates) * cfg.train_ratio)
        train_mask = np.isin(dates, unique_dates[:split_idx])
        val_mask = ~train_mask
        feats = np.stack(
            [cols[f"{c}_normalized"] for c in cfg.feature_cols], axis=1
        )
        target = cols[f"{cfg.target_col}_normalized"].reshape(-1, 1)
        weight = np.asarray(cols[cfg.weight_col],
                            dtype=np.float64).reshape(-1, 1)
        self.last_train_dates = dates[train_mask]
        self.last_val_dates = dates[val_mask]
        return (
            feats[train_mask], target[train_mask], weight[train_mask],
            feats[val_mask], target[val_mask], weight[val_mask],
        )


def _fill_missing(v: np.ndarray) -> np.ndarray:
    """fillna(3): NaN -> 3 in a float column; other columns unchanged."""
    v = np.asarray(v)
    if np.issubdtype(v.dtype, np.floating):
        return np.where(np.isnan(v), v.dtype.type(3), v)
    return v


# Calibrated per-profile signal fractions (the JAX package's
# market_top_calibration.json and its hard-profile sweep).
PROFILE_SIGNAL_FRAC = {"hard": 0.10, "top": 0.50}


def market_columns(
    n_rows: int = 5000,
    n_features: int = 79,
    n_dates: int = 50,
    seed: int = 0,
    target_col: str = "responder_6",
    profile: str = "demo",
    signal_frac: float | None = None,
) -> Columns:
    """Synthetic Jane-Street-shaped columns: date_id, weight,
    feature_00..feature_NN (~2 % NaN), the target.

    The same numbers as the JAX package's ``generate_market_parquet``:
    one ``np.random.default_rng(seed)`` stream, drawn in its order.
    ``profile``: ``'demo'`` a strong stationary signal; ``'hard'`` the
    reference's real-data regime (heavy-tailed factor features, a weak
    signal with an interaction term, per-date coefficient drift,
    volatility-scaled weights: the 250k-row degree-3 search scores val
    MSE 0.2449 / comp-R^2 0.0462 at the default ``signal_frac``);
    ``'top'`` its curated-feature regime (additive cubic signal, t(8)
    tails, slow drift).  ``signal_frac=None`` takes the profile's entry
    of ``PROFILE_SIGNAL_FRAC``.
    """
    rng = np.random.default_rng(seed)
    dates = np.sort(rng.integers(0, n_dates, n_rows))
    data = {"date_id": dates}
    if profile == "demo":
        feats = rng.normal(size=(n_rows, n_features))
        target = (
            0.6 * feats[:, 0]
            + 0.4 * (feats[:, 1] ** 2 - 1)
            - 0.3 * feats[:, 2]
            + 0.2 * rng.normal(size=n_rows)
        )
        data["weight"] = rng.uniform(0.5, 2.0, n_rows)
    elif profile in ("hard", "top"):
        if n_features < 6:
            raise ValueError(
                f"profile={profile!r} needs n_features >= 6 (its signal "
                f"uses the first 6 columns, incl. the s4*s5 interaction); "
                f"got {n_features}"
            )
        if profile == "hard":
            if signal_frac is None:
                signal_frac = PROFILE_SIGNAL_FRAC["hard"]
            drift_scale, tail_df, noise_df, feat_scale, interaction = (
                0.12, 4, 3, 1.0, True
            )
        else:
            if signal_frac is None:
                signal_frac = PROFILE_SIGNAL_FRAC["top"]
            drift_scale, tail_df, noise_df, feat_scale, interaction = (
                0.02, 8, 5, 0.5, False
            )
        n_factors = 8
        loadings = rng.normal(0, 1, (n_features, n_factors)) * (
            rng.uniform(size=(n_features, n_factors)) < 0.3
        )
        factors = rng.standard_t(tail_df, size=(n_rows, n_factors))
        feats = feat_scale * (
            0.6 * factors @ loadings.T
            + rng.standard_t(tail_df, size=(n_rows, n_features))
        )
        # per-date random-walk drift of the signal coefficients: the
        # date-split validation rows score a shifted regime
        k_sig = 6
        betas = rng.normal(0, 1, k_sig) + np.cumsum(
            rng.normal(0, drift_scale, (n_dates, k_sig)), axis=0
        )
        b = betas[dates]
        s = feats[:, :k_sig]
        # 'top' builds its terms on clipped features (bounded term
        # variance); 'hard' keeps the raw terms
        sc = s if interaction else np.clip(s, -2.0, 2.0)
        terms = np.column_stack(
            [
                sc[:, 0],
                sc[:, 1] ** 2 - 1.0,
                np.tanh(sc[:, 2]),
                sc[:, 3],
                sc[:, 4] * sc[:, 5] if interaction else sc[:, 4] ** 3,
                sc[:, 5],
            ]
        )
        signal = (b * terms).sum(axis=1)
        signal /= signal.std() + 1e-12
        noise = rng.standard_t(noise_df, size=n_rows)
        noise /= noise.std() + 1e-12
        target = np.sqrt(signal_frac) * signal + np.sqrt(
            1.0 - signal_frac
        ) * noise
        # volatility-aware weights: high-|factor| rows sized down
        date_vol = np.abs(factors[:, 0]) + 0.5
        data["weight"] = rng.lognormal(0.0, 0.4, n_rows) / date_vol
    else:
        raise ValueError(f"unknown profile {profile!r}")
    for i in range(n_features):
        col = feats[:, i].copy()
        col[rng.uniform(size=n_rows) < 0.02] = np.nan
        data[f"feature_{i:02d}"] = col
    data[target_col] = target
    return data


def generate_market_parquet(
    path: str,
    n_rows: int = 5000,
    n_features: int = 79,
    n_dates: int = 50,
    seed: int = 0,
    target_col: str = "responder_6",
    profile: str = "demo",
    signal_frac: float | None = None,
) -> str:
    """Write ``market_columns`` of the same arguments to a parquet file
    (pandas)."""
    import pandas as pd

    pd.DataFrame(market_columns(
        n_rows, n_features, n_dates, seed, target_col, profile, signal_frac,
    )).to_parquet(path)
    return path
