"""Shared optimizer plumbing: feature extraction and time-series CV folds.

Counterpart of ``qkan_implementation_tpu.optim.base`` (numpy; a pandas
DataFrame is taken by duck typing, so pandas is never imported here).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Dict, List, Tuple

import numpy as np
import torch


#: column names/prefixes that are never model inputs -- excluded from the
#: all-columns fallback so a frame carrying its target or date alongside
#: unprefixed features cannot silently leak them into the transforms
_NON_FEATURE_COLS = ("date_id", "weight", "weights")
_NON_FEATURE_PREFIXES = ("responder",)


def _extract_features(x_data) -> np.ndarray:
    """Accept a pandas DataFrame (select its ``feature_*`` columns), a
    torch tensor or an array.  A frame with no ``feature_*`` columns falls
    back to every column EXCEPT known label/date/weight names (logged) --
    feeding the target into the degree transforms would be silent
    leakage."""
    if hasattr(x_data, "filter") and hasattr(x_data, "columns"):  # DataFrame
        feats = [c for c in x_data.columns if str(c).startswith("feature_")]
        if feats:
            return x_data[feats].to_numpy()
        cols = [
            c
            for c in x_data.columns
            if str(c) not in _NON_FEATURE_COLS
            and not str(c).startswith(_NON_FEATURE_PREFIXES)
        ]
        dropped = [c for c in x_data.columns if c not in cols]
        if dropped:
            import logging

            logging.getLogger(__name__).warning(
                "No feature_* columns; using %d columns and excluding "
                "likely non-features %s", len(cols), dropped,
            )
        return x_data[cols].to_numpy()
    if isinstance(x_data, torch.Tensor):
        return x_data.detach().cpu().numpy()
    return np.asarray(x_data)


def _timestamp_values(timestamps, column: str = "date_id") -> np.ndarray:
    """Accept a DataFrame with a date column or a plain array of date ids."""
    if hasattr(timestamps, "columns"):
        return timestamps[column].to_numpy()
    if isinstance(timestamps, torch.Tensor):
        return timestamps.cpu().numpy()
    return np.asarray(timestamps)


class BaseOptimizer(ABC):
    """Base class for QKAN optimizers implementing shared functionality."""

    def __init__(self):
        pass

    # NOTE: the reference's _compute_collapsed_combinations fold cache
    # (BaseOptimizer.py:12-28) lives in DegreeOptimizer._cached_transforms,
    # which adds the LRU cap these full-basis entries need; a second
    # uncapped cache here would reintroduce the leak and drift.

    @abstractmethod
    def _compute_transforms(self, feature_data: np.ndarray) -> Dict[int, np.ndarray]:
        """Compute optimizer-specific transforms (child classes implement)."""

    def _get_expanding_window_folds(
        self,
        timestamps,
        data=None,
        n_splits: int = 5,
        initial_ratio: float = 0.6,
    ) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Expanding-window CV folds over unique sorted date ids.

        Train on the first ``initial + i*val_size`` dates, validate on the
        next ``val_size``.
        """
        ts = _timestamp_values(timestamps)
        unique = np.unique(ts)  # sorted
        n_times = len(unique)
        initial_train_size = int(n_times * initial_ratio)
        val_size = int((n_times - initial_train_size) / n_splits)

        folds = []
        for i in range(n_splits):
            train_end = initial_train_size + i * val_size
            train_times = unique[:train_end]
            val_times = unique[train_end : min(train_end + val_size, n_times)]
            folds.append(
                (np.isin(ts, train_times), np.isin(ts, val_times))
            )
        return folds

    def _get_time_based_folds(
        self, timestamps, data=None, n_splits: int = 5
    ) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Time-based CV folds: train on the first (i+1)/(n+1) of the
        dates, validate on the next 1/(n+1)."""
        ts = _timestamp_values(timestamps)
        unique = np.unique(ts)
        n_times = len(unique)
        folds = []
        for i in range(n_splits):
            split_idx = int((i + 1) * n_times // (n_splits + 1))
            val_end_idx = int((i + 2) * n_times // (n_splits + 1))
            train_times = unique[:split_idx]
            val_times = unique[split_idx:val_end_idx]
            folds.append((np.isin(ts, train_times), np.isin(ts, val_times)))
        return folds

    def _compute_validation_score(
        self, predictions: np.ndarray, y_true: np.ndarray
    ) -> float:
        """MSE validation score."""
        return float(np.mean((np.asarray(y_true) - np.asarray(predictions)) ** 2))

    def save_state(self, filename: str) -> None:  # overridden by children
        pass

    def load_state(self, filename: str, current_query_params: dict) -> None:
        pass
