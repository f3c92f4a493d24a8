"""Model evaluation records and summaries.

Counterpart of ``qkan_implementation_tpu.experiments.evaluation``; the
summary is a list of row dicts (the JAX package builds a pandas frame of
the same rows and columns), which ``experiments.main`` writes as CSV.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from qkan_implementation_tpu_torch.utils.metrics import mse, r2_score

SUMMARY_COLUMNS = ("model", "mse", "r2", "train_time")


@dataclass
class ModelResult:
    model_name: str
    MSE_Score: float
    R2_Score: float
    train_time: float
    model_params: Dict[str, Any]
    train_metrics: Dict[str, float] = field(default_factory=dict)
    val_metrics: Dict[str, float] = field(default_factory=dict)


class ModelEvaluator:
    @staticmethod
    def evaluate_predictions(
        y_true: np.ndarray,
        y_pred: np.ndarray,
        weights: Optional[np.ndarray] = None,
    ) -> Dict[str, float]:
        """MSE and R^2, optionally sample-weighted."""
        return {
            "mse": mse(y_true, y_pred, weights),
            "r2": r2_score(y_true, y_pred, weights),
        }

    @staticmethod
    def create_evaluation_summary(results: List[ModelResult]) -> List[dict]:
        """One row dict a result: ``SUMMARY_COLUMNS``."""
        return [
            {
                "model": r.model_name,
                "mse": r.MSE_Score,
                "r2": r.R2_Score,
                "train_time": r.train_time,
            }
            for r in results
        ]
