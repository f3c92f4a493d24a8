"""Result plots: metric comparison, training time, degree distribution.

Counterpart of ``qkan_implementation_tpu.experiments.visualization``.
matplotlib (Agg backend, headless) is imported by each plot, so the
module imports on a machine without it.
"""

from __future__ import annotations

from typing import List

import numpy as np

from qkan_implementation_tpu_torch.experiments.evaluation import ModelResult


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


class ResultVisualizer:
    @staticmethod
    def plot_metrics_comparison(results: List[ModelResult], metric: str = "mse"):
        """Train-vs-validation bar chart per model."""
        plt = _pyplot()
        fig = plt.figure(figsize=(10, 6))
        models = [r.model_name for r in results]
        train_metrics = [r.train_metrics.get(metric, np.nan) for r in results]
        val_metrics = [r.val_metrics.get(metric, np.nan) for r in results]

        x = np.arange(len(models))
        width = 0.35
        plt.bar(x - width / 2, train_metrics, width, label="Train")
        plt.bar(x + width / 2, val_metrics, width, label="Validation")
        plt.xlabel("Models")
        plt.ylabel(metric.upper())
        plt.title(f"{metric.upper()} Comparison")
        plt.xticks(x, models, rotation=30, ha="right")
        plt.legend()
        fig.tight_layout()
        return fig

    @staticmethod
    def plot_training_time_comparison(results: List[ModelResult]):
        """Training-time bars."""
        plt = _pyplot()
        fig = plt.figure(figsize=(10, 6))
        models = [r.model_name for r in results]
        times = [r.train_time for r in results]
        plt.bar(models, times)
        plt.xlabel("Models")
        plt.ylabel("Training Time (s)")
        plt.title("Training Time Comparison")
        plt.xticks(rotation=30, ha="right")
        fig.tight_layout()
        return fig

    @staticmethod
    def plot_degree_distribution(qkan_result: ModelResult):
        """Histogram of selected polynomial degrees."""
        plt = _pyplot()
        degrees = qkan_result.model_params["degrees"]
        degrees_flat = [d for sublist in degrees for d in sublist]
        fig = plt.figure(figsize=(10, 6))
        bins = np.arange(min(degrees_flat), max(degrees_flat) + 2) - 0.5
        plt.hist(degrees_flat, bins=bins, rwidth=0.8)
        plt.xlabel("Polynomial Degree")
        plt.ylabel("Count")
        plt.title("Distribution of Polynomial Degrees")
        fig.tight_layout()
        return fig
