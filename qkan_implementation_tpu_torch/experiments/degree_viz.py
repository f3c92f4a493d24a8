"""Degree-optimization visualization utilities.

Counterpart of ``qkan_implementation_tpu.experiments.degree_viz``:
per-degree prediction overlays, best-fit highlight, selected-degree
histogram, log-scale error-vs-degree plots, and a fit of one of the
pathological test functions.  Headless (Agg); figures are returned and
optionally saved rather than shown.  matplotlib is imported by each
plot, so the module imports on a machine without it.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from qkan_implementation_tpu_torch.experiments.visualization import _pyplot
from qkan_implementation_tpu_torch.ops.chebyshev import chebyshev_basis
from qkan_implementation_tpu_torch.optim.degree_optimizer import (
    DegreeOptimizer,
)


def _per_degree_predictions(optimizer: DegreeOptimizer, x_sorted, y_sorted):
    """Cumulative-degree lstsq predictions per degree (the overlay data);
    the basis on the optimizer's device."""
    basis = chebyshev_basis(
        torch.from_numpy(np.ascontiguousarray(x_sorted, dtype=np.float64))
        .to(optimizer.device),
        optimizer.max_degree, clip=True,
    ).cpu().numpy()
    predictions, scores = [], []
    for d in range(optimizer.max_degree + 1):
        X = basis[:, :, : d + 1].reshape(len(x_sorted), -1)
        coeffs = np.linalg.lstsq(X, y_sorted, rcond=None)[0]
        pred = X @ coeffs
        predictions.append(pred)
        scores.append(float(np.mean((y_sorted - pred) ** 2)))
    return predictions, scores


def plot_degree_optimization(
    optimizer: DegreeOptimizer,
    x_data,
    y_data,
    title: str = "Degree Optimization Results",
):
    """Three-panel overview: data, degree histogram, error-vs-degree."""
    plt = _pyplot()
    x_np = np.asarray(x_data).reshape(len(np.asarray(y_data)), -1)
    y_np = np.asarray(y_data).reshape(-1, 1)

    fig = plt.figure(figsize=(15, 5))
    plt.subplot(1, 3, 1)
    plt.scatter(x_np[:, 0], y_np, alpha=0.5, label="Data")
    plt.title("Data and Approximation")
    plt.xlabel("x")
    plt.ylabel("y")
    plt.legend()

    plt.subplot(1, 3, 2)
    degrees = [d for sub in optimizer.optimal_degrees for d in sub]
    plt.hist(degrees, bins=range(max(degrees) + 2), alpha=0.7)
    plt.title("Distribution of Selected Degrees")
    plt.xlabel("Degree")
    plt.ylabel("Count")

    plt.subplot(1, 3, 3)
    scores, comp_r2 = optimizer.evaluate_degree(x_np, y_np)
    rng = range(len(scores))
    plt.plot(rng, scores, "b-", label="MSE")
    plt.plot(rng, comp_r2, "r--", label="R2")
    plt.title("Error Metrics vs Degree")
    plt.xlabel("Degree")
    plt.ylabel("Error")
    plt.legend()

    plt.suptitle(title)
    fig.tight_layout()
    return fig


def plot_degree_optimization_improved(
    optimizer: DegreeOptimizer,
    x_data,
    y_data,
    title: str = "Degree Optimization Results",
):
    """Four-panel version with per-degree prediction overlays and best-fit
    highlight.  Multi-feature inputs plot against the first feature."""
    plt = _pyplot()
    y_np = np.asarray(y_data).reshape(-1, 1)
    x_np = np.asarray(x_data).reshape(len(y_np), -1)
    sort_idx = np.argsort(x_np[:, 0])
    x_sorted = x_np[sort_idx]
    y_sorted = y_np[sort_idx]

    predictions, scores = _per_degree_predictions(optimizer, x_sorted, y_sorted)
    best_degree = int(np.argmin(scores))

    fig = plt.figure(figsize=(15, 10))
    plt.subplot(2, 2, 1)
    plt.scatter(x_np[:, 0], y_np, alpha=0.3, label="Data", color="gray")
    colors = plt.cm.viridis(np.linspace(0, 1, optimizer.max_degree + 1))
    for d, pred in enumerate(predictions):
        plt.plot(
            x_sorted[:, 0], pred, "--", alpha=0.7, color=colors[d],
            label=f"Degree {d}"
        )
    plt.title("Data and Predictions by Degree")
    plt.xlabel("x")
    plt.ylabel("y")
    plt.legend(bbox_to_anchor=(1.05, 1), loc="upper left")

    plt.subplot(2, 2, 2)
    plt.scatter(x_np[:, 0], y_np, alpha=0.3, label="Data", color="gray")
    plt.plot(
        x_sorted[:, 0],
        predictions[best_degree],
        "r-",
        linewidth=2,
        label=f"Best Fit (Degree {best_degree})",
    )
    plt.title(f"Best Fit (Degree {best_degree})")
    plt.xlabel("x")
    plt.ylabel("y")
    plt.legend()

    plt.subplot(2, 2, 3)
    degrees = [d for sub in optimizer.optimal_degrees for d in sub]
    plt.hist(degrees, bins=range(max(degrees) + 2), alpha=0.7)
    plt.axvline(
        x=best_degree, color="r", linestyle="--", label=f"Best Degree ({best_degree})"
    )
    plt.title("Distribution of Selected Degrees")
    plt.xlabel("Degree")
    plt.ylabel("Count")
    plt.legend()

    plt.subplot(2, 2, 4)
    plt.plot(range(len(scores)), scores, "b-", label="MSE")
    plt.axvline(
        x=best_degree, color="r", linestyle="--", label=f"Best Degree ({best_degree})"
    )
    plt.title("Error Metrics vs Degree")
    plt.xlabel("Degree")
    plt.ylabel("Error")
    plt.yscale("log")
    plt.legend()

    plt.suptitle(title)
    fig.tight_layout()
    return fig


TEST_FUNCTIONS: Dict[str, Callable[[np.ndarray], np.ndarray]] = {
    # the reference's four pathological targets
    "polynomial": lambda x: 0.5 * x**3 - 0.3 * x**2 + 0.1 * x,
    "oscillatory": lambda x: np.sin(5 * np.pi * x),
    "discontinuous": lambda x: np.sign(x) * np.abs(x) ** 0.5,
    "runge": lambda x: 1.0 / (1.0 + 25.0 * x**2),
}


def run_interactive_test(
    function_name: str = "polynomial",
    n_points: int = 200,
    max_degree: int = 7,
    noise: float = 0.02,
    save_path: Optional[str] = None,
    seed: int = 0,
    device="cuda",
):
    """Fit and visualize one of the hard test functions, the degree
    search on ``device``."""
    if function_name not in TEST_FUNCTIONS:
        raise ValueError(
            f"Unknown function {function_name!r}; pick from {list(TEST_FUNCTIONS)}"
        )
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(-1, 1, n_points)).reshape(-1, 1)
    y = TEST_FUNCTIONS[function_name](x) + noise * rng.normal(size=(n_points, 1))

    optimizer = DegreeOptimizer(network_shape=[1, 1], max_degree=max_degree,
                                device=device)
    optimizer.fit(x, y, num_reads=256, num_sweeps=500)
    fig = plot_degree_optimization_improved(
        optimizer, x, y, title=f"Degree Optimization: {function_name}"
    )
    if save_path:
        fig.savefig(save_path)
    return optimizer, fig
