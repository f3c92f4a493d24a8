"""Sampling diagnostics for classification datasets.

A numpy copy of ``qkan_implementation_tpu.analysis.mnist_diagnostics``;
matplotlib is imported only inside ``plot_sample_distributions``.

Rebuild of ``mnist_sampling_diagnostics.py`` (reference ``:8-120``) without
torch/torchvision: class-distribution analysis of a sample vs the full
dataset, multi-run sampling-consistency comparison, and distribution plots.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


def analyze_sample_distribution(
    x_train: np.ndarray,
    y_train_labels: np.ndarray,
    full_labels: Optional[np.ndarray] = None,
    num_classes: int = 10,
    verbose: bool = True,
) -> Dict:
    """Class-distribution + pixel statistics of a sample, optionally compared
    to the full dataset (reference analyze_mnist_sample :8-61)."""
    y = np.asarray(y_train_labels)
    # widen num_classes to cover any out-of-range label in EITHER array so
    # the sample-vs-full percentage diff always broadcasts (bincount with
    # minlength alone yields different lengths when one side holds a label
    # >= num_classes)
    if full_labels is not None and len(np.asarray(full_labels)):
        num_classes = max(
            num_classes, int(np.asarray(full_labels).max()) + 1
        )
    if len(y):
        num_classes = max(num_classes, int(y.max()) + 1)
    class_counts = np.bincount(y, minlength=num_classes)
    class_percentages = class_counts / max(len(y), 1) * 100

    if verbose:
        print("\nClass Distribution:")
        for digit in range(num_classes):
            print(
                f"Digit {digit}: {class_counts[digit]} samples "
                f"({class_percentages[digit]:.1f}%)"
            )

    max_diff = None
    if full_labels is not None:
        full_counts = np.bincount(np.asarray(full_labels), minlength=num_classes)
        full_percentages = full_counts / max(len(full_labels), 1) * 100
        diffs = np.abs(class_percentages - full_percentages)
        max_diff = float(diffs.max())
        if verbose:
            print("\nComparison with Full Dataset:")
            for digit in range(num_classes):
                print(
                    f"Digit {digit}: Sample {class_percentages[digit]:.1f}% vs "
                    f"Full {full_percentages[digit]:.1f}% (diff: {diffs[digit]:.1f}%)"
                )
            print(f"\nMaximum distribution difference: {max_diff:.1f}%")

    x = np.asarray(x_train)
    if verbose:
        print("\nSample Statistics:")
        print(f"Total samples: {len(x)}")
        print(f"Min samples per class: {class_counts.min()}")
        print(f"Max samples per class: {class_counts.max()}")
        print(f"Std dev of class counts: {class_counts.std(ddof=1):.1f}")
        print("\nImage Statistics:")
        print(f"Mean pixel value: {x.mean():.3f}")
        print(f"Std dev pixel value: {x.std():.3f}")

    return {
        "class_counts": class_counts,
        "class_percentages": class_percentages,
        "max_distribution_diff": max_diff,
        "statistics": {
            "total_samples": len(x),
            "min_samples": int(class_counts.min()),
            "max_samples": int(class_counts.max()),
            "std_dev": float(class_counts.std(ddof=1)),
        },
    }


def compare_multiple_samples(
    x: np.ndarray,
    y: np.ndarray,
    sample_size: int,
    num_runs: int = 5,
    num_classes: int = 10,
    seed: int = 0,
    verbose: bool = True,
) -> Dict:
    """Sampling-consistency analysis across random subsets
    (reference compare_multiple_samples :63-98)."""
    rng = np.random.default_rng(seed)
    results = []
    for run in range(num_runs):
        if verbose:
            print(f"\n=== Run {run + 1} ===")
        idx = rng.permutation(len(x))[:sample_size]
        results.append(
            analyze_sample_distribution(
                x[idx], y[idx], full_labels=y, num_classes=num_classes,
                verbose=verbose,
            )
        )

    class_variations = np.zeros(num_classes)
    for digit in range(num_classes):
        percentages = np.array(
            [r["class_percentages"][digit] for r in results]
        )
        class_variations[digit] = percentages.std(ddof=1)
        if verbose:
            print(
                f"Digit {digit} percentage std dev across runs: "
                f"{class_variations[digit]:.2f}%"
            )
    if verbose:
        print(f"\nAverage class percentage variation: {class_variations.mean():.2f}%")
        print(f"Max class percentage variation: {class_variations.max():.2f}%")

    return {
        "sample_results": results,
        "variations": {
            "per_class": class_variations,
            "mean": float(class_variations.mean()),
            "max": float(class_variations.max()),
        },
    }


def plot_sample_distributions(results: List[Dict], num_classes: int = 10):
    """Bar chart of class distributions across runs (reference :99-120)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    num_runs = len(results)
    fig, ax = plt.subplots(figsize=(12, 6))
    # analyze_sample_distribution widens past num_classes when labels
    # exceed the nominal range -- bar against the actual array length so
    # the two can't mismatch
    num_classes = max(
        num_classes,
        *(len(np.asarray(r["class_percentages"])) for r in results),
    )
    x = np.arange(num_classes)
    width = 0.8 / num_runs
    for i, result in enumerate(results):
        pct = np.asarray(result["class_percentages"], dtype=float)
        if len(pct) < num_classes:
            pct = np.pad(pct, (0, num_classes - len(pct)))
        ax.bar(
            x + i * width,
            pct,
            width,
            label=f"Run {i+1}",
            alpha=0.7,
        )
    ax.set_xlabel("Digit Class")
    ax.set_ylabel("Percentage in Sample")
    ax.set_title("Class Distribution Across Multiple Sampling Runs")
    ax.set_xticks(x + width * (num_runs - 1) / 2)
    ax.set_xticklabels(range(num_classes))
    ax.legend()
    ax.grid(True, alpha=0.3)
    return fig
