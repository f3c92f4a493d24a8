"""Saved-model analysis: degrees, coefficients, sparsity, comparisons.

Counterpart of ``qkan_implementation_tpu.analysis.model_analysis``, a
rebuild of ``analyze_model_utils.py`` (reference ``:9-243``) over FixedKAN
.npz checkpoints: walk each layer's stored degrees/coefficients, compute
per-layer statistics (including the reference's coefficient-sparsity
measure ``mean(|c| < 1e-6)``, analyze_model_utils.py:117), and render
cross-model comparison plots.  The checkpoints are the npz that both
packages write byte for byte alike, so a model saved by either is read
here; the statistics are numpy on the host.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np


def extract_degrees_from_checkpoint(model_file: str, *,
                                    device="cuda") -> Dict:
    """Per-layer degrees and coefficients from a FixedKAN .npz checkpoint
    (the analog of walking ``layers.{i}.neurons.{j}._selected_degree`` keys,
    reference :20-87), as numpy arrays.  Parsing delegates to
    ``FixedKAN.load_model`` onto ``device`` -- one source of truth for the
    checkpoint layout, so format changes cannot silently diverge between
    loading and analysis."""
    from dataclasses import asdict

    from qkan_implementation_tpu_torch.models.fixed_kan import FixedKAN
    from qkan_implementation_tpu_torch.utils.convert import params_to_numpy

    kan = FixedKAN.load_model(model_file, device=device)
    return {"config": asdict(kan.config),
            "layers": params_to_numpy(kan.params)}


def compute_model_stats(model_info: Dict) -> Dict:
    """Per-layer stats: degree histogram, coefficient norms + sparsity
    (reference :89-127)."""
    stats = {"layers": [], "config": model_info["config"]}
    all_degrees = []
    for layer_idx, layer in enumerate(model_info["layers"]):
        degrees = np.asarray(layer["degrees"])
        coeffs = np.asarray(layer["coefficients"])
        all_degrees.extend(degrees.tolist())
        stats["layers"].append(
            {
                "layer": layer_idx,
                "num_neurons": len(degrees),
                "degrees": degrees.tolist(),
                "mean_degree": float(degrees.mean()),
                "max_degree": int(degrees.max()),
                "coeff_norm": float(np.linalg.norm(coeffs)),
                "coeff_sparsity": float(np.mean(np.abs(coeffs) < 1e-6)),
                "mean_abs_horizontal_weight": float(
                    np.abs(layer["horizontal_weights"]).mean()
                ),
            }
        )
    stats["degree_histogram"] = np.bincount(
        np.asarray(all_degrees, dtype=int),
        minlength=model_info["config"]["max_degree"] + 1,
    ).tolist()
    return stats


def analyze_models(
    model_files: List[str],
    json_files: Optional[List[str]] = None,
    make_plots: bool = False,
    *,
    device="cuda",
):
    """Analyze + optionally plot a set of saved models (reference :191-228).

    ``json_files`` are experiment-result JSONs (accuracy/timing records, as
    written by the MNIST pipeline); matched positionally to ``model_files``.
    The models load onto ``device``.  Returns a list of stats dicts; with
    ``make_plots=True`` also returns the matplotlib figure (matplotlib is
    imported then, and only then).
    """
    all_stats = []
    for i, model_file in enumerate(model_files):
        info = extract_degrees_from_checkpoint(model_file, device=device)
        stats = compute_model_stats(info)
        stats["model_file"] = str(model_file)
        if json_files and i < len(json_files) and Path(json_files[i]).exists():
            with open(json_files[i]) as f:
                stats["results"] = json.load(f)
        all_stats.append(stats)

    if not make_plots:
        return all_stats

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 3, figsize=(18, 5))
    for stats in all_stats:
        name = Path(stats["model_file"]).stem
        hist = stats["degree_histogram"]
        axes[0].plot(range(len(hist)), hist, marker="o", label=name)
        axes[1].plot(
            [l["layer"] for l in stats["layers"]],
            [l["mean_degree"] for l in stats["layers"]],
            marker="s",
            label=name,
        )
        axes[2].plot(
            [l["layer"] for l in stats["layers"]],
            [l["coeff_sparsity"] for l in stats["layers"]],
            marker="^",
            label=name,
        )
    axes[0].set_title("Degree Distribution")
    axes[0].set_xlabel("Degree")
    axes[0].set_ylabel("Count")
    axes[1].set_title("Mean Degree per Layer")
    axes[1].set_xlabel("Layer")
    axes[2].set_title("Coefficient Sparsity per Layer")
    axes[2].set_xlabel("Layer")
    for ax in axes:
        ax.legend()
        ax.grid(True, alpha=0.3)
    fig.tight_layout()
    return all_stats, fig
