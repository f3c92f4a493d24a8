"""MNIST / digits classification pipeline for FixedKAN, on torch.

Counterpart of ``qkan_implementation_tpu.experiments.mnist``, the
reference's MNIST workload (``fixed_kan_tests.py:293-475``):
sample a training subset, one-hot the targets, run QUBO structure
optimization (optionally + weight training), evaluate train/test accuracy,
and save accuracy-stamped JSON results + model artifacts.  A multi-run
statistical harness mirrors ``test_mnist_n_times`` and feeds the sampling
diagnostics.  Structure search, training and evaluation run on
``device`` (the card unless the caller asks for the CPU); numpy data
enters as torch's default dtype, as it enters JAX as its default.
"""

from __future__ import annotations

import json
import time
from datetime import datetime
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from qkan_implementation_tpu_torch.analysis.mnist_diagnostics import (
    analyze_sample_distribution,
)
from qkan_implementation_tpu_torch.data.mnist import (
    load_digits_784,
    load_mnist,
    sample_train_subset,
    to_one_hot,
)
from qkan_implementation_tpu_torch.models.fixed_kan import (
    FixedKAN,
    FixedKANConfig,
)

# one shared converter for every JSON record
from qkan_implementation_tpu_torch.utils.run_records import (
    to_jsonable as _jsonable,
)


def _as_default(a: np.ndarray) -> torch.Tensor:
    """float64 numpy -> torch's default float dtype (``jnp.asarray``'s
    rule); other dtypes as they are."""
    dtype = torch.get_default_dtype() if a.dtype == np.float64 else None
    return torch.as_tensor(a, dtype=dtype)


def run_mnist_experiment(
    network_shape: Optional[List[int]] = None,
    max_degree: int = 5,
    train_size: int = 10000,
    complexity_weight: float = 0.1,
    weight_epochs: int = 0,
    learning_rate: float = 0.002,
    data_root: Optional[str] = None,
    save_dir: Optional[str] = None,
    seed: int = 0,
    solver: str = "anneal",
    num_reads: int = 1000,
    degree_objective: str = "reference",
    consistent_tanh: bool = False,
    dataset: str = "auto",
    lstsq_method: str = "svd",
    weight_trainable: str = "horizontal",
    weight_lr_scale: str = "none",
    weight_lr_schedule: str = "none",
    weight_grad_clip: float | None = None,
    weight_batch_size: int = 64,
    weight_backend: str = "xla",
    weight_compute_dtype=None,
    weight_matmul_precision: str | None = "auto",
    verbose: bool = True,
    device="cuda",
) -> Dict:
    """One full structure-optimization + evaluation run.

    ``dataset``: 'auto' resolves real MNIST then digits (data.mnist);
    'digits-784' runs the reference's exact [784, ...] workload shape on
    bilinearly upsampled (and, when train_size exceeds the corpus,
    shift/noise-augmented) sklearn digits -- honestly labeled, never
    presented as MNIST.

    Defaults mirror the reference experiment config
    (fixed_kan_tests.py:297-303): shape [input, 32, 16, 16, 10], degree 5,
    10k training samples.  Returns the results dict (also written to JSON
    when ``save_dir`` is given, with the reference's accuracy-stamped
    naming).  ``results["_model"]`` is the trained ``FixedKAN`` on
    ``device``.
    """
    start_time = time.time()
    if dataset == "digits-784":
        x_train_full, y_train_full, meta = load_digits_784(
            train=True, augment_to=train_size, seed=seed
        )
        x_test, y_test, _ = load_digits_784(train=False)
    else:
        x_train_full, y_train_full, meta = load_mnist(root=data_root, train=True)
        x_test, y_test, _ = load_mnist(root=data_root, train=False)

    input_dim = meta["image_dim"]
    if network_shape is None:
        network_shape = [input_dim, 32, 16, 16, 10]
    if network_shape[0] != input_dim:
        network_shape = [input_dim, *network_shape[1:]]
    train_size = min(train_size, len(x_train_full))

    x_train, y_train_labels = sample_train_subset(
        x_train_full, y_train_full, train_size, seed=seed
    )
    y_train = to_one_hot(y_train_labels, 10)

    config = FixedKANConfig(
        network_shape=network_shape,
        max_degree=max_degree,
        complexity_weight=complexity_weight,
        degree_objective=degree_objective,
        consistent_tanh=consistent_tanh,
        lstsq_method=lstsq_method,
    )
    kan = FixedKAN(config, device=device)

    structure_start = time.time()
    if verbose:
        print("Phase 1: Optimizing network structure with QUBO...")
    kan.optimize(
        _as_default(x_train),
        _as_default(y_train),
        solver=solver,
        num_reads=num_reads,
        seed=seed,
    )
    structure_time = time.time() - structure_start

    weight_time = 0.0
    train_losses: list = []
    train_diverged = False
    if weight_epochs > 0:
        if verbose:
            print("Phase 2: Training horizontal weights...")
        weight_start = time.time()
        kan.train(
            _as_default(x_train),
            torch.as_tensor(y_train_labels),
            epochs=weight_epochs,
            learning_rate=learning_rate,
            trainable=weight_trainable,
            lr_scale=weight_lr_scale,
            lr_schedule=weight_lr_schedule,
            grad_clip=weight_grad_clip,
            batch_size=weight_batch_size,
            seed=seed,
            backend=weight_backend,
            compute_dtype=weight_compute_dtype,
            matmul_precision=weight_matmul_precision,
        )
        weight_time = time.time() - weight_start
        train_losses = [float(l) for l in kan.last_train_losses]
        train_diverged = kan.last_train_diverged
        # record the RESOLVED precision ('auto' -> what actually ran)
        weight_matmul_precision = kan.last_matmul_precision
    else:
        # weight phase skipped: an unresolved 'auto' in the record would
        # read as provenance for a phase that never ran
        weight_matmul_precision = "not-trained"

    def accuracy(x, labels):
        with torch.no_grad():
            pred = kan(_as_default(x)).argmax(dim=1).cpu().numpy()
        return float((pred == labels).mean())

    train_accuracy = accuracy(x_train, y_train_labels)
    test_accuracy = accuracy(x_test, y_test)
    total_time = time.time() - start_time

    results = {
        "date": datetime.now().strftime("%b-%d-%Y-%I-%M-%S"),
        "dataset": meta["source"],
        "train_size": train_size,
        "network_shape": network_shape,
        "max_degree": max_degree,
        "complexity_weight": complexity_weight,
        "weight_epochs": weight_epochs,
        "weight_backend": weight_backend,
        "weight_compute_dtype": str(weight_compute_dtype)
        if weight_compute_dtype is not None
        else None,
        "weight_lr_schedule": weight_lr_schedule,
        "weight_batch_size": weight_batch_size,
        "weight_matmul_precision": weight_matmul_precision,
        "learning_rate": learning_rate,
        "test_size": len(x_test),
        "metrics": {
            "train_accuracy": train_accuracy,
            "test_accuracy": test_accuracy,
            "structure_time_seconds": structure_time,
            "weight_time_seconds": weight_time,
            "total_time_seconds": total_time,
            "train_diverged": train_diverged,
            "train_epoch_losses": train_losses,
        },
    }

    if verbose:
        print(f"Structure Optimization Time: {structure_time:.2f} seconds")
        print(f"Total Time: {total_time:.2f} seconds")
        print(f"Train Accuracy: {train_accuracy:.4f}")
        print(f"Test Accuracy: {test_accuracy:.4f}")

    if save_dir is not None:
        out = Path(save_dir)
        out.mkdir(parents=True, exist_ok=True)
        stamp = datetime.now().strftime("%H-%M-%S")
        results_file = out / f"mnist_kan_results_acc_{test_accuracy:.4f}_{stamp}.json"
        with open(results_file, "w") as f:
            json.dump(results, f, indent=4)
        model_file = out / f"mnist_kan_model_{test_accuracy:.4f}.npz"
        kan.save_model(str(model_file))
        results["results_file"] = str(results_file)
        results["model_file"] = str(model_file)

    results["_model"] = kan
    return results


def run_mnist_n_times(
    n: int = 5, verbose: bool = False, ensemble: bool = False,
    **experiment_kwargs
) -> Dict:
    """Statistical harness: n runs with different sampling seeds plus
    distribution diagnostics (reference test_mnist_n_times, :411-475).

    ``ensemble=True`` additionally evaluates the n seed-varied models as
    one soft-voting ensemble (mean softmax over members) on the shared
    fixed test split -- the members are already trained for the
    statistics, so the ensemble row is free capability on top of the
    reference's n-run protocol.  Adds ``ensemble_test_accuracy``.
    """
    all_results = []
    distributions = []
    models = []
    base_seed = int(experiment_kwargs.pop("seed", 0))
    # diagnostics must describe the SAME corpus the runs train on -- with
    # dataset='digits-784' sampling load_mnist here would measure class
    # balance of data the experiment never saw
    def load_corpus(seed):
        if experiment_kwargs.get("dataset") == "digits-784":
            # per-RUN seed: the augmented corpus itself is seed-dependent
            # (augment indices/shifts), so a base-seed corpus would
            # mis-describe every run past the first
            return load_digits_784(
                train=True,
                augment_to=experiment_kwargs.get("train_size", 10000),
                seed=seed,
            )[:2]
        return load_mnist(
            root=experiment_kwargs.get("data_root"), train=True
        )[:2]

    x_full, y_full = load_corpus(base_seed)
    for run in range(n):
        res = run_mnist_experiment(
            seed=base_seed + run, verbose=verbose, **experiment_kwargs
        )
        model = res.pop("_model", None)
        if ensemble:
            models.append(model)
        all_results.append(res)
        if run > 0 and experiment_kwargs.get("dataset") == "digits-784":
            x_full, y_full = load_corpus(base_seed + run)
        train_size = min(
            experiment_kwargs.get("train_size", 10000), len(x_full)
        )
        x_s, y_s = sample_train_subset(
            x_full, y_full, train_size, seed=base_seed + run
        )
        distributions.append(
            analyze_sample_distribution(
                x_s, y_s, full_labels=y_full, verbose=False
            )
        )

    accs = np.array([r["metrics"]["test_accuracy"] for r in all_results])
    ensemble_acc = None
    if ensemble:
        # the test split is FIXED across seeds (only train sampling
        # varies), so member predictions are comparable row-for-row
        if experiment_kwargs.get("dataset") == "digits-784":
            x_test, y_test, _ = load_digits_784(train=False)
        else:
            x_test, y_test, _ = load_mnist(
                root=experiment_kwargs.get("data_root"), train=False
            )
        with torch.no_grad():
            probs = np.mean(
                [
                    torch.softmax(m(_as_default(x_test)), dim=-1)
                    .cpu().numpy()
                    for m in models
                ],
                axis=0,
            )
        ensemble_acc = float((probs.argmax(axis=1) == y_test).mean())
        if verbose:
            print(
                f"Ensemble ({n} members, soft voting) test accuracy: "
                f"{ensemble_acc:.4f}"
            )
    return {
        **(
            {"ensemble_test_accuracy": ensemble_acc}
            if ensemble_acc is not None
            else {}
        ),
        "runs": all_results,
        # ndarray fields -> lists/floats so the whole harness result is
        # json.dump-able as-is (the n-runs evidence records are committed
        # JSON; an ndarray deep inside distributions made every caller
        # write its own sanitizer or crash at serialization)
        "distributions": _jsonable(distributions),
        "test_accuracy_mean": float(accs.mean()),
        "test_accuracy_std": float(accs.std(ddof=1)) if n > 1 else 0.0,
        "test_accuracy_min": float(accs.min()),
        "test_accuracy_max": float(accs.max()),
    }
