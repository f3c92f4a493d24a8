"""Experiment runner:
``python -m qkan_implementation_tpu_torch.experiments.main cfg.yaml``.

Counterpart of ``qkan_implementation_tpu.experiments.main``: config ->
data pipeline -> per-model, per-trial training ('qkan' through
``DegreeOptimizer``, 'mlp' through the baseline trainer, 'fixed_kan'
through ``FixedKAN``), on ``device`` (the card unless the caller asks
for the CPU) -> ``ModelResult`` records -> ``runs.jsonl``, the CSV
summary and three PNG plots.  Without matplotlib the plots are skipped
with one logged line; everything else is written.
"""

from __future__ import annotations

import csv
import logging
import sys
import time
from pathlib import Path

import numpy as np

from qkan_implementation_tpu_torch.data.pipeline import DataPipeline
from qkan_implementation_tpu_torch.experiments.config import (
    ExperimentConfig,
    load_config,
)
from qkan_implementation_tpu_torch.experiments.evaluation import (
    SUMMARY_COLUMNS,
    ModelEvaluator,
    ModelResult,
)
from qkan_implementation_tpu_torch.experiments.visualization import (
    ResultVisualizer,
)
from qkan_implementation_tpu_torch.models.mlp import (
    MLPConfig,
    mlp_predict,
    train_mlp,
)
from qkan_implementation_tpu_torch.optim.degree_optimizer import (
    DegreeOptimizer,
)
from qkan_implementation_tpu_torch.utils.metrics import compute_metrics
from qkan_implementation_tpu_torch.utils.platform import resolve_device
from qkan_implementation_tpu_torch.utils.run_records import RunRecorder


def setup_logging(config: ExperimentConfig):
    """File and stdout logging named after the experiment."""
    log_dir = Path(config.log_path)
    log_dir.mkdir(parents=True, exist_ok=True)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s - %(name)s - %(levelname)s - %(message)s",
        handlers=[
            logging.FileHandler(log_dir / f"{config.name}.log"),
            logging.StreamHandler(sys.stdout),
        ],
        force=True,
    )


def _default(value, fallback):
    return value if value is not None else fallback


def write_summary_csv(path, rows) -> None:
    """The summary rows as CSV, laid out as pandas' ``to_csv`` writes the
    JAX package's frame: an unnamed index column, then SUMMARY_COLUMNS."""
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(["", *SUMMARY_COLUMNS])
        for i, row in enumerate(rows):
            writer.writerow([i, *(row[c] for c in SUMMARY_COLUMNS)])


def _write_plots(results, save_dir: Path, logger) -> None:
    try:
        import matplotlib.pyplot as plt
    except ImportError as e:
        logger.info(
            "metrics_comparison.png, training_time_comparison.png and "
            "degree_distribution.png not written: matplotlib is not "
            f"installed ({e})"
        )
        return
    visualizer = ResultVisualizer()
    figures = {
        "metrics_comparison.png":
            visualizer.plot_metrics_comparison(results),
        "training_time_comparison.png":
            visualizer.plot_training_time_comparison(results),
    }
    qkan_results = [r for r in results if "qkan" in r.model_name.lower()]
    if qkan_results:
        figures["degree_distribution.png"] = (
            visualizer.plot_degree_distribution(qkan_results[0]))
    for name, fig in figures.items():
        fig.savefig(save_dir / name)
        plt.close(fig)


def run_experiment(config_path: str, device="cuda", columns=None):
    """Run the experiment a YAML (or JSON) config describes.

    ``device``: where every model trains and predicts.  ``columns``: the
    data as a dict of column arrays in place of the config's parquet file
    (``data.pipeline.market_columns``), for a machine without pandas.
    """
    config = load_config(config_path)
    setup_logging(config)
    logger = logging.getLogger(__name__)
    dev = resolve_device(device)
    np.random.seed(config.random_seed)  # the reference declares, never applies

    save_dir = Path(config.save_path)
    save_dir.mkdir(parents=True, exist_ok=True)
    recorder = RunRecorder(save_dir / "runs.jsonl")

    logger.info("Initializing data pipeline...")
    pipeline = DataPipeline(config.data, logger=logger, columns=columns)
    (
        train_x,
        train_target,
        train_weight,
        val_x,
        val_target,
        val_weight,
    ) = pipeline.load_and_preprocess_data()

    results = []
    for model_config in config.models:
        logger.info(f"Training model: {model_config.model_type}")
        for trial in range(config.num_trials):
            start_time = time.time()
            model_params = {}
            if model_config.model_type == "qkan":
                model = DegreeOptimizer(
                    network_shape=model_config.network_shape,
                    max_degree=model_config.max_degree,
                    complexity_weight=_default(
                        model_config.complexity_weight, 0.1),
                    significance_threshold=_default(
                        model_config.significance_threshold, 0.05),
                    device=dev,
                )
                cv_scores = None
                if model_config.degree_cv:
                    cv = dict(model_config.degree_cv)
                    cv_scores, _ = model.evaluate_degree_cv(
                        x_data=train_x,
                        y_data=train_target,
                        timestamps=pipeline.last_train_dates,
                        weights=train_weight,
                        n_splits=int(cv.get("n_splits", 5)),
                        strategy=cv.get("strategy", "expanding"),
                    )
                    logger.info(
                        f"CV degree scores ({cv.get('strategy', 'expanding')},"
                        f" {cv.get('n_splits', 5)} folds): {cv_scores}"
                    )
                model.fit(
                    train_x,
                    train_target,
                    weights=train_weight,
                    num_reads=_default(model_config.num_reads, 1000),
                    seed=config.random_seed + trial,
                    scores=cv_scores,
                )
                # metrics of the structure the annealer selected, from
                # real predictions
                val_metrics = compute_metrics(
                    val_target, model.predict(val_x), val_weight)
                train_metrics = compute_metrics(
                    train_target, model.predict(train_x), train_weight)
                model_params = {"degrees": model.optimal_degrees}
                mse_score = val_metrics["mse"]
                r2_score_val = val_metrics["comp_r2"]
            elif model_config.model_type == "mlp":
                mlp_config = MLPConfig(
                    input_dim=len(config.data.feature_cols),
                    hidden_dims=model_config.hidden_dims or [32],
                    learning_rate=_default(model_config.learning_rate, 8e-5),
                    batch_size=_default(model_config.batch_size, 32),
                    n_epochs=_default(model_config.n_epochs, 10),
                )
                scores, compr2_scores, mlp_model = train_mlp(
                    mlp_config,
                    train_x,
                    train_target,
                    weights=train_weight,
                    x_val=val_x,
                    y_val=val_target,
                    w_val=val_weight,
                    seed=config.random_seed + trial,
                    device=dev,
                )
                n_params = sum(
                    w.numel() + b.numel()
                    for w, b in zip(mlp_model.weights, mlp_model.biases)
                )
                model_params = {"n_parameters": n_params}
                val_pred = mlp_predict(mlp_model, val_x).cpu().numpy()
                train_pred = mlp_predict(mlp_model, train_x).cpu().numpy()
                val_metrics = compute_metrics(val_target, val_pred, val_weight)
                train_metrics = compute_metrics(
                    train_target, train_pred, train_weight)
                # the reference's headline averages the PER-EPOCH
                # validation scores; the final model's are in val_metrics
                mse_score = (float(np.average(scores)) if scores
                             else val_metrics["mse"])
                r2_score_val = (
                    float(np.average(compr2_scores))
                    if compr2_scores
                    else val_metrics["comp_r2"]
                )
            elif model_config.model_type == "fixed_kan":
                # multi-layer KAN: QUBO structure search + gradient training
                from qkan_implementation_tpu_torch.models.fixed_kan import (
                    FixedKAN,
                    FixedKANConfig,
                )

                kan = FixedKAN(
                    FixedKANConfig.preset(
                        model_config.preset or "recommended",
                        network_shape=model_config.network_shape,
                        max_degree=model_config.max_degree or 3,
                        complexity_weight=_default(
                            model_config.complexity_weight, 1e-3),
                    ),
                    device=dev,
                )
                kan.optimize(
                    train_x,
                    train_target,
                    solver="anneal",
                    num_reads=model_config.num_reads or 1000,
                    seed=config.random_seed + trial,
                )
                if model_config.n_epochs:
                    kan.train(
                        train_x,
                        train_target,
                        epochs=model_config.n_epochs,
                        batch_size=model_config.batch_size or 256,
                        learning_rate=model_config.learning_rate or 1e-2,
                        loss="mse",
                    )
                val_pred = kan(val_x).cpu().numpy()
                train_pred = kan(train_x).cpu().numpy()
                val_metrics = compute_metrics(val_target, val_pred, val_weight)
                train_metrics = compute_metrics(
                    train_target, train_pred, train_weight)
                model_params = {
                    "degrees": [lp["degrees"].cpu().numpy().tolist()
                                for lp in kan.params]
                }
                mse_score = val_metrics["mse"]
                r2_score_val = val_metrics["comp_r2"]
            else:
                raise ValueError(
                    f"Unknown model_type {model_config.model_type!r}")

            train_time = time.time() - start_time
            results.append(
                ModelResult(
                    model_name=f"{model_config.model_type}_trial_{trial}",
                    MSE_Score=mse_score,
                    R2_Score=r2_score_val,
                    train_time=train_time,
                    model_params=model_params,
                    train_metrics=train_metrics,
                    val_metrics=val_metrics,
                )
            )
            recorder.record(
                experiment=config.name,
                model=model_config.model_type,
                trial=trial,
                mse=mse_score,
                r2=r2_score_val,
                train_time=train_time,
                val_metrics=val_metrics,
            )
            logger.info(f"Trial {trial} complete for {model_config.model_type}")

    logger.info("Creating visualizations...")
    _write_plots(results, save_dir, logger)
    write_summary_csv(
        save_dir / "results_summary.csv",
        ModelEvaluator.create_evaluation_summary(results),
    )
    logger.info("Experiment complete!")
    return results


def _cli():
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument(
        "config_path", type=str,
        help="Path to the YAML (or JSON) configuration file",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="where the models train: 'cuda' (default) or 'cpu'",
    )
    args = parser.parse_args()
    run_experiment(args.config_path, device=args.device)


if __name__ == "__main__":
    _cli()
