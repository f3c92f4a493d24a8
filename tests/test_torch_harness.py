"""``run_experiment`` of the torch port against the JAX package's, on the
JAX suite's tiny configs (tests/test_data_and_experiments.py: qkan + mlp
over two trials, fixed_kan, qkan with time-fold CV scoring), on the CPU
in float64 (torch's default dtype set to it, the JAX side x64).

The MLP starts from JAX's ``init_mlp`` numbers in both packages (the
port's ``init_mlp`` is replaced by a carrier of them: the port cannot
draw ``jax.random``'s numbers).  Bars: the results in order, with the
same model names; each trial's MSE and R^2 (and its val metrics) within
1e-9 relative (measured <= 6e-16); the 'qkan' and 'fixed_kan' degrees
equal; ``results_summary.csv`` equal but for ``train_time`` (its numbers
at the same 1e-9); one ``runs.jsonl`` record a trial.  The port's JSON
config and column-dict routes give its YAML and parquet routes' results
exactly.
"""

import csv
import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from qkan_implementation_tpu.data import generate_market_parquet
from qkan_implementation_tpu.experiments import run_experiment as jax_run
from qkan_implementation_tpu.models import mlp as jax_mlp
from qkan_implementation_tpu_torch.data import market_columns
from qkan_implementation_tpu_torch.experiments import run_experiment
from qkan_implementation_tpu_torch.models import mlp as t_mlp
from qkan_implementation_tpu_torch.optim import DegreeOptimizer
from qkan_implementation_tpu_torch.utils.convert import mlp_from_numpy

REPO = Path(__file__).resolve().parents[1]
RTOL = 1e-9

MODELS = {
    "qkan_mlp": ([
        {"model_type": "qkan", "network_shape": [4, 1], "max_degree": 3,
         "complexity_weight": 0.1, "significance_threshold": 0.05,
         "num_reads": 32},
        {"model_type": "mlp", "network_shape": [4, 8, 1],
         "hidden_dims": [8], "learning_rate": 0.001, "batch_size": 64,
         "n_epochs": 3},
    ], 42, 2),
    "fixed_kan": ([
        {"model_type": "fixed_kan", "network_shape": [4, 4, 1],
         "max_degree": 3, "complexity_weight": 0.001, "num_reads": 32,
         "n_epochs": 5, "batch_size": 64, "learning_rate": 0.01},
    ], 1, 1),
    "degree_cv": ([
        {"model_type": "qkan", "network_shape": [6, 1], "max_degree": 3,
         "complexity_weight": 0.0, "num_reads": 16,
         "degree_cv": {"n_splits": 3, "strategy": "expanding"}},
    ], 1, 1),
}
DATA = {"qkan_mlp": (400, 4, 0.8), "fixed_kan": (400, 4, 0.8),
        "degree_cv": (1200, 6, 0.7)}


@pytest.fixture(autouse=True)
def x64():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


@pytest.fixture
def jax_mlp_start(monkeypatch):
    """The port's ``init_mlp`` gives JAX's initial numbers."""

    def carried(config, seed=0, dtype=torch.float32, device="cuda"):
        jcfg = jax_mlp.MLPConfig(config.input_dim, config.hidden_dims,
                                 config.output_dim)
        p, s = jax_mlp.init_mlp(jcfg, seed=seed, dtype=np.float64)
        return mlp_from_numpy(jax.tree.map(np.asarray, p),
                              jax.tree.map(np.asarray, s), config, device,
                              dtype)

    monkeypatch.setattr(t_mlp, "init_mlp", carried)


def write_config(tmp_path, tag, case, data_path, fmt="yaml"):
    models, seed, trials = MODELS[case]
    n_rows, n_features, ratio = DATA[case]
    cfg = {
        "name": f"{case}_{tag}",
        "data": {"data_path": str(data_path), "n_rows": n_rows,
                 "train_ratio": ratio,
                 "feature_cols": [f"feature_{i:02d}"
                                  for i in range(n_features)],
                 "target_col": "responder_6", "weight_col": "weight",
                 "date_col": "date_id"},
        "models": models, "random_seed": seed, "num_trials": trials,
        "save_path": str(tmp_path / tag / "results"),
        "log_path": str(tmp_path / tag / "logs"),
    }
    path = tmp_path / f"{tag}.{fmt}"
    path.write_text(yaml.safe_dump(cfg) if fmt == "yaml" else json.dumps(cfg))
    return path


def parquet_for(tmp_path, case):
    n_rows, n_features, _ = DATA[case]
    return generate_market_parquet(str(tmp_path / "train.parquet"),
                                   n_rows=n_rows, n_features=n_features)


def read_csv(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def assert_results_match(got, want):
    assert [r.model_name for r in got] == [r.model_name for r in want]
    for g, w in zip(got, want):
        assert g.MSE_Score == pytest.approx(w.MSE_Score, rel=RTOL)
        assert g.R2_Score == pytest.approx(w.R2_Score, rel=RTOL)
        for k in w.val_metrics:
            assert g.val_metrics[k] == pytest.approx(w.val_metrics[k],
                                                     rel=RTOL, abs=1e-12)
        if "degrees" in w.model_params:
            assert g.model_params["degrees"] == [
                np.asarray(d).tolist() for d in w.model_params["degrees"]]
        else:
            assert g.model_params == w.model_params


@pytest.mark.parametrize("case", sorted(MODELS))
def test_run_experiment_matches_jax(tmp_path, jax_mlp_start, case):
    data_path = parquet_for(tmp_path, case)
    want = jax_run(str(write_config(tmp_path, "jax", case, data_path)))
    got = run_experiment(str(write_config(tmp_path, "port", case,
                                          data_path)), device="cpu")
    assert_results_match(got, want)
    jcsv = read_csv(tmp_path / "jax" / "results" / "results_summary.csv")
    tcsv = read_csv(tmp_path / "port" / "results" / "results_summary.csv")
    assert tcsv[0] == jcsv[0] == ["", "model", "mse", "r2", "train_time"]
    assert len(tcsv) == len(jcsv) == len(want) + 1
    for t_row, j_row in zip(tcsv[1:], jcsv[1:]):
        assert t_row[:2] == j_row[:2]
        for t_val, j_val in zip(t_row[2:4], j_row[2:4]):
            assert float(t_val) == pytest.approx(float(j_val), rel=RTOL)
        assert float(t_row[4]) > 0
    for tag in ("jax", "port"):
        out = tmp_path / tag / "results"
        lines = (out / "runs.jsonl").read_text().splitlines()
        assert len(lines) == len(want)
        assert (out / "metrics_comparison.png").exists()
        assert (tmp_path / tag / "logs" / f"{case}_{tag}.log").exists()


def test_degree_cv_route_runs(tmp_path, monkeypatch):
    calls = {}
    real = DegreeOptimizer.evaluate_degree_cv

    def spy(self, *a, **k):
        calls["n_splits"] = k.get("n_splits")
        return real(self, *a, **k)

    monkeypatch.setattr(DegreeOptimizer, "evaluate_degree_cv", spy)
    data_path = parquet_for(tmp_path, "degree_cv")
    results = run_experiment(str(write_config(
        tmp_path, "port", "degree_cv", data_path)), device="cpu")
    assert calls.get("n_splits") == 3
    assert len(results) == 1 and np.isfinite(results[0].MSE_Score)


def test_json_config_and_columns_route_match_yaml_and_parquet(tmp_path):
    """The port's JSON + column-dict route (a machine without pandas or
    PyYAML) gives the YAML + parquet route's results exactly."""
    torch.set_default_dtype(torch.float32)
    data_path = parquet_for(tmp_path, "qkan_mlp")
    want = run_experiment(str(write_config(
        tmp_path, "yaml", "qkan_mlp", data_path)), device="cpu")
    got = run_experiment(
        str(write_config(tmp_path, "json", "qkan_mlp", "(columns)", "json")),
        device="cpu", columns=market_columns(n_rows=400, n_features=4))
    assert [(r.model_name, r.MSE_Score, r.R2_Score, r.val_metrics)
            for r in got] == [(r.model_name, r.MSE_Score, r.R2_Score,
                               r.val_metrics) for r in want]


def test_run_experiment_without_matplotlib(tmp_path, monkeypatch, caplog):
    """Without matplotlib the CSV and the JSONL are written and one line
    says why the PNGs are not."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    data_path = parquet_for(tmp_path, "degree_cv")
    run_experiment(str(write_config(tmp_path, "nomp", "degree_cv",
                                    data_path)), device="cpu")
    out = tmp_path / "nomp" / "results"
    assert (out / "results_summary.csv").exists()
    assert (out / "runs.jsonl").exists()
    assert not list(out.glob("*.png"))
    log = (tmp_path / "nomp" / "logs" / "degree_cv_nomp.log").read_text()
    assert log.count("not written: matplotlib is not installed") == 1


def test_cli_runs_on_the_cpu(tmp_path):
    data_path = parquet_for(tmp_path, "degree_cv")
    cfg = write_config(tmp_path, "cli", "degree_cv", data_path)
    out = subprocess.run(
        [sys.executable, "-m", "qkan_implementation_tpu_torch.experiments.main",
         str(cfg), "--device", "cpu"], cwd=REPO, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    rows = read_csv(tmp_path / "cli" / "results" / "results_summary.csv")
    assert rows[1][1] == "qkan_trial_0"
