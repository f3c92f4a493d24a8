"""The market-data pipeline, the experiment config and the metrics of the
torch port against the JAX package, on the CPU.

Bars:
- the generated columns EQUAL the JAX parquet's, bit for bit (same
  dtypes, NaNs where JAX's are), for the demo, hard and top profiles;
- ``DataPipeline`` on the JAX parquet (and on the port's column dict)
  gives JAX's arrays EXACTLY: the clamp, the constant-feature fallback,
  the date split and the per-row dates;
- ``load_config`` reads a YAML file and the same config as JSON to the
  same dataclasses as JAX's reader, ``auto`` included;
- the metrics within 1e-12 relative of JAX's in float64 and 1e-5 in
  float32 (integer targets promote to float32 in both; the sums may
  run in another order).
"""

import json
import subprocess
import sys
from dataclasses import asdict
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch
import yaml

from qkan_implementation_tpu.data import pipeline as jax_pipe
from qkan_implementation_tpu.experiments import config as jax_cfg
from qkan_implementation_tpu.utils import metrics as jax_metrics
from qkan_implementation_tpu_torch.data import pipeline as t_pipe
from qkan_implementation_tpu_torch.experiments import config as t_cfg
from qkan_implementation_tpu_torch.utils import metrics as t_metrics

REPO = Path(__file__).resolve().parents[1]


def data_config(module, path, n_rows, n_features, train_ratio=0.8):
    return module.DataConfig(
        data_path=str(path), n_rows=n_rows, train_ratio=train_ratio,
        feature_cols=[f"feature_{i:02d}" for i in range(n_features)],
        target_col="responder_6", weight_col="weight", date_col="date_id")


@pytest.mark.parametrize("profile", ["demo", "hard", "top"])
def test_market_columns_equal_jax_parquet(tmp_path, profile):
    kw = dict(n_rows=3000, n_features=8, n_dates=40, seed=3, profile=profile)
    path = jax_pipe.generate_market_parquet(str(tmp_path / "j.parquet"), **kw)
    df = pd.read_parquet(path)
    cols = t_pipe.market_columns(**kw)
    assert list(df.columns) == list(cols)
    for name, want in df.items():
        got = cols[name]
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want.to_numpy(), err_msg=name)
    # the port's writer gives the same file contents
    t_path = t_pipe.generate_market_parquet(str(tmp_path / "t.parquet"), **kw)
    pd.testing.assert_frame_equal(pd.read_parquet(t_path), df)


@pytest.mark.parametrize("route", ["parquet", "columns"])
@pytest.mark.parametrize("n_rows,train_ratio", [(2500, 0.7), (4000, 0.8)])
def test_pipeline_matches_jax(tmp_path, route, n_rows, train_ratio):
    kw = dict(n_rows=4000, n_features=6, n_dates=60, seed=5, profile="hard")
    path = jax_pipe.generate_market_parquet(str(tmp_path / "m.parquet"), **kw)
    jp = jax_pipe.DataPipeline(
        data_config(jax_cfg, path, n_rows, 6, train_ratio))
    want = jp.load_and_preprocess_data()
    tp = t_pipe.DataPipeline(
        data_config(t_cfg, path, n_rows, 6, train_ratio),
        columns=t_pipe.market_columns(**kw) if route == "columns" else None)
    got = tp.load_and_preprocess_data()
    for g, w in zip(got, want):
        assert g.dtype == np.float64 and g.ndim == 2
        np.testing.assert_array_equal(g, w.to_numpy())
    np.testing.assert_array_equal(tp.last_train_dates, jp.last_train_dates)
    np.testing.assert_array_equal(tp.last_val_dates, jp.last_val_dates)
    for feats in (got[0], got[3]):
        assert np.all(np.abs(feats) <= 1.0)
        assert np.mean(feats == 1.0) > 0.01 and np.mean(feats == -1.0) > 0.01


def test_constant_feature_fallback_matches_jax(tmp_path):
    """q05 == q95: the scale falls back to std, then 1.0; a constant
    column centres to exactly 0; NaNs fill with 3."""
    path = str(tmp_path / "c.parquet")
    target = np.linspace(-1, 1, 50)
    target[7] = np.nan
    pd.DataFrame({
        "date_id": np.arange(50), "weight": np.ones(50),
        "feature_00": np.ones(50) * 7.0,
        "feature_01": np.r_[np.zeros(48), 1.0, 2.0],
        "responder_6": target,
    }).to_parquet(path)
    want = jax_pipe.DataPipeline(
        data_config(jax_cfg, path, 50, 2)).load_and_preprocess_data()
    got = t_pipe.DataPipeline(
        data_config(t_cfg, path, 50, 2)).load_and_preprocess_data()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.to_numpy())
    assert np.all(got[0][:, 0] == 0.0)


def experiment_dict(tmp_path, feature_cols="auto"):
    return {
        "name": "t",
        "data": {"data_path": "x.parquet", "n_rows": 10, "train_ratio": 0.8,
                 "feature_cols": feature_cols, "target_col": "responder_6",
                 "weight_col": "weight", "date_col": "date_id"},
        "models": [
            {"model_type": "qkan", "network_shape": [79, 1],
             "max_degree": 3, "num_reads": 32,
             "degree_cv": {"n_splits": 3, "strategy": "time"}},
            {"model_type": "mlp", "network_shape": [79, 8, 1],
             "hidden_dims": [8], "learning_rate": 8e-05, "batch_size": 64,
             "n_epochs": 3},
        ],
        "random_seed": 42, "num_trials": 1,
        "save_path": str(tmp_path), "log_path": str(tmp_path),
    }


@pytest.mark.parametrize("feature_cols", ["auto", ["feature_03"]])
def test_load_config_yaml_and_json_match_jax(tmp_path, feature_cols):
    cfg = experiment_dict(tmp_path, feature_cols)
    y_path, j_path = tmp_path / "cfg.yaml", tmp_path / "cfg.json"
    y_path.write_text(yaml.safe_dump(cfg))
    j_path.write_text(json.dumps(cfg))
    want = asdict(jax_cfg.load_config(str(y_path)))
    for path in (y_path, j_path):
        got = asdict(t_cfg.load_config(str(path)))
        assert got == want
    assert isinstance(want["models"][1]["learning_rate"], float)
    n = 79 if feature_cols == "auto" else 1
    assert len(want["data"]["feature_cols"]) == n


def test_load_config_without_yaml(tmp_path, monkeypatch):
    """A JSON config loads with PyYAML absent; a YAML-only file raises a
    clear error."""
    monkeypatch.setitem(sys.modules, "yaml", None)  # import yaml fails
    cfg = experiment_dict(tmp_path)
    j_path = tmp_path / "cfg.json"
    j_path.write_text(json.dumps(cfg))
    assert t_cfg.load_config(str(j_path)).data.feature_cols == \
        t_cfg.get_default_features()
    y_path = tmp_path / "cfg.yaml"
    y_path.write_text("name: t\ndata:\n  n_rows: 10\n")
    with pytest.raises(ValueError, match="PyYAML is not installed"):
        t_cfg.load_config(str(y_path))


def metric_cases():
    rng = np.random.default_rng(0)
    y = rng.normal(size=200)
    p = y + 0.3 * rng.normal(size=200)
    w = rng.uniform(0.5, 2.0, 200)
    tiny = np.array([1e-4, 1.5e-4, 0.7e-4])
    return {
        "float": (y, p, None),
        "weighted": (y.reshape(-1, 1), p.reshape(-1, 1), w),
        "float32": (y.astype(np.float32), p.astype(np.float32),
                    w.astype(np.float32)),
        "int": (np.array([1, 2, 3, 4]), np.array([1, 2, 2, 5]), None),
        "int_exact": (np.array([1, 2, 3]), np.array([1, 2, 3]), None),
        "zero_weights": (y[:3], p[:3], np.zeros(3)),
        "tiny_scale": (tiny, tiny.copy(), None),
        "tiny_scale_off": (tiny, tiny * 1.1, np.ones(3)),
        "constant": (np.ones(5), np.ones(5) * 1.1, None),
        "zero_target": (np.zeros(4), np.ones(4), None),
    }


@pytest.mark.parametrize("fn", ["mse", "r2_score", "weighted_competition_r2"])
@pytest.mark.parametrize("case", sorted(metric_cases()))
def test_metrics_match_jax(case, fn):
    y, p, w = metric_cases()[case]
    want = getattr(jax_metrics, fn)(y, p, w)
    got = getattr(t_metrics, fn)(y, p, w)
    assert isinstance(got, float)
    f32 = case in ("float32", "int", "int_exact")
    rtol = 1e-5 if f32 else 1e-12
    assert got == pytest.approx(want, rel=rtol, abs=rtol * 1e-3)


def test_compute_metrics_matches_jax_and_takes_tensors():
    y, p, w = metric_cases()["weighted"]
    want = jax_metrics.compute_metrics(y, p, w)
    for args in ((y, p, w), tuple(torch.from_numpy(a) for a in (y, p, w))):
        got = t_metrics.compute_metrics(*args)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-12)


def test_port_modules_import_without_optional_packages():
    """Every port module of the harness imports on a machine without
    pandas, pyarrow, yaml and matplotlib (the card's machine may lack
    them)."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('pandas', 'pyarrow', 'yaml',\n"
        "                                  'matplotlib', 'jax'):\n"
        "            raise ImportError('blocked ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import qkan_implementation_tpu_torch.data.pipeline\n"
        "import qkan_implementation_tpu_torch.experiments\n"
        "import qkan_implementation_tpu_torch.experiments.degree_viz\n"
        "import qkan_implementation_tpu_torch.experiments.visualization\n"
        "import qkan_implementation_tpu_torch.optim\n"
        "import qkan_implementation_tpu_torch.models.mlp\n"
        "import qkan_implementation_tpu_torch.utils.metrics\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
