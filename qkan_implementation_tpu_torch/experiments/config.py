"""Experiment configuration: a YAML (or JSON) file -> dataclasses.

Counterpart of ``qkan_implementation_tpu.experiments.config``, including
the ``feature_cols: auto`` expansion to ``feature_00..feature_78``.  A
JSON file is read with ``json`` and any other with ``yaml.safe_load``:
JSON is a subset of YAML, so the same config written as JSON runs on a
machine without PyYAML.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import List, Optional


@dataclass
class DataConfig:
    data_path: str
    n_rows: int
    train_ratio: float
    feature_cols: List[str]
    target_col: str
    weight_col: str
    date_col: str

    @classmethod
    def from_dict(cls, data: dict) -> "DataConfig":
        return cls(**data)


@dataclass
class ModelConfig:
    model_type: str
    network_shape: List[int]
    max_degree: Optional[int] = None
    complexity_weight: Optional[float] = None
    significance_threshold: Optional[float] = None
    hidden_dims: Optional[List[int]] = None
    learning_rate: Optional[float] = None
    batch_size: Optional[int] = None
    n_epochs: Optional[int] = None
    num_reads: Optional[int] = None  # annealer chains (reference default 1000)
    # cross-validated degree scoring over time folds, e.g.
    # {n_splits: 5, strategy: expanding}; None = in-sample scoring
    degree_cv: Optional[dict] = None
    # fixed_kan behaviour bundle: 'reference' | 'recommended' (the
    # default), models.fixed_kan.FixedKANConfig.PRESETS
    preset: Optional[str] = None

    @classmethod
    def from_dict(cls, data: dict) -> "ModelConfig":
        return cls(**data)


@dataclass
class ExperimentConfig:
    name: str
    data: DataConfig
    models: List[ModelConfig]
    random_seed: int
    num_trials: int
    save_path: str
    log_path: str

    @classmethod
    def from_dict(cls, data: dict) -> "ExperimentConfig":
        return cls(
            name=data["name"],
            data=DataConfig.from_dict(data["data"]),
            models=[ModelConfig.from_dict(m) for m in data["models"]],
            random_seed=data["random_seed"],
            num_trials=data["num_trials"],
            save_path=data["save_path"],
            log_path=data["log_path"],
        )


def get_default_features() -> List[str]:
    return [f"feature_{i:02d}" for i in range(79)]


def _read_config_file(path: str) -> dict:
    """A JSON document by ``json`` (PyYAML's YAML 1.1 would read a number
    such as ``8e-05``, which has no point, as a string), anything else by
    ``yaml.safe_load``."""
    with open(path, "r") as f:
        text = f.read()
    try:
        return json.loads(text)
    except json.JSONDecodeError as e:
        json_error = e
    try:
        import yaml
    except ImportError:
        raise ValueError(
            f"{path}: PyYAML is not installed, and the file is not JSON "
            f"({json_error}); write the config as JSON or install PyYAML"
        ) from None
    return yaml.safe_load(text)


def load_config(path: str) -> ExperimentConfig:
    config_dict = _read_config_file(path)
    if config_dict["data"]["feature_cols"] == "auto":
        config_dict["data"]["feature_cols"] = get_default_features()
    return ExperimentConfig.from_dict(config_dict)
