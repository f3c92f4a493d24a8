"""Every input the benchmark makes is a function of the seed."""

import numpy as np
import torch

from perfbench import data


def test_digits_repeat_for_a_seed():
    a, la = data.digits_784(2500, 7)
    b, lb = data.digits_784(2500, 7)
    c, _ = data.digits_784(2500, 8)
    assert a.dtype == np.float32 and a.shape == (2500, 784)
    assert np.array_equal(a, b) and np.array_equal(la, lb)
    assert not np.array_equal(a, c)
    assert 0.0 <= a.min() and a.max() <= 1.0


def test_market_columns_and_arrays_repeat_for_a_seed():
    a = data.market_columns(5000, 79, 50, 11, 0.1)
    b = data.market_columns(5000, 79, 50, 11, 0.1)
    c = data.market_columns(5000, 79, 50, 12, 0.1)
    assert all(np.array_equal(a[k], b[k], equal_nan=True) for k in a)
    assert not np.array_equal(a["responder_6"], c["responder_6"])
    arr_a = data.market_arrays(a, 79, 0.8)
    arr_b = data.market_arrays(b, 79, 0.8)
    assert all(np.array_equal(p, q) for p, q in zip(arr_a, arr_b))
    assert arr_a[0].shape[1] == 79 and np.abs(arr_a[0]).max() <= 1.0


def test_market_copy_matches_the_programs_generator_and_pipeline():
    from qkan_implementation_tpu_torch.data.pipeline import (
        DataPipeline, market_columns,
    )
    from qkan_implementation_tpu_torch.experiments.config import DataConfig

    cols = market_columns(6000, 79, 40, 5, profile="hard")
    mine = data.market_columns(6000, 79, 40, 5, 0.1)
    assert all(np.array_equal(cols[k], mine[k], equal_nan=True) for k in cols)
    cfg = DataConfig(data_path="(columns)", n_rows=6000, train_ratio=0.8,
                     feature_cols=[f"feature_{i:02d}" for i in range(79)],
                     target_col="responder_6", weight_col="weight",
                     date_col="date_id")
    theirs = DataPipeline(cfg, columns=cols).load_and_preprocess_data()
    assert all(np.array_equal(p, q)
               for p, q in zip(theirs, data.market_arrays(mine, 79, 0.8)))


def test_parameters_repeat_for_a_seed():
    dims = [(784, 10), (10, 10)]
    a = data.kan_params(dims, [32, 16], 5, 3, "cpu")
    b = data.kan_params(dims, [32, 16], 5, 3, "cpu")
    c = data.kan_params(dims, [32, 16], 5, 4, "cpu")
    for p, q in zip(a, b):
        assert all(torch.equal(p[k], q[k]) for k in p)
    assert not torch.equal(a[0]["coefficients"], c[0]["coefficients"])
    assert a[0]["coefficients"].shape == (32, 784, 6, 10)
