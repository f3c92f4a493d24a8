"""The digits corpus, its loaders, the sampling diagnostics, the run
records and the flagship experiment of the torch port against the JAX
package, on the CPU in float64 (torch's default dtype is set to float64,
the port's counterpart of the suite's x64).

Bars: the loaders and diagnostics are numpy on both sides: equal arrays.
The experiment: the same degrees and the same accuracies (argmax over
logits that agree to ~1e-12).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from qkan_implementation_tpu.analysis import mnist_diagnostics as jax_diag
from qkan_implementation_tpu.data import mnist as jax_mnist
from qkan_implementation_tpu.experiments.mnist import (
    run_mnist_experiment as jax_run,
)
from qkan_implementation_tpu.utils import run_records as jax_records
from qkan_implementation_tpu_torch.analysis import mnist_diagnostics as t_diag
from qkan_implementation_tpu_torch.data import mnist as t_mnist
from qkan_implementation_tpu_torch.experiments import (
    run_mnist_experiment,
    run_mnist_n_times,
)
from qkan_implementation_tpu_torch.models import FixedKAN
from qkan_implementation_tpu_torch.utils import run_records as t_records


@pytest.fixture(autouse=True)
def x64():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


def test_committed_digits_equal_sklearn():
    datasets = pytest.importorskip("sklearn.datasets")
    digits = datasets.load_digits()
    pixels, labels = t_mnist._load_digits()
    np.testing.assert_array_equal(pixels, digits.data)
    np.testing.assert_array_equal(pixels.reshape(-1, 8, 8), digits.images)
    np.testing.assert_array_equal(labels, digits.target)
    assert pixels.dtype == np.float64 and labels.dtype == np.int64


@pytest.mark.parametrize("train", [True, False])
def test_loaders_equal_jax(train):
    for augment_to in (None, 1600):
        got = t_mnist.load_digits_784(train, augment_to, seed=3)
        want = jax_mnist.load_digits_784(train, augment_to, seed=3)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]
    got, want = t_mnist.load_mnist(train=train), jax_mnist.load_mnist(
        train=train)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]
    x, y = got[0], got[1]
    for seed in (0, 5):
        a = t_mnist.sample_train_subset(x, y, 100, seed)
        b = jax_mnist.sample_train_subset(x, y, 100, seed)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(t_mnist.to_one_hot(y[:50]),
                                  jax_mnist.to_one_hot(y[:50]))


def test_augment_and_upsample_equal_jax():
    rng = np.random.default_rng(0)
    imgs = rng.uniform(0, 1, (20, 8, 8))
    labels = rng.integers(0, 10, 20)
    a = t_mnist._augment(imgs, labels, 64, 4)
    b = jax_mnist._augment(imgs, labels, 64, 4)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(t_mnist._bilinear_upsample(imgs, 28),
                                  jax_mnist._bilinear_upsample(imgs, 28))


def test_idx_files_are_read(tmp_path):
    rng = np.random.default_rng(1)
    for split, n in (("train", 6), ("t10k", 4)):
        imgs = rng.integers(0, 256, (n, 28, 28)).astype(np.uint8)
        labels = rng.integers(0, 10, n).astype(np.uint8)
        with open(tmp_path / f"{split}-images-idx3-ubyte", "wb") as f:
            f.write(bytes([0, 0, 8, 3]) + np.array([n, 28, 28], ">u4")
                    .tobytes() + imgs.tobytes())
        with open(tmp_path / f"{split}-labels-idx1-ubyte", "wb") as f:
            f.write(bytes([0, 0, 8, 1]) + np.array([n], ">u4").tobytes()
                    + labels.tobytes())
    for train in (True, False):
        got = t_mnist.load_mnist(str(tmp_path), train)
        want = jax_mnist.load_mnist(str(tmp_path), train)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[2] == want[2] == {"source": "mnist-idx", "image_dim": 784}


def test_diagnostics_and_records_equal_jax(tmp_path):
    x, y, _ = t_mnist.load_mnist(train=True)
    a = t_diag.analyze_sample_distribution(x[:300], y[:300], full_labels=y,
                                           verbose=False)
    b = jax_diag.analyze_sample_distribution(x[:300], y[:300], full_labels=y,
                                             verbose=False)
    assert t_records.to_jsonable(a) == jax_records.to_jsonable(b)
    a = t_diag.compare_multiple_samples(x, y, 200, num_runs=3, verbose=False)
    b = jax_diag.compare_multiple_samples(x, y, 200, num_runs=3,
                                          verbose=False)
    assert t_records.to_jsonable(a) == jax_records.to_jsonable(b)
    pytest.importorskip("matplotlib")
    fig = t_diag.plot_sample_distributions(a["sample_results"])
    assert len(fig.axes[0].patches) == 3 * 10
    rec = t_records.RunRecorder(str(tmp_path / "runs.jsonl"))
    rec.record(acc=np.float32(0.5), counts=np.arange(3), obj=object())
    rows = rec.read_all()
    assert rows[0]["acc"] == 0.5 and rows[0]["counts"] == [0, 1, 2]
    assert isinstance(rows[0]["obj"], str)


EXPERIMENT = dict(
    network_shape=[64, 8, 10], max_degree=3, train_size=600,
    solver="exact", degree_objective="penalized_mse", complexity_weight=0.001,
    consistent_tanh=True, verbose=False,
)


def test_experiment_matches_jax():
    kw = dict(EXPERIMENT, lstsq_method="normal", weight_epochs=1,
              weight_backend="xla")
    got = run_mnist_experiment(device="cpu", **kw)
    want = jax_run(**kw)
    for lt, lj in zip(got["_model"].params, want["_model"].params):
        np.testing.assert_array_equal(lt["degrees"].numpy(),
                                      np.asarray(lj["degrees"]))
    for key in ("train_accuracy", "test_accuracy"):
        assert got["metrics"][key] == want["metrics"][key], key
    np.testing.assert_allclose(got["metrics"]["train_epoch_losses"],
                               want["metrics"]["train_epoch_losses"],
                               rtol=1e-9)
    assert got["weight_matmul_precision"] == want["weight_matmul_precision"]
    assert got["_model"].device.type == "cpu"


def test_torch_mnist_experiment_end_to_end_svd(tmp_path):
    """The port's counterpart of the JAX suite's
    test_mnist_experiment_end_to_end, on its 'svd' default: the port's
    min-norm sweep gives a finite degree-0 score, so degree search works
    and the model beats chance by a lot."""
    results = run_mnist_experiment(save_dir=str(tmp_path), device="cpu",
                                   **EXPERIMENT)
    m = results["metrics"]
    assert m["test_accuracy"] > 0.5, m
    assert m["structure_time_seconds"] > 0
    assert np.all(np.isfinite(results["_model"].last_search_stats[0]
                              ["scores"]))
    files = list(Path(tmp_path).iterdir())
    assert any("mnist_kan_results_acc_" in f.name for f in files)
    with open(results["results_file"]) as f:
        assert json.load(f)["metrics"]["test_accuracy"] == m["test_accuracy"]
    loaded = FixedKAN.load_model(results["model_file"], device="cpu")
    x_test, y_test, _ = t_mnist.load_mnist(train=False)
    with torch.no_grad():
        pred = loaded(torch.from_numpy(x_test)).argmax(dim=1).numpy()
    assert float((pred == y_test).mean()) == m["test_accuracy"]


def test_mnist_n_times_aggregates():
    stats = run_mnist_n_times(
        n=2, ensemble=True, device="cpu",
        **dict(EXPERIMENT, network_shape=[64, 4, 10], max_degree=2,
               train_size=300),
    )
    accs = [r["metrics"]["test_accuracy"] for r in stats["runs"]]
    assert len(stats["distributions"]) == 2
    np.testing.assert_allclose(stats["test_accuracy_mean"], np.mean(accs))
    np.testing.assert_allclose(stats["test_accuracy_min"], np.min(accs))
    assert 0.0 < stats["ensemble_test_accuracy"] <= 1.0
    json.dumps(stats)
