"""The int8 serving recipes and the market harness of the torch port on
the card.  Every test here needs a CUDA card and skips without one.

This file imports torch and numpy only, so it runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_cuda_int8.py -q

Bars: the card's int8 product (``torch._int_mm`` on padded operands)
EQUALS the exact float64 product of the same int8 operands, at the
padding edges (B <= 16, F or K not a multiple of 8) and the flagship's
[B, 4704] @ [4704, 32] and [B, 96] @ [96, 10] for B in {1, 37, 4096};
each recipe on the card equals the same recipe on the CPU bit for bit
on the same operands (the quantisation is elementwise and exact, the
products are exact); ``run_experiment`` on a tiny config runs on the
card with finite results, its 'qkan' result within 1e-9 of the same
run on the CPU (the same degrees; the Gram sums in float64 in another
order).
"""

import json

import numpy as np
import pytest
import torch

from qkan_implementation_tpu_torch.data import market_columns
from qkan_implementation_tpu_torch.experiments import run_experiment
from qkan_implementation_tpu_torch.ops import qkan_layer as ql

pytestmark = pytest.mark.gpu

SHAPES = [(b, f, k) for b in (1, 37, 4096)
          for f, k in ((4704, 32), (96, 10))] + [
    (37, 128, 16), (64, 1024, 8), (16, 10, 10), (17, 10, 10),
    (24, 16, 16), (4096, 16, 16)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("b,f,k", SHAPES)
def test_int8_product_is_exact(cuda, b, f, k):
    rng = np.random.default_rng(b * 7 + f + k)
    qa = torch.as_tensor(rng.integers(-127, 128, (b, f)), dtype=torch.int8)
    qw = torch.as_tensor(rng.integers(-127, 128, (f, k)), dtype=torch.int8)
    got = ql.int8_matmul(qa.to(cuda), qw.to(cuda))
    assert got.is_cuda and got.dtype == torch.int32
    assert got.shape == (b, k)
    want = (qa.double() @ qw.double()).to(torch.int32)
    assert torch.equal(got.cpu(), want)


def test_int8_product_runs_int_mm(cuda, monkeypatch):
    calls = []
    real = torch._int_mm

    def spy(a, b):
        calls.append((tuple(a.shape), b.stride()))
        return real(a, b)

    monkeypatch.setattr(torch, "_int_mm", spy)
    qa = torch.ones((1, 10), dtype=torch.int8, device=cuda)
    qw = torch.ones((10, 10), dtype=torch.int8, device=cuda)
    assert torch.equal(ql.int8_matmul(qa, qw).cpu(),
                       torch.full((1, 10), 10, dtype=torch.int32))
    # padded to 24 rows, F and K to 16; the right operand column-major
    assert calls == [((24, 16), (1, 16))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("recipe", ["int8", "int8x2", "int8x2w"])
@pytest.mark.parametrize("b,f,k", [(1, 4704, 32), (37, 96, 10),
                                   (4096, 4704, 32)])
def test_recipe_on_card_equals_cpu(cuda, recipe, b, f, k, dtype):
    rng = np.random.default_rng(f + b)
    a = torch.as_tensor(rng.uniform(-1, 1, (b, f)), dtype=dtype)
    w = torch.as_tensor(rng.normal(0, 0.3, (f, k)), dtype=dtype)

    def run(a, w):
        if recipe == "int8":
            return ql.int8_quantized_matmul(a, w)
        return ql.int8_residual_matmul(a, w, recipe == "int8x2")

    got = run(a.to(cuda), w.to(cuda))
    assert got.is_cuda and got.dtype == torch.float32
    assert torch.equal(got.cpu(), run(a, w))


def test_layer_forward_int8_on_card(cuda):
    """``qkan_layer_forward_batched_int8`` at N = K = 16, degree 7, B 256
    on the card: within 2e-3 of the exact forward (the JAX suite's
    bar)."""
    rng = np.random.default_rng(11)
    x = torch.as_tensor(rng.uniform(-1, 1, (256, 16)), dtype=torch.float32,
                        device=cuda)
    w = torch.as_tensor(rng.uniform(-1, 1, (8, 256)), dtype=torch.float32,
                        device=cuda)
    got = ql.qkan_layer_forward_batched_int8(x, w, 16, 16)
    torch.backends.cuda.matmul.allow_tf32 = False
    exact = ql.qkan_layer_forward_batched(x, w, 16, 16)
    assert float((got - exact).abs().max()) < 2e-3


def test_run_experiment_on_card(cuda, tmp_path):
    torch.backends.cuda.matmul.allow_tf32 = False
    cols = market_columns(n_rows=400, n_features=4)
    results = {}
    for device in ("cuda", "cpu"):
        cfg = {
            "name": f"tiny_{device}",
            "data": {"data_path": "(columns)", "n_rows": 400,
                     "train_ratio": 0.8,
                     "feature_cols": [f"feature_{i:02d}" for i in range(4)],
                     "target_col": "responder_6", "weight_col": "weight",
                     "date_col": "date_id"},
            "models": [
                {"model_type": "qkan", "network_shape": [4, 1],
                 "max_degree": 3, "num_reads": 32},
                {"model_type": "mlp", "network_shape": [4, 8, 1],
                 "hidden_dims": [8], "learning_rate": 0.001,
                 "batch_size": 64, "n_epochs": 3},
                {"model_type": "fixed_kan", "network_shape": [4, 4, 1],
                 "max_degree": 3, "complexity_weight": 0.001,
                 "num_reads": 32, "n_epochs": 2, "batch_size": 64,
                 "learning_rate": 0.01},
            ],
            "random_seed": 42, "num_trials": 1,
            "save_path": str(tmp_path / device / "results"),
            "log_path": str(tmp_path / device / "logs"),
        }
        path = tmp_path / f"{device}.json"
        path.write_text(json.dumps(cfg))
        results[device] = run_experiment(str(path), device=device,
                                         columns=cols)
        assert (tmp_path / device / "results" / "runs.jsonl").exists()
    for r in results["cuda"]:
        assert np.isfinite([r.MSE_Score, r.R2_Score,
                            *r.val_metrics.values()]).all()
    card, cpu = results["cuda"][0], results["cpu"][0]
    assert card.model_params == cpu.model_params
    assert card.MSE_Score == pytest.approx(cpu.MSE_Score, rel=1e-9)
