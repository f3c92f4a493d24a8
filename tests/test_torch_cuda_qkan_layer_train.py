"""The QKAN layer's trainer on the card (K5, its fixed-order dW pass and
Adam) against the plain float64 reference, at the benchmark cell's
widths (N = K = 16, degree 7) and 262,144 rows.  Every test here needs a
CUDA card and skips without one.

This file imports torch and numpy only, so it runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_cuda_qkan_layer_train.py -q

Bars: the limits of the cell's check
(``perfbench/limits/qkan-layer-16x16-d7.json``), read the same way: each
step's loss relative, the first step's gradient and the weights after
three steps by the norm of the difference (over the reference's
gradient, and over its change).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import plain_qkan_layer as plain
from qkan_implementation_tpu_torch.models.qkan_layer import (
    QKANLayerTrainer,
    qkan_layer_train,
)

pytestmark = pytest.mark.gpu

N, K, D = 16, 16, 7
ROWS, BATCH, STEPS = 262_144, 65_536, 3
LIMITS = json.loads((Path(__file__).resolve().parents[1] / "perfbench"
                     / "limits" / "qkan-layer-16x16-d7.json").read_text())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _norm(t) -> float:
    return float(torch.linalg.vector_norm(t.double()))


@pytest.mark.parametrize("warm_epochs", [0, 1])
def test_trainer_matches_float64_reference(cuda, warm_epochs):
    """From fresh Adam state, and after an epoch (the state carried)."""
    gen = torch.Generator(device=cuda).manual_seed(2**33 + warm_epochs)
    x = torch.rand((ROWS, N), generator=gen, device=cuda) * 2 - 1
    teacher = torch.rand((D + 1, N * K), generator=gen, device=cuda) * 2 - 1
    with plain.matmul_mode(False):
        y = plain.forward(x.double(), teacher.double(), N, K).float()
    y += 0.1 * float(y.std()) * torch.randn(y.shape, generator=gen,
                                            device=cuda)
    w0 = torch.rand((D + 1, N * K), generator=gen, device=cuda) * 2 - 1
    trainer = QKANLayerTrainer(w0, N, K, 1e-3)
    if warm_epochs:
        qkan_layer_train(trainer, x, y, BATCH, warm_epochs)
    rec = trainer.record_steps(STEPS)
    losses = qkan_layer_train(trainer, x, y, BATCH)
    assert np.isfinite(losses).all()
    with plain.matmul_mode(False):
        want = plain.train_steps(
            rec.start.double(), x, y,
            [(s * BATCH, (s + 1) * BATCH) for s in range(STEPS)], N, K,
            1e-3, (rec.mu, rec.nu, rec.count))
    loss_gap = max(abs(float(a) - b) / abs(b)
                   for a, b in zip(rec.losses, want["loss"]))
    grad_gap = _norm(rec.grad.double() - want["grad"]) / _norm(want["grad"])
    change_gap = (_norm(rec.weights[-1].double() - want["weights"][-1])
                  / _norm(want["weights"][-1] - rec.start.double()))
    assert loss_gap <= LIMITS["loss_gap"]
    assert grad_gap <= LIMITS["grad_gap"]
    assert change_gap <= LIMITS["change_gap"]
    assert list(losses[0, :STEPS]) == [float(v) for v in rec.losses]
