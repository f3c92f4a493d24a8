"""The QKAN layer's trainer (``models.qkan_layer``) on the CPU, against the
plain reference ``tests/plain_qkan_layer.py`` at a small size in
float64: the fold and its transpose, each step's loss, the first step's
gradient and the weights after every step, from a fresh Adam state and
from a carried one; the two copies of the plain reference; the spans
and the step counter.

Bars: 1e-10 relative in float64 (the trainer's CPU path and the
reference build the same sums in another order; float64 rounding is
about 1e-16 a term).
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import plain_qkan_layer as plain
from qkan_implementation_tpu_torch.experimental.pallas_layer import (
    weights_to_m3,
)
from qkan_implementation_tpu_torch.models.qkan_layer import (
    QKANLayerTrainer,
    qkan_layer_train,
)
from qkan_implementation_tpu_torch.utils import profiling as P

N, K, D = 4, 3, 3
ROWS, BATCH, STEPS = 300, 100, 3
RTOL = 1e-10
ROOT = Path(__file__).resolve().parents[1]


def _problem(seed=7, n=N, k=K, d=D, rows=ROWS, dtype=torch.float64):
    gen = torch.Generator().manual_seed(seed)
    x = torch.rand((rows, n), generator=gen, dtype=dtype) * 2 - 1
    teacher = torch.rand((d + 1, n * k), generator=gen, dtype=dtype) * 2 - 1
    y = plain.forward(x, teacher, n, k)
    y = y + 0.1 * y.std() * torch.randn(y.shape, generator=gen, dtype=dtype)
    w0 = torch.rand((d + 1, n * k), generator=gen, dtype=dtype) * 2 - 1
    return x, y, w0


def _rel(a, b, base=None) -> float:
    base = b if base is None else base
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(base))


def _batches(first=0):
    return [((first + s) * BATCH, (first + s + 1) * BATCH)
            for s in range(STEPS)]


@pytest.mark.parametrize("warm_epochs", [0, 2])
def test_steps_match_the_plain_reference(warm_epochs):
    """Every loss, the first gradient and the weights after each step,
    from a fresh Adam state and after two epochs (the state carried)."""
    x, y, w0 = _problem()
    trainer = QKANLayerTrainer(w0, N, K, learning_rate=1e-3)
    if warm_epochs:
        qkan_layer_train(trainer, x, y, BATCH, epochs=warm_epochs)
    rec = trainer.record_steps(STEPS)
    losses = qkan_layer_train(trainer, x, y, BATCH)
    assert rec.done and losses.shape == (1, STEPS)
    adam = None if not warm_epochs else (rec.mu, rec.nu, rec.count)
    if not warm_epochs:
        assert rec.count == 0 and not rec.mu.any() and not rec.nu.any()
        assert torch.equal(rec.start, w0)
    want = plain.train_steps(rec.start, x, y, _batches(), N, K, 1e-3, adam)
    for got, ref in zip(losses[0], want["loss"]):
        assert got == pytest.approx(ref, rel=RTOL)
    assert _rel(rec.grad, want["grad"]) < RTOL
    for got, ref in zip(rec.weights, want["weights"]):
        assert _rel(got, ref, ref - rec.start) < RTOL
    assert torch.equal(trainer.weights, rec.weights[-1])
    assert [float(v) for v in rec.losses] == list(losses[0])


def test_record_keeps_only_its_steps():
    x, y, w0 = _problem()
    trainer = QKANLayerTrainer(w0, N, K)
    rec = trainer.record_steps(2)
    qkan_layer_train(trainer, x, y, BATCH)  # 3 steps
    assert len(rec.losses) == 2 and len(rec.weights) == 2
    with pytest.raises(ValueError):
        trainer.record_steps(0)


def test_caller_weights_are_left_as_they_are():
    x, y, w0 = _problem()
    before = w0.clone()
    qkan_layer_train(QKANLayerTrainer(w0, N, K), x, y, BATCH)
    assert torch.equal(w0, before)


@pytest.mark.parametrize("n,k,d", [(N, K, D), (16, 16, 7), (3, 5, 2),
                                   (5, 2, 1)])
def test_fold_is_the_layers_contraction(n, k, d):
    """w2 [(D+1)*N, K] from the reference's own indexing: slot j of
    degree d reads input j // K and adds into output j // N (DILATE and
    the Fortran-order SUM), times 1/(N(D+1)); and the port's
    ``weights_to_m3`` laid out the same way."""
    gen = torch.Generator().manual_seed(n * 100 + k)
    w = torch.rand((d + 1, n * k), generator=gen, dtype=torch.float64)
    trainer = QKANLayerTrainer(w, n, k)
    got = trainer.fold(w)
    want = torch.zeros((d + 1, n, k), dtype=torch.float64)
    for dd in range(d + 1):
        for j in range(n * k):
            want[dd, j // k, j // n] += w[dd, j] / (n * (d + 1))
    assert got.shape == ((d + 1) * n, k) and got.is_contiguous()
    torch.testing.assert_close(got, want.reshape((d + 1) * n, k),
                               rtol=1e-15, atol=1e-16)
    torch.testing.assert_close(
        got, weights_to_m3(w, n, k).reshape((d + 1) * n, k),
        rtol=1e-15, atol=1e-16)


@pytest.mark.parametrize("n,k,d", [(N, K, D), (16, 16, 7), (3, 5, 2)])
def test_unfold_is_the_folds_transpose(n, k, d):
    """<fold(w), v> = <w, unfold(v)> for any w and v, and unfold is
    linear: the gradient the reference's autograd gives through the
    fold."""
    gen = torch.Generator().manual_seed(n + 10 * k)
    w = torch.randn((d + 1, n * k), generator=gen, dtype=torch.float64)
    v = torch.randn(((d + 1) * n, k), generator=gen, dtype=torch.float64)
    trainer = QKANLayerTrainer(w, n, k)
    lhs = float((trainer.fold(w) * v).sum())
    rhs = float((w * trainer.unfold(v)).sum())
    assert lhs == pytest.approx(rhs, rel=1e-12)
    leaf = w.clone().requires_grad_()
    (grad,) = torch.autograd.grad((trainer.fold(leaf) * v).sum(), [leaf])
    torch.testing.assert_close(trainer.unfold(v), grad, rtol=1e-14,
                               atol=1e-18)


def test_two_copies_of_the_reference_agree():
    """``perfbench/reference/qlayer.py`` and ``tests/plain_qkan_layer.py``
    give the same bits on the same inputs."""
    path = ROOT / "perfbench" / "reference" / "qlayer.py"
    spec = importlib.util.spec_from_file_location("bench_qlayer", path)
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    x, y, w0 = _problem(seed=3)
    assert torch.equal(bench.forward(x, w0, N, K), plain.forward(x, w0, N, K))
    a = bench.train_steps(w0, x, y, _batches(), N, K, 1e-3)
    b = plain.train_steps(w0, x, y, _batches(), N, K, 1e-3)
    assert a["loss"] == b["loss"] and torch.equal(a["grad"], b["grad"])
    assert all(torch.equal(p, q) for p, q in zip(a["weights"], b["weights"]))


def test_plain_forward_is_the_ports_layer():
    """The plain reference against the port's golden-tested layer
    (``ops.qkan_layer``, pinned by the JAX package's tests)."""
    from qkan_implementation_tpu_torch.ops.qkan_layer import (
        qkan_layer_forward,
    )

    for n, k, d in [(N, K, D), (16, 16, 7), (3, 5, 2)]:
        x, _, w = _problem(seed=n + k, n=n, k=k, d=d, rows=40)
        torch.testing.assert_close(plain.forward(x, w, n, k),
                                   qkan_layer_forward(x, w, n, k),
                                   rtol=1e-13, atol=1e-15)


def test_float32_step_is_float32():
    x, y, w0 = _problem(dtype=torch.float32)
    trainer = QKANLayerTrainer(w0, N, K)
    loss = trainer.step(x[:BATCH], y[:BATCH])
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert trainer.weights.dtype == torch.float32


@pytest.mark.parametrize("bad", ["x", "y", "batch", "weights"])
def test_bad_shapes_raise(bad):
    x, y, w0 = _problem()
    if bad == "weights":
        with pytest.raises(ValueError):
            QKANLayerTrainer(w0[:, :-1], N, K)
        return
    trainer = QKANLayerTrainer(w0, N, K)
    args = {"x": (x[:, :-1], y, BATCH), "y": (x, y[:, :-1], BATCH),
            "batch": (x, y, ROWS + 1)}[bad]
    with pytest.raises(ValueError):
        qkan_layer_train(trainer, *args)


def test_steps_counter_and_leftover_rows():
    """n // batch_size steps an epoch (the rows past the last whole batch
    are left out), counted on ``qkan_layer_train.steps``."""
    x, y, w0 = _problem()
    before = qkan_layer_train.steps
    out = qkan_layer_train(QKANLayerTrainer(w0, N, K), x, y, 120, epochs=2)
    assert out.shape == (2, 2) and np.isfinite(out).all()
    assert qkan_layer_train.steps - before == 4


SPANS = [P.QLAYER_TRAIN, P.QLAYER_EPOCH, P.QLAYER_STEP, P.QLAYER_FUSED_STEP,
         P.QLAYER_ADAM, P.QLAYER_EPOCH_END]


def test_span_names_are_listed():
    assert all(name in P.SPANS for name in SPANS)
    assert all(name.startswith("qkan.qlayer.") for name in SPANS)


def test_spans_nest_and_count():
    x, y, w0 = _problem()
    trainer = QKANLayerTrainer(w0, N, K)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        qkan_layer_train(trainer, x, y, BATCH, epochs=2)
    spans = {}
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            spans.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    counts = {k: len(v) for k, v in spans.items() if k.startswith("qkan.")}
    assert counts == {P.QLAYER_TRAIN: 1, P.QLAYER_EPOCH: 2,
                      P.QLAYER_STEP: 2 * STEPS,
                      P.QLAYER_FUSED_STEP: 2 * STEPS,
                      P.QLAYER_ADAM: 2 * STEPS, P.QLAYER_EPOCH_END: 2}
    nesting = [(P.QLAYER_EPOCH, P.QLAYER_TRAIN),
               (P.QLAYER_STEP, P.QLAYER_EPOCH),
               (P.QLAYER_FUSED_STEP, P.QLAYER_STEP),
               (P.QLAYER_ADAM, P.QLAYER_STEP),
               (P.QLAYER_EPOCH_END, P.QLAYER_EPOCH)]
    for inner, outer in nesting:
        assert all(any(a <= s and e <= b for a, b in spans[outer])
                   for s, e in spans[inner]), (inner, outer)


def test_no_record_function_without_profiler(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered without a profiler")

    x, y, w0 = _problem()
    trainer = QKANLayerTrainer(w0, N, K)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    qkan_layer_train(trainer, x, y, BATCH)
