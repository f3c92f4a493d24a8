"""Layer training traffic: one QKANLayer trained by the program's
``models.qkan_layer`` trainer on rows resident on the card, in contiguous
batches, one epoch a call, back to back.

Set-up makes from the seed, on the device: the rows x ~ U[-1, 1]^N, a
teacher's weights and the start weights ~ U[-1, 1]^[D+1, N*K], and the
targets, the teacher's outputs (the plain reference, in float32 with
TF32 off, a batch at a time) plus Gaussian noise at 10 % of their
standard deviation.  It builds one trainer and runs one epoch: the
warm-up of every shape the window uses.

The window continues the same trainer, one epoch a call of
``qkan_layer_train``, each ending in its one host read of the epoch's
losses.  Before the window the benchmark asks the trainer for the record
of its next three steps (``record_steps``): the first three steps of the
window's first epoch, on the first three batches of the rows.  Once the
window has closed, the plain reference, in float64, follows the same
three steps from the same start weights and Adam state on the same
batches.  The traced unit is ``UNIT_EPOCHS`` epochs of the same loop.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from perfbench.reference import qlayer as ref

CHECK_STEPS = 3
# the traced unit: 16 epochs (64 steps, about 0.1 s on an H100).  One
# epoch is 4 steps and about 6 ms of device time, where the profiler's
# own start and the first steps' host path under it left the card idle
# 42-45 % of the unit against 9 % in the untraced loop (PERF.md)
UNIT_EPOCHS = 16
NOISE = 0.1  # the targets' noise, a share of the teacher's output's std


def _uniform(shape, gen, device):
    return torch.rand(shape, generator=gen, device=device) * 2.0 - 1.0


def _teacher(x, weights, n, k, batch):
    """The teacher's outputs [rows, K], float32, a batch at a time."""
    out = torch.empty((x.shape[0], k), device=x.device)
    with ref.matmul_mode(False):
        for a in range(0, x.shape[0], batch):
            out[a:a + batch] = ref.forward(x[a:a + batch], weights, n, k)
    return out


def make_data(cell, seed, device) -> dict:
    """x [rows, N], y [rows, K] and the start weights [D+1, N*K], float32
    on ``device``, from ``seed`` alone."""
    cfg, mix = cell.config, cell.traffic
    n, k, dp1 = cfg["N"], cfg["K"], cfg["max_degree"] + 1
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    teacher = _uniform((dp1, n * k), gen, device)
    start = _uniform((dp1, n * k), gen, device)
    x = _uniform((mix["rows"], n), gen, device)
    y = _teacher(x, teacher, n, k, mix["batch_size"])
    noise = torch.randn(y.shape, generator=gen, device=device)
    y.add_(noise, alpha=NOISE * float(torch.std(y)))
    return {"x": x, "y": y, "start": start}


def setup(cell, seed, device, spans, trace):
    from qkan_implementation_tpu_torch.models import qkan_layer

    cfg, mix = cell.config, cell.traffic
    if mix["loss"] != "mse":
        raise ValueError(f"the trainer takes loss 'mse', not {mix['loss']!r}")
    data = make_data(cell, seed, device)
    trainer = qkan_layer.QKANLayerTrainer(
        data["start"], cfg["N"], cfg["K"], mix["learning_rate"])
    qkan_layer.qkan_layer_train(trainer, data["x"], data["y"],
                                mix["batch_size"])
    if device.type == "cuda":
        torch.cuda.synchronize()
    return {"cell": cell, "device": device, "train": qkan_layer.qkan_layer_train,
            "trainer": trainer, "x": data["x"], "y": data["y"],
            "batch": mix["batch_size"]}


def _epoch(state) -> bool:
    """One epoch; whether all its losses are finite."""
    losses = state["train"](state["trainer"], state["x"], state["y"],
                            state["batch"])
    return bool(np.isfinite(losses).all())


def window(state, seconds):
    """Epochs back to back until ``seconds`` have passed; the rate is all
    rows of all steps over the whole time."""
    steps = state["x"].shape[0] // state["batch"]
    state["record"] = state["trainer"].record_steps(CHECK_STEPS)
    t0 = time.perf_counter()
    epochs, failed = 0, 0
    while True:
        failed += not _epoch(state)
        epochs += 1
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds:
            break
    return {
        "metrics": {"train_rows_per_s": epochs * steps * state["batch"]
                    / elapsed},
        "attempted": epochs, "failed": failed,
        "step_s": elapsed / (epochs * steps), "steps": epochs * steps,
        "batch": state["batch"],
    }


def unit(state):
    """``UNIT_EPOCHS`` epochs, for the profiler."""
    for _ in range(UNIT_EPOCHS):
        _epoch(state)
    return {"steps": UNIT_EPOCHS * (state["x"].shape[0] // state["batch"])}


def release(state):
    """Keep the record of the window's first steps on the host; drop the
    trainer."""
    rec = state.pop("record")
    state["steps"] = {
        "start": rec.start.cpu(),
        "adam": (rec.mu.cpu(), rec.nu.cpu(), rec.count),
        "loss": [float(v) for v in rec.losses],
        "grad": rec.grad.cpu(),
        "after": rec.weights[-1].cpu(),
    }
    state.pop("trainer")


def _batches(state) -> list:
    bs = state["batch"]
    return [(s * bs, (s + 1) * bs) for s in range(CHECK_STEPS)]


def _reference(state, dtype, tf32) -> dict:
    cfg = state["cell"].config
    dev = state["device"]
    with ref.matmul_mode(tf32):
        out = ref.train_steps(
            state["steps"]["start"].to(dev, dtype), state["x"], state["y"],
            _batches(state), cfg["N"], cfg["K"],
            state["cell"].traffic["learning_rate"], state["steps"]["adam"])
    return {"loss": out["loss"], "grad": out["grad"].cpu(),
            "after": out["weights"][-1].cpu()}


def program_readings(state) -> dict:
    return {k: state["steps"][k] for k in ("loss", "grad", "after")}


def control_readings(state) -> dict:
    """The reference in float32 with TF32 products, in the program's
    place."""
    return _reference(state, torch.float32, tf32=True)


def _norm(t) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def compare(got: dict, want: dict, start) -> dict:
    """The loss of each of the first three steps, relative; the first
    step's gradient w.r.t. the weights (K5's dW through the fold's
    transpose), as the norm of the difference over the reference's norm;
    the weights after the three steps, as the norm of the difference
    over the norm of the reference's change."""
    return {
        "loss_gap": max(abs(a - b) / abs(b)
                        for a, b in zip(got["loss"], want["loss"])),
        "grad_gap": _norm(got["grad"].double() - want["grad"].double())
        / _norm(want["grad"]),
        "change_gap": _norm(got["after"].double() - want["after"].double())
        / _norm(want["after"].double() - start.double()),
    }


def check(state, control=False) -> dict:
    want = _reference(state, torch.float64, tf32=False)
    got = control_readings(state) if control else program_readings(state)
    return compare(got, want, state["steps"]["start"])
