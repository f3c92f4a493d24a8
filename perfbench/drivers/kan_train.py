"""Training traffic: ``FixedKAN.train``, one epoch a call, back to back.

Set-up makes the rows and the start parameters from the seed, builds one
``FixedKAN`` and drives it through its first call (one epoch: the warm-up
of every shape the window uses).  The window continues the same object,
one epoch a call, each call with the next seed for its shuffle.  Each
call builds its own Adam state and cosine schedule, so an epoch follows
from its start parameters and its seed alone.

Through the window's first epoch, the second call of ``train`` on the
object, the benchmark stands in for the package's public forward,
``fixed_kan.kan_apply``, which ``train`` calls once a step with the
parameters as they are at that step: it keeps the parameters of the
first step and of the fourth (the state after three updates) and the
logits of the first three.  Once the window has closed, the plain
reference, in float64, follows that epoch's first three steps from the
same parameters, rows and shuffle.

Later epochs are not compared: over a 30-s window most seeds train the
model close to a zero loss on these rows, where Adam's first steps are
led by the sign of gradients at the rounding level and sound runs read
as far from the reference as the control.  Nor is a whole epoch: over
its 156 steps rounding grows the same way.  The first timed epoch is the
same epoch however fast the program runs.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from perfbench import counts, data
from perfbench.reference import kan as ref

CHECK_STEPS = 3


def _train_kwargs(cell) -> dict:
    cfg, mix = cell.config, cell.traffic
    preset = cfg["train"]
    return dict(
        epochs=1, batch_size=mix["batch_size"],
        learning_rate=preset["learning_rate"], loss=mix["loss"],
        trainable=preset["trainable"], grad_clip=preset["grad_clip"],
        lr_scale=preset["lr_scale"], lr_schedule=preset["lr_schedule"],
        backend=mix["backend"],
    )


def _copy(params) -> list:
    return [{k: v.detach().clone() for k, v in lp.items()} for lp in params]


def setup(cell, seed, device, spans, trace):
    from qkan_implementation_tpu_torch.models import fixed_kan as fk

    cfg, mix = cell.config, cell.traffic
    shape, max_degree = cfg["network_shape"], cfg["max_degree"]
    x_np, labels = data.digits_784(mix["rows"], seed)
    x = torch.from_numpy(x_np).to(device)
    y = torch.from_numpy(labels).to(device)
    dims = counts.fixed_kan_dims(shape, cfg["classes"])
    params0 = data.kan_params(dims, shape[1:], max_degree, seed, device)
    kcfg = fk.FixedKANConfig.preset(
        cfg["preset"], shape, max_degree,
        complexity_weight=cfg["complexity_weight"],
        layer_backend=mix["backend"])
    kan = fk.FixedKAN(kcfg, device=device)
    kan.params = _copy(params0)
    kw = _train_kwargs(cell)
    kan.train(x, y, seed=seed, **kw)
    if device.type == "cuda":
        torch.cuda.synchronize()
    return {"cell": cell, "seed": seed, "device": device, "kan": kan,
            "x": x, "y": y, "kw": kw, "epochs": 0}


class _Steps:
    """Stands in for ``fixed_kan.kan_apply`` while open and keeps the
    parameters at the first and fourth steps and the logits of the first
    three."""

    def __init__(self):
        from qkan_implementation_tpu_torch.models import fixed_kan

        self.module = fixed_kan
        self.calls, self.logits, self.params = 0, [], []

    def __enter__(self):
        apply = self.apply = self.module.kan_apply

        def forward(params, *a, **k):
            self.calls += 1
            if self.calls in (1, CHECK_STEPS + 1):
                self.params.append(_copy(params))
            out = apply(params, *a, **k)
            if self.calls <= CHECK_STEPS:
                self.logits.append(out.detach().clone())
            return out

        self.module.kan_apply = forward
        return self

    def __exit__(self, *exc):
        self.module.kan_apply = self.apply
        return False


def _epoch(state):
    """One call of ``train``; returns the seed of its shuffle."""
    state["epochs"] += 1
    seed = state["seed"] + state["epochs"]
    state["kan"].train(state["x"], state["y"], seed=seed, **state["kw"])
    return seed


def window(state, seconds):
    """Epochs back to back until ``seconds`` have passed; the rate is all
    rows of all steps over the whole time."""
    n, bs = state["x"].shape[0], state["kw"]["batch_size"]
    steps = n // bs
    t0 = time.perf_counter()
    with _Steps() as reader:
        reader.seed = _epoch(state)
    epochs = 1
    elapsed = time.perf_counter() - t0
    while elapsed < seconds:
        _epoch(state)
        epochs += 1
        elapsed = time.perf_counter() - t0
    state["reader"] = reader
    return {
        "metrics": {"train_rows_per_s": epochs * steps * bs / elapsed},
        "attempted": epochs, "failed": 0,
        "step_s": elapsed / (epochs * steps), "steps": epochs * steps,
        "batch": bs,
    }


def unit(state):
    """One epoch, for the profiler."""
    _epoch(state)
    return {"steps": state["x"].shape[0] // state["kw"]["batch_size"]}


def release(state):
    """Keep the first timed epoch's readings on the host; drop the
    model."""
    reader = state.pop("reader")

    def on_host(params):
        return [{k: v.cpu() for k, v in lp.items()} for lp in params]

    start, after = reader.params
    state["epoch"] = {"seed": reader.seed, "start": on_host(start),
                      "after": on_host(after),
                      "logits": [t.cpu() for t in reader.logits]}
    state.pop("kan")


def _first_batches(state, seed) -> list:
    """The rows of the first steps of the epoch shuffled by ``seed``, as
    ``train`` draws them."""
    n, bs = state["x"].shape[0], state["kw"]["batch_size"]
    steps = n // bs
    perm = np.random.default_rng(seed).permutation(n)[: steps * bs]
    return [torch.from_numpy(r) for r in perm.reshape(steps, bs)[:CHECK_STEPS]]


def _reference(state, dtype, tf32):
    cell, kw, ep = state["cell"], state["kw"], state["epoch"]
    dev = state["device"]
    with ref.matmul_mode(tf32):
        return ref.train_steps(
            ref.cast_params(ep["start"], dtype, dev),
            state["x"].to(dtype), state["y"],
            [b.to(dev) for b in _first_batches(state, ep["seed"])],
            cell.config["max_degree"], kw["learning_rate"], kw["grad_clip"],
            decay_steps=state["x"].shape[0] // kw["batch_size"])


def _leaves(params) -> list:
    return ([lp["horizontal_weights"] for lp in params]
            + [lp["coefficients"] for lp in params])


def _change(start, end) -> list:
    return [float(torch.linalg.vector_norm((b - a).double()))
            for a, b in zip(_leaves(start), _leaves(end))]


def program_readings(state) -> dict:
    ep = state["epoch"]
    y = state["y"].cpu()
    return {
        "loss": [float(ref.cross_entropy(lg.double(), y[b])) for lg, b in
                 zip(ep["logits"], _first_batches(state, ep["seed"]))],
        "change": _change(ep["start"], ep["after"]),
    }


def control_readings(state) -> dict:
    """The reference in float32 with TF32 products, in the program's
    place."""
    return _reference(state, torch.float32, tf32=True)


def compare(got: dict, want: dict) -> dict:
    """The loss of each of the first three steps, and the parameters'
    change after them by the worst leaf: the gap between the program's
    norm and the reference's, against the larger of that leaf's
    reference norm and the median leaf's.  Leaves whose reference
    gradient at the first step is under a thousandth of the median
    leaf's are left out of the change."""
    med_g = float(np.median(want["grad1"]))
    keep = [g >= 1e-3 * med_g for g in want["grad1"]]
    med = float(np.median([w for w, k in zip(want["change"], keep) if k]))
    return {
        "loss_gap": max(abs(a - b) / abs(b)
                        for a, b in zip(got["loss"], want["loss"])),
        "change_gap": max(abs(g - w) / max(w, med) for g, w, k in
                          zip(got["change"], want["change"], keep) if k),
    }


def check(state, control=False) -> dict:
    want = _reference(state, torch.float64, tf32=False)
    got = control_readings(state) if control else program_readings(state)
    return compare(got, want)
