"""Degree-search traffic on market rows: trials of the 'qkan' model as the
market experiment runs them, back to back.

A trial builds a new ``DegreeOptimizer``, fits it on the training rows
with their weights (the Gram statistics, the degree QUBO and the
annealer), predicts the validation and the training rows and scores
both.  Set-up makes the columns from the seed, prepares them into
arrays and runs one trial (the warm-up).  The check takes the degrees of
every trial of the window, and the last trial's scores, validation
predictions and the metrics it scored both predictions by, against the
plain reference in float64.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from perfbench import data
from perfbench.reference import market as ref


def _trial(state, seed):
    cfg, mix = state["cell"].config, state["cell"].traffic
    dopt, metrics = state["dopt"], state["metrics"]
    tr, tt, tw, va, vt, vw = state["arrays"]
    opt = dopt.DegreeOptimizer(
        network_shape=cfg["network_shape"], max_degree=cfg["max_degree"],
        complexity_weight=cfg["complexity_weight"],
        significance_threshold=cfg["significance_threshold"],
        device=state["device"])
    opt.fit(tr, tt, weights=tw, num_reads=mix["num_reads"], seed=seed)
    val_pred = opt.predict(va)
    scored = (metrics(vt, val_pred, vw), metrics(tt, opt.predict(tr), tw))
    state["degrees"].append(np.asarray(opt.optimal_degrees))
    state["last"] = (opt, val_pred, scored)


def _annotate_anneal(state, spans):
    """Put a span around each annealer call of the program."""
    dopt = state["dopt"]
    solve = dopt.solve_qubo

    def spanned(*a, **k):
        with spans("perfbench.solve_qubo"):
            out = solve(*a, **k)
        state["sweeps"] += k.get("num_sweeps", 1000)
        return out

    dopt.solve_qubo = spanned


def setup(cell, seed, device, spans, trace):
    from qkan_implementation_tpu_torch.optim import degree_optimizer as dopt
    from qkan_implementation_tpu_torch.utils.metrics import compute_metrics

    cfg = cell.config
    cols = data.market_columns(cfg["n_rows"], cfg["n_features"],
                               cfg["n_dates"], seed, cfg["signal_frac"])
    arrays = data.market_arrays(cols, cfg["n_features"], cfg["train_ratio"])
    state = {"cell": cell, "seed": seed, "device": device, "dopt": dopt,
             "metrics": compute_metrics, "arrays": arrays, "degrees": [],
             "spans": spans, "n": 0, "sweeps": 0}
    if trace:
        _annotate_anneal(state, spans)
    with spans("perfbench.search"):
        _trial(state, seed)
    state["degrees"].clear()
    return state


def window(state, seconds):
    """Trials back to back until ``seconds`` have passed; the time of a
    search is the whole time over their number."""
    spans = state["spans"]
    count = 0
    t0 = time.perf_counter()
    while True:
        state["n"] += 1
        with spans("perfbench.search"):
            _trial(state, state["seed"] + state["n"])
        count += 1
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds:
            break
    return {"metrics": {"search_s": elapsed / count}, "attempted": count,
            "failed": 0, "elapsed_s": elapsed}


def unit(state):
    """One trial, for the profiler."""
    state["n"] += 1
    state["sweeps"] = 0
    with state["spans"]("perfbench.search"):
        _trial(state, state["seed"] + state["n"])
    return {"sweeps": state["sweeps"]}


def release(state):
    opt, val_pred, scored = state.pop("last")
    (scores, _), = opt.degree_scores.values()
    state["scores"] = np.asarray(scores)
    state["val_pred"] = np.asarray(val_pred)
    state["scored"] = scored
    state.pop("dopt")


def _reference(state, dtype):
    """The reference's scores, selection objective and degrees, its
    layer's inputs, and the metrics of its predictions at its own
    degrees, for the validation and the training rows."""
    cfg = state["cell"].config
    dev = state["device"]
    tr, tt, tw, va, vt, vw = (torch.from_numpy(a).to(dev, dtype)
                              for a in state["arrays"])
    scores = ref.degree_scores(tr, tt, tw, cfg["max_degree"])
    obj = ref.degree_objective(scores, cfg["complexity_weight"],
                               cfg["significance_threshold"])
    k_in, k_out = cfg["network_shape"]
    degrees = np.full((k_out, k_in), int(np.argmin(obj)))
    mean = tr.mean(dim=0)
    std = tr.std(dim=0, unbiased=False) + 1e-8

    def predict(x):
        return ref.layer(x, degrees, cfg["max_degree"], mean, std)

    val_pred = predict(va)
    scored = (ref.metrics(vt, val_pred, vw), ref.metrics(tt, predict(tr), tw))
    return {"scores": scores, "obj": obj, "degrees": degrees,
            "layer_in": (va, mean, std), "val_pred": val_pred,
            "scored": scored}


def compare(scores, degrees_by_trial, val_pred, scored, want,
            state) -> dict:
    """score_gap: the worst relative gap of a degree's score;
    degree_misses: how many edges, over every trial, took another degree
    than the reference's choice; pred_gap: the worst gap of a validation
    prediction, relative to the largest, with the reference's layer at
    the last trial's degrees; metrics_gap: the worst relative gap of a
    metric the trial scored its validation and training predictions by,
    against the reference's metrics of its own predictions."""
    va, mean, std = want["layer_in"]
    ref_scores = want["scores"]
    score_gap = float(np.max(np.abs(scores - ref_scores) / np.abs(ref_scores)))
    best = int(np.argmin(want["obj"]))
    degree_misses = sum(int(np.sum(np.asarray(d) != best))
                        for d in degrees_by_trial)
    want_pred = ref.layer(va, degrees_by_trial[-1],
                          state["cell"].config["max_degree"], mean, std)
    got = torch.as_tensor(val_pred, dtype=want_pred.dtype,
                          device=want_pred.device)
    pred_gap = float(torch.max(torch.abs(got - want_pred))
                     / torch.max(torch.abs(want_pred)))
    metrics_gap = max(abs(g[k] - w[k]) / abs(w[k])
                      for g, w in zip(scored, want["scored"]) for k in w)
    return {"score_gap": score_gap, "degree_misses": float(degree_misses),
            "pred_gap": pred_gap, "metrics_gap": float(metrics_gap)}


def check(state, control=False) -> dict:
    want = _reference(state, torch.float64)
    if control:
        low = _reference(state, torch.float32)
        return compare(low["scores"], [low["degrees"]],
                       low["val_pred"].cpu().numpy(), low["scored"], want,
                       state)
    return compare(state["scores"], state["degrees"], state["val_pred"],
                   state["scored"], want, state)
