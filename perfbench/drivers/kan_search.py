"""Structure-search traffic: ``FixedKAN.optimize`` with the annealer, a
new ``FixedKAN`` each search, back to back.

Set-up makes the rows from the seed and runs one search (the warm-up of
every shape the window uses).  The window runs searches with the seeds
that follow.  The check takes every search of the window: the degrees
each chose, and the last search's scores and coefficients, against the
plain reference's layer-by-layer ridge fits in float64.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from perfbench import data
from perfbench.reference import kan as ref


def search_ridge(columns: int) -> float:
    """The relative ridge of a float32 'normal' sweep: 1e-4 on the Gram
    route; where 2.4e-7 per column exceeds that (Cholesky in float32
    breaks down by size), the ridge-augmented QR route at 1e-6."""
    return 1e-6 if columns * 2.4e-7 > 1e-4 else 1e-4


def _kan(state):
    fk = state["fk"]
    cfg = state["cell"].config
    kcfg = fk.FixedKANConfig.preset(
        cfg["preset"], cfg["network_shape"], cfg["max_degree"],
        complexity_weight=cfg["complexity_weight"])
    return fk.FixedKAN(kcfg, device=state["device"])


def _search(state, seed, spans):
    mix = state["cell"].traffic
    kan = _kan(state)
    with spans("perfbench.search"):
        kan.optimize(state["x"], state["y1h"], num_reads=mix["num_reads"],
                     num_sweeps=mix["num_sweeps"], seed=seed,
                     solver=mix["solver"])
        if state["device"].type == "cuda":
            torch.cuda.synchronize()
    state["searches"].append({
        "degrees": [np.asarray(s["degrees"]) for s in kan.last_search_stats],
        "select_s": sum(s["select_seconds"] for s in kan.last_search_stats),
    })
    state["last"] = kan
    return kan


def _annotate_anneal(state, spans):
    """Put a span around each annealer call of the program."""
    fk = state["fk"]
    solve = fk.solve_qubo

    def spanned(*a, **k):
        with spans("perfbench.solve_qubo"):
            out = solve(*a, **k)
        state["sweeps"] += k["num_sweeps"]
        return out

    fk.solve_qubo = spanned


def setup(cell, seed, device, spans, trace):
    from qkan_implementation_tpu_torch.models import fixed_kan as fk

    x_np, labels = data.digits_784(cell.traffic["rows"], seed)
    x = torch.from_numpy(x_np).to(device)
    y1h = torch.nn.functional.one_hot(
        torch.from_numpy(labels), cell.config["classes"]).to(device, torch.float32)
    state = {"cell": cell, "seed": seed, "device": device, "fk": fk,
             "x": x, "y1h": y1h, "searches": [], "spans": spans, "n": 0,
             "sweeps": 0}
    if trace:
        _annotate_anneal(state, spans)
    _search(state, seed, spans)
    state["searches"].clear()
    return state


def window(state, seconds):
    """Searches back to back until ``seconds`` have passed; the time of a
    search is the whole time over their number."""
    spans = state["spans"]
    count = 0
    t0 = time.perf_counter()
    while True:
        state["n"] += 1
        _search(state, state["seed"] + state["n"], spans)
        count += 1
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds:
            break
    select = sum(s["select_s"] for s in state["searches"])
    return {"metrics": {"search_s": elapsed / count}, "attempted": count,
            "failed": 0, "elapsed_s": elapsed, "select_s": select}


def unit(state):
    """One search, for the profiler."""
    state["n"] += 1
    state["sweeps"] = 0
    _search(state, state["seed"] + state["n"], state["spans"])
    return {"sweeps": state["sweeps"]}


def release(state):
    kan = state.pop("last")
    state["scores"] = [np.asarray(s["scores"]) for s in kan.last_search_stats]
    state["params"] = [{k: v.detach().cpu() for k, v in lp.items()}
                       for lp in kan.params]
    state.pop("fk")


def reference_chain(state, dtype, tf32):
    """The reference's search: for each layer its scores, its optimal
    degree, its coefficients at every degree and its input."""
    cfg = state["cell"].config
    dp1 = cfg["max_degree"] + 1
    cur = state["x"].to(dtype)
    y = state["y1h"].to(dtype)
    out = []
    with ref.matmul_mode(tf32):
        for width in cfg["network_shape"][1:]:
            n = cur.shape[1]
            scores, coeffs = ref.layer_sweep(
                cur, y, cfg["max_degree"], search_ridge(n * dp1),
                apply_tanh=cfg["consistent_tanh"])
            pen = ref.penalized(scores, cfg["complexity_weight"])
            best = int(np.argmin(pen))
            out.append({"scores": scores, "pen": pen, "coeffs": coeffs,
                        "input": cur})
            lp = {"degrees": torch.full((width,), best, device=cur.device),
                  "coefficients": _full_coefficients(coeffs[best], width, dp1),
                  "horizontal_weights": torch.ones(width, dtype=dtype,
                                                   device=cur.device)}
            cur = ref.layer(lp, cur, cfg["max_degree"])
    return out


def _full_coefficients(c, width, dp1):
    """[in, d+1, T] -> every neuron's [width, in, D+1, T], zero above d."""
    n, d1, t = c.shape
    full = torch.zeros((width, n, dp1, t), dtype=c.dtype, device=c.device)
    full[:, :, :d1, :] = c
    return full


def compare(scores, degrees_by_search, params, chain) -> dict:
    """score_gap: the worst relative gap of a layer's score at a degree;
    degree_misses: how many neurons, over every search and layer, took
    another degree than the least penalised score; fit_gap: the worst
    layer's relative gap between its output with the program's degrees
    and coefficients and with the reference's optimal ones, on the
    reference's layer input."""
    score_gap = max(float(np.max(np.abs(s - c["scores"]) / np.abs(c["scores"])))
                    for s, c in zip(scores, chain))
    degree_misses = sum(int(np.sum(np.asarray(d) != int(np.argmin(c["pen"]))))
                        for degs in degrees_by_search
                        for d, c in zip(degs, chain))
    fit_gap = 0.0
    for lp, c in zip(params, chain):
        x = c["input"]
        dev, dt = x.device, x.dtype
        width, dp1 = lp["coefficients"].shape[0], lp["coefficients"].shape[2]
        best = int(np.argmin(c["pen"]))
        hw = torch.ones(width, dtype=dt, device=dev)
        got = ref.layer({"degrees": lp["degrees"].to(dev), "horizontal_weights": hw,
                         "coefficients": lp["coefficients"].to(dev, dt)},
                        x, dp1 - 1)
        want = ref.layer({"degrees": torch.full((width,), best, device=dev),
                          "horizontal_weights": hw,
                          "coefficients": _full_coefficients(
                              c["coeffs"][best], width, dp1)}, x, dp1 - 1)
        fit_gap = max(fit_gap, float(torch.linalg.vector_norm(got - want)
                                     / torch.linalg.vector_norm(want)))
    return {"score_gap": score_gap, "degree_misses": float(degree_misses),
            "fit_gap": fit_gap}


def _as_program(chain, width_of) -> tuple:
    """A reference chain put in the program's place: its scores, optimal
    degrees and coefficients."""
    scores = [c["scores"] for c in chain]
    degrees = [[np.full(w, int(np.argmin(c["pen"]))) for c, w in
                zip(chain, width_of)]]
    dp1 = len(chain[0]["scores"])
    params = [{"degrees": torch.as_tensor(d),
               "coefficients": _full_coefficients(c["coeffs"][int(d[0])],
                                                  len(d), dp1)}
              for d, c in zip(degrees[0], chain)]
    return scores, degrees, params


def check(state, control=False) -> dict:
    want = reference_chain(state, torch.float64, tf32=False)
    if control:
        lower = reference_chain(state, torch.float32, tf32=True)
        got = _as_program(lower, state["cell"].config["network_shape"][1:])
    else:
        got = (state["scores"], [s["degrees"] for s in state["searches"]],
               state["params"])
    return compare(*got, want)
