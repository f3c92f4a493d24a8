"""``DegreeOptimizer`` of the torch port against the JAX package, on the
CPU in float64 (the JAX side x64).

Bars:
- ``evaluate_degree`` on both routes ('svd': numpy's lstsq over the
  transforms; 'gram': the Gram statistics and the leading-block solves),
  weighted and not, one and three targets, with ``target_projection``:
  scores and comp-R^2 within 1e-10 relative, 1e-12 absolute (the port's
  Gram sums run in another order and chunking, measured <= 1e-13
  relative; a comp-R^2 of a centred target's degree-0 fit is 0 up to
  rounding);
- ``evaluate_degree_cv`` in both fold strategies: 1e-10 relative;
- ``optimize_layer`` / ``fit`` / ``predict`` (layer 0 and
  ``full_network``): degrees EQUAL to JAX's and to the QUBO's ground
  state (the blockwise argmin of its one-hot blocks: the annealers'
  random streams differ, so both are held to the exact answer);
  predictions within 1e-12 of max|pred|;
- ``analyze_network`` within 1e-10 of max|contribution|;
- a state saved by either package loads in the other and predicts the
  same (1e-12).
"""

import numpy as np
import pandas as pd
import pytest

from qkan_implementation_tpu.anneal import degree_selection_qubo
from qkan_implementation_tpu.optim import DegreeOptimizer as JaxOpt
from qkan_implementation_tpu_torch.optim import DegreeOptimizer as PortOpt
from qkan_implementation_tpu_torch.optim import degree_optimizer as t_dopt

SCORE_RTOL = 1e-10
SCORE_ATOL = 1e-12


def frame(n=300, n_features=3, seed=1, n_targets=1):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.1, 1.1, (n, n_features))
    y = 2 * x[:, 0] ** 2 - 1 + 0.3 * np.sin(3 * x[:, 1])
    y = y + 0.05 * rng.normal(size=n)
    if n_targets > 1:
        y = np.stack([y, x[:, 1] ** 3, y * x[:, 2]], axis=1)[:, :n_targets]
    df = pd.DataFrame(x, columns=[f"feature_{i:02d}"
                                  for i in range(n_features)])
    return df, y.reshape(n, -1), rng.uniform(0.5, 2.0, n)


def pair(shape, max_degree, **kw):
    return (JaxOpt(shape, max_degree, **kw),
            PortOpt(shape, max_degree, device="cpu", **kw))


def assert_scores(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=SCORE_RTOL, atol=SCORE_ATOL)


@pytest.mark.parametrize("n_targets,projection", [(1, None), (3, None),
                                                  (3, 2)])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("method", ["svd", "gram"])
def test_evaluate_degree_matches_jax(method, weighted, n_targets, projection):
    df, y, w = frame(n_targets=n_targets)
    j, t = pair([3, 1], 4, target_projection=projection)
    weights = w if weighted else None
    want = j.evaluate_degree(df, y, weights, method=method)
    got = t.evaluate_degree(df, y, weights, method=method)
    assert_scores(got, want)


def test_evaluate_degree_auto_route_and_cache():
    """'auto' takes 'gram' above 2,000,000 basis elements as JAX does; the
    cache keys on the weights (a weighted re-score is not the cached
    unweighted one)."""
    df, y, w = frame(n=2000, n_features=250)
    calls = []
    real = t_dopt._gram_stats

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    t_dopt._gram_stats = spy
    try:
        t = PortOpt([250, 1], 3, device="cpu")  # 2000*250*4 = 2,000,000
        t.evaluate_degree(df, y)
        assert not calls
        t2 = PortOpt([250, 1], 4, device="cpu")  # 2,500,000
        got = t2.evaluate_degree(df, y)
        assert calls
    finally:
        t_dopt._gram_stats = real
    assert_scores(got, JaxOpt([250, 1], 4).evaluate_degree(df, y))
    unweighted = t2.evaluate_degree(df.iloc[:300], y[:300])
    weighted = t2.evaluate_degree(df.iloc[:300], y[:300], w[:300])
    assert not np.allclose(unweighted[0], weighted[0])


@pytest.mark.parametrize("strategy", ["expanding", "time"])
def test_evaluate_degree_cv_matches_jax(strategy):
    df, y, w = frame(n=600)
    ts = np.sort(np.random.default_rng(4).integers(0, 30, 600))
    j, t = pair([3, 1], 3)
    want = j.evaluate_degree_cv(df, y, ts, w, n_splits=3, strategy=strategy)
    got = t.evaluate_degree_cv(df, y, ts, w, n_splits=3, strategy=strategy)
    assert_scores(got, want)
    with pytest.raises(ValueError, match="Unknown strategy"):
        t.evaluate_degree_cv(df, y, ts, strategy="random")


def ground_state_degrees(opt, scores, n_in, n_out):
    """The degree QUBO's ground state: the argmin of each one-hot block's
    linear terms (the blocks do not couple)."""
    definitive, best = opt.is_degree_definitive(scores)
    model = degree_selection_qubo(
        scores, n_in * n_out, opt.complexity_weight,
        definitive_degree=best if definitive else None)
    dp1 = opt.max_degree + 1
    block = int(np.argmin(model.h[:dp1]))
    assert np.all(model.h.reshape(-1, dp1).argmin(axis=1) == block)
    return [[block] * n_in for _ in range(n_out)]


@pytest.mark.parametrize("complexity_weight", [0.1, 1e-4])
def test_fit_predict_layer0_matches_jax(complexity_weight):
    df, y, w = frame()
    j, t = pair([3, 2, 1], 4, complexity_weight=complexity_weight)
    kw = dict(num_reads=64, num_sweeps=200, seed=3)
    j.fit(df, y, weights=w, **kw)
    t.fit(df, y, weights=w, **kw)
    scores, _ = t.evaluate_degree(df, y, w)
    assert t.optimal_degrees == j.optimal_degrees == ground_state_degrees(
        t, scores, 3, 2)
    np.testing.assert_array_equal(t.qkan_weights, j.qkan_weights)
    want = j.predict(df)
    got = t.predict(df)
    assert got.shape == want.shape == (len(df), 2)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-12 * np.abs(want).max())


def test_fit_full_network_matches_jax():
    df, y, w = frame(n=400)
    j, t = pair([3, 2, 1], 3, complexity_weight=1e-3)
    kw = dict(num_reads=64, num_sweeps=200, seed=1)
    j.fit(df, y, full_network=True, **kw)
    t.fit(df, y, full_network=True, **kw)
    assert t.optimal_degrees_stack == j.optimal_degrees_stack
    for tw_, jw_ in zip(t.qkan_weights_stack, j.qkan_weights_stack):
        np.testing.assert_array_equal(tw_, jw_)
    want, got = j.predict(df), t.predict(df)
    assert got.shape == want.shape == (len(df), 1)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-12 * np.abs(want).max())


def test_optimize_layer_with_given_scores_and_network():
    """``scores=`` skips the in-sample scoring; ``optimize_network`` runs
    layer by layer; ``is_degree_definitive`` as JAX."""
    j, t = pair([2, 1], 3)
    for scores in ([0.9, 0.5, 1e-8, 1e-8], [0.9, 0.5, 0.01, 0.3]):
        assert t.is_degree_definitive(np.array(scores)) == \
            j.is_degree_definitive(np.array(scores))
    scores = np.array([0.9, 0.5, 0.01, 0.3])
    got = t.optimize_layer(0, None, None, scores=scores, num_reads=32,
                           num_sweeps=100)
    assert got == ground_state_degrees(t, scores, 2, 1) == [[2, 2]]
    df, y, _ = frame(n=200, n_features=2)
    data = {"layer_0_input": df.to_numpy(), "layer_0_output": y}
    assert t.optimize_network(data, num_reads=32) == \
        j.optimize_network(data, num_reads=32)


def test_analyze_network_matches_jax():
    df, y, w = frame()
    j, t = pair([3, 2], 4, complexity_weight=1e-4)
    j.fit(df, y, num_reads=64, num_sweeps=200)
    t.fit(df, y, num_reads=64, num_sweeps=200)
    want = j.analyze_network(df, y)
    got = t.analyze_network(df, y)
    assert got["neuron_degrees"] == want["neuron_degrees"]
    scale = np.abs(want["neuron_contributions"]).max()
    for key in ("neuron_contributions", "combined_fit"):
        np.testing.assert_allclose(got[key], want[key], rtol=0,
                                   atol=1e-10 * scale)
    with pytest.raises(RuntimeError, match="Not fitted"):
        PortOpt([3, 1], 2, device="cpu").analyze_network(df, y)


QUERY = {"n_rows": 300, "columns": ["a"], "sort_by": "date_id"}


@pytest.mark.parametrize("full_network", [False, True])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_state_round_trips_between_packages(tmp_path, writer, full_network):
    df, y, w = frame()
    j, t = pair([3, 2, 1], 3, complexity_weight=1e-3)
    src, dst = (j, PortOpt([1, 1], 1, device="cpu")) if writer == "jax" \
        else (t, JaxOpt([1, 1], 1))
    src.fit(df, y, full_network=full_network, num_reads=32, num_sweeps=100)
    src.evaluate_degree(df, y)
    path = str(tmp_path / "state")
    src.save_state(path, QUERY)
    dst.load_state(path, dict(QUERY))
    assert dst.network_shape == [3, 2, 1] and dst.max_degree == 3
    assert dst.optimal_degrees == src.optimal_degrees
    assert len(dst.degree_scores) == len(src.degree_scores)
    want, got = src.predict(df), dst.predict(df)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-12 * np.abs(want).max())
    # a different query drops the cached scores
    dst.load_state(path, dict(QUERY, n_rows=1))
    assert dst.degree_scores == {} and not dst.data_same


def test_predict_before_fit_raises():
    with pytest.raises(RuntimeError, match="Not fitted"):
        PortOpt([1, 1], 2, device="cpu").predict(np.zeros((3, 1)))


def test_plots_render_and_interactive_test_matches_jax(tmp_path):
    """``run_interactive_test`` picks JAX's degrees on the reference's
    Runge target; the degree plots and ``visualize_analysis`` render (the
    harness tests render ``ResultVisualizer``'s)."""
    import matplotlib.pyplot as plt

    from qkan_implementation_tpu.experiments.degree_viz import (
        run_interactive_test as jax_interactive,
    )
    from qkan_implementation_tpu_torch.experiments import degree_viz

    path = tmp_path / "runge.png"
    opt, fig = degree_viz.run_interactive_test(
        "runge", n_points=120, max_degree=5, save_path=str(path),
        device="cpu")
    j_opt, _ = jax_interactive("runge", n_points=120, max_degree=5)
    assert opt.optimal_degrees == j_opt.optimal_degrees
    assert path.exists() and len(fig.axes) == 4
    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(-1, 1, 120)).reshape(-1, 1)
    y = degree_viz.TEST_FUNCTIONS["runge"](x)
    assert len(degree_viz.plot_degree_optimization(opt, x, y).axes) == 3
    fig = opt.visualize_analysis(opt.analyze_network(x, y), x, y,
                                 save_path=str(tmp_path / "analysis.png"))
    assert len(fig.axes) == 2 and (tmp_path / "analysis.png").exists()
    with pytest.raises(ValueError, match="Unknown function"):
        degree_viz.run_interactive_test("nope", device="cpu")
    plt.close("all")
