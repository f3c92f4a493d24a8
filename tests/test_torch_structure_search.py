"""Structure search of the torch port (``FixedKAN.optimize`` and its degree
sweeps) against the JAX package, on the CPU in float64 (the JAX suite
runs x64; torch's default dtype is set to float64 here, the port's
counterpart).

Bars:
- 'normal' (Gram + Cholesky): scores within rtol 1e-9; coefficients
  within 1e-8 max|c|.  The design is structurally rank-deficient: T_0 is
  the same all-ones column for every input, so the data fix only the SUM
  of a degree's T_0 coefficients over the inputs.  How the sum splits
  among the inputs is set by the ridge, so rounding in either LAPACK
  moves it by up to eps * cond, cond = ||X_d||_F^2 / (ridge * the
  trace-scaled ridge's scale) (measured up to 1e-7 of max|c| against
  JAX on identical inputs, where every other coefficient agrees to
  1e-14).  So the sums and every other coefficient are held at 1e-8
  max|c|, the split at 10 eps cond max|c| (``split_bar``).
- 'qr': scores within rtol 1e-8, coefficients within 1e-6 max|c|.
- 'svd': within 1e-9 of ``numpy.linalg.lstsq`` (scores relative,
  coefficients of max|c|) at every degree, degree 0 included, where the
  JAX package's ``jnp.linalg.lstsq`` can return NaN (ROADMAP.md Queue 3).
- optimize: degrees equal, parameters within the bars above, the
  optimized models' forwards within 1e-8 (relative to max|out|).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from qkan_implementation_tpu.models import fixed_kan as jax_fk
from qkan_implementation_tpu_torch.models import fixed_kan as t_fk
from qkan_implementation_tpu_torch.ops.chebyshev import chebyshev_basis


@pytest.fixture(autouse=True)
def x64():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


def data(seed, b, in_dim, t_dim=3):
    rng = np.random.default_rng(seed)
    return rng.uniform(-2, 2, (b, in_dim)), rng.normal(size=(b, t_dim))


def sweeps(method, x, y, max_degree, quantum=False, **cfg):
    """(JAX scores, JAX coeffs, port scores, port coeffs, port model) of
    one layer's sweep on tanh(x)."""
    in_dim = x.shape[1]
    jk = jax_fk.FixedKAN(jax_fk.FixedKANConfig(
        [in_dim, 4], max_degree, lstsq_method=method, **cfg))
    tk = t_fk.FixedKAN(t_fk.FixedKANConfig(
        [in_dim, 4], max_degree, lstsq_method=method, **cfg), device="cpu")
    xj, yj = jnp.tanh(jnp.asarray(x)), jnp.asarray(y)
    xt, yt = torch.tanh(torch.from_numpy(x)), torch.from_numpy(y)
    if quantum:
        jk.last_quantum_resources, tk.last_quantum_resources = [], []
        sj, cj = jk._evaluate_layer_degrees_quantum(xj, yj)
        st, ct = tk._evaluate_layer_degrees_quantum(xt, yt)
    else:
        sj, cj = jk._evaluate_layer_degrees(xj, yj)
        st, ct = tk._evaluate_layer_degrees(xt, yt)
    return (np.asarray(sj), [np.asarray(c) for c in cj], st,
            [c.numpy() for c in ct], tk)


def split_bar(basis: np.ndarray, d: int, ridge: float) -> float:
    """10 eps cond of the degree-d ridge system (relative to max|c|): the
    first-order rounding of its solution along the directions the data
    leave to the ridge.  ``basis`` [B, in, D+1]; the ridge's scale is
    trace(G)/F of the whole design, as the sweeps take it."""
    full = np.sum(basis**2) / (basis.shape[1] * basis.shape[2])
    return 10 * np.finfo(np.float64).eps * np.sum(basis[:, :, : d + 1] ** 2) \
        / (ridge * full)


def assert_coeffs(got, want, basis, t_dim, identified_bar, ridge=1e-8):
    """Dim-major [in*(d+1), T] coefficients: the T_0 sums over the inputs
    and every other coefficient within identified_bar max|c|, each T_0
    coefficient within split_bar max|c|."""
    in_dim = basis.shape[1]
    for d, (g, w) in enumerate(zip(got, want)):
        g = g.reshape(in_dim, d + 1, t_dim)
        w = w.reshape(in_dim, d + 1, t_dim)
        scale = np.abs(w).max()
        np.testing.assert_allclose(g[:, 0].sum(0), w[:, 0].sum(0), rtol=0,
                                   atol=identified_bar * scale)
        np.testing.assert_allclose(g[:, 1:], w[:, 1:], rtol=0,
                                   atol=identified_bar * scale)
        np.testing.assert_allclose(g[:, 0], w[:, 0], rtol=0,
                                   atol=split_bar(basis, d, ridge) * scale)


@pytest.mark.parametrize("b,in_dim,max_degree", [(200, 6, 4), (300, 4, 3),
                                                 (500, 8, 5), (100, 1, 4)])
@pytest.mark.parametrize("seed", [0, 1])
def test_gram_sweep_matches_jax(b, in_dim, max_degree, seed):
    x, y = data(seed, b, in_dim)
    sj, cj, st, ct, tk = sweeps("normal", x, y, max_degree)
    assert tk._sweep_log[-1]["route"] == "gram"
    np.testing.assert_allclose(st, sj, rtol=1e-9, atol=0)
    basis = chebyshev_basis(torch.tanh(torch.from_numpy(x)), max_degree,
                            clip=False).numpy()
    assert_coeffs(ct, cj, basis, 3, 1e-8)


@pytest.mark.parametrize("b,in_dim,max_degree", [(200, 6, 4), (300, 4, 3),
                                                 (64, 3, 3)])
@pytest.mark.parametrize("seed", [0, 1])
def test_qr_sweep_matches_jax(b, in_dim, max_degree, seed):
    x, y = data(seed, b, in_dim)
    sj, cj, st, ct, tk = sweeps("qr", x, y, max_degree)
    assert tk._sweep_log[-1]["route"] == "qr"
    np.testing.assert_allclose(st, sj, rtol=1e-8, atol=0)
    for g, w in zip(ct, cj):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6 * np.abs(w).max())


@pytest.mark.parametrize("b,in_dim,max_degree", [(600, 64, 3), (200, 6, 4),
                                                 (40, 12, 4)])
def test_svd_sweep_matches_numpy_lstsq(b, in_dim, max_degree):
    """min-norm semantics at every degree, the rank-1 all-ones degree-0
    design included ([600, 64]: the shape of the digits test, where the
    JAX package's 'svd' path has returned NaN)."""
    x, y = data(b, b, in_dim, t_dim=10)
    _, _, st, ct, tk = sweeps("svd", x, y, max_degree)
    assert tk._sweep_log[-1]["route"] == "svd"
    basis = chebyshev_basis(torch.tanh(torch.from_numpy(x)), max_degree,
                            clip=False).numpy()
    for d in range(max_degree + 1):
        X = basis[:, :, : d + 1].reshape(b, -1)
        c = np.linalg.lstsq(X, y, rcond=None)[0]
        score = np.mean((y - X @ c) ** 2)
        np.testing.assert_allclose(st[d], score, rtol=1e-9,
                                   atol=1e-9 * np.mean(y**2))
        np.testing.assert_allclose(ct[d], c, rtol=0,
                                   atol=1e-9 * np.abs(c).max())
    # a 'qr' request on an underdetermined layer keeps the SVD sweep
    if b < in_dim * (max_degree + 1):
        _, _, sq, _, tq = sweeps("qr", x, y, max_degree)
        assert tq._sweep_log[-1]["route"] == "svd"
        np.testing.assert_array_equal(sq, st)


def test_lstsq_methods():
    x, y = data(3, 120, 5)
    X = torch.from_numpy(np.tanh(x))
    Y = torch.from_numpy(y)
    c = t_fk._lstsq(X, Y, "svd", 1e-8).numpy()
    np.testing.assert_allclose(c, np.linalg.lstsq(np.tanh(x), y,
                                                  rcond=None)[0], atol=1e-12)
    want = np.asarray(jax_fk._lstsq(jnp.asarray(np.tanh(x)),
                                    jnp.asarray(y), "normal", 1e-8))
    got = t_fk._lstsq(X, Y, "normal", 1e-8).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-10 * np.abs(want).max())
    with pytest.raises(ValueError, match="lstsq method"):
        t_fk._lstsq(X, Y, "cholesky", 1e-8)


def test_cholesky_failure_falls_back(monkeypatch):
    """A breakdown (info != 0) makes the Gram scores NaN, which sends the
    sweep to QR (rows >= columns) or SVD, as JAX's NaN factor does."""
    real = torch.linalg.cholesky_ex

    def broken(a, **kw):
        L, info = real(a, **kw)
        return L, torch.ones_like(info)

    monkeypatch.setattr(torch.linalg, "cholesky_ex", broken)
    x, y = data(0, 200, 6)
    _, _, s_fb, _, tk = sweeps("normal", x, y, 4)
    assert [e["route"] for e in tk._sweep_log] == ["gram", "qr"]
    monkeypatch.setattr(torch.linalg, "cholesky_ex", real)
    _, _, s_qr, _, _ = sweeps("qr", x, y, 4)
    np.testing.assert_array_equal(s_fb, s_qr)

    monkeypatch.setattr(torch.linalg, "cholesky_ex", broken)
    x, y = data(1, 40, 12)
    _, _, s_fb, _, tk = sweeps("normal", x, y, 4)
    assert [e["route"] for e in tk._sweep_log] == ["gram", "svd"]
    monkeypatch.setattr(torch.linalg, "cholesky_ex", real)
    _, _, s_svd, _, _ = sweeps("svd", x, y, 4)
    np.testing.assert_array_equal(s_fb, s_svd)


def test_float32_routes_big_layers_to_qr():
    """At float32 the ridge is raised to 1e-4, and dp1*in*2.4e-7 above it
    (here 5 * 84 = 420 columns) goes to QR, or to SVD when rows < columns;
    the same layer in float64 keeps the Gram sweep."""
    x, y = data(4, 500, 84)
    cfg = t_fk.FixedKANConfig([84, 2], 4, lstsq_method="normal")
    k = t_fk.FixedKAN(cfg, device="cpu")
    xt = torch.tanh(torch.from_numpy(x))
    yt = torch.from_numpy(y)
    s32, _ = k._evaluate_layer_degrees(xt.float(), yt.float())
    assert k._sweep_log[-1]["route"] == "qr"
    assert k._sweep_log[-1]["devices"] == ["cpu", "cpu"]
    s64, _ = k._evaluate_layer_degrees(xt, yt)
    assert k._sweep_log[-1]["route"] == "gram"
    np.testing.assert_allclose(s32, s64, rtol=1e-3)
    k._evaluate_layer_degrees(xt[:300].float(), yt[:300].float())
    assert k._sweep_log[-1]["route"] == "svd"
    x, y = data(5, 100, 10)
    k._evaluate_layer_degrees(torch.from_numpy(x).float(),
                              torch.from_numpy(y).float())
    assert k._sweep_log[-1]["route"] == "gram"


def test_quantum_sweep_matches_jax():
    x, y = data(6, 12, 2, t_dim=2)
    sj, cj, st, ct, tk = sweeps("svd", x, y, 2, quantum=True,
                                quantum_sample_cap=8)
    np.testing.assert_allclose(st, sj, rtol=1e-8)
    for g, w in zip(ct, cj):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-8 * np.abs(w).max())
    assert len(tk.last_quantum_resources) == 3
    assert tk.last_quantum_resources[0]["rows_encoded"] == 8


def test_complexity_weight_matches_jax():
    for shape in ([4, 3], [4, 3, 2, 2]):
        tk = t_fk.FixedKAN(t_fk.FixedKANConfig(shape, 3, 0.2), device="cpu")
        jk = jax_fk.FixedKAN(jax_fk.FixedKANConfig(shape, 3, 0.2))
        for layer in range(len(shape) - 1):
            for degree in range(4):
                assert tk.calculate_layer_complexity_weight(layer, degree) \
                    == jk.calculate_layer_complexity_weight(layer, degree)


@pytest.mark.parametrize("method,solver", [("normal", "exact"),
                                           ("normal", "anneal"),
                                           ("qr", "exact"),
                                           ("svd", "exact")])
def test_optimize_matches_jax(method, solver):
    x, y = data(7, 240, 6, t_dim=3)
    kw = dict(max_degree=3, complexity_weight=0.001, lstsq_method=method,
              degree_objective="penalized_mse", consistent_tanh=True)
    jk = jax_fk.FixedKAN(jax_fk.FixedKANConfig([6, 5, 4, 3], **kw))
    tk = t_fk.FixedKAN(t_fk.FixedKANConfig([6, 5, 4, 3], **kw), device="cpu")
    run = dict(solver=solver, num_reads=32, num_sweeps=100, seed=0)
    jk.optimize(jnp.asarray(x), jnp.asarray(y), **run)
    tk.optimize(x, y, **run)
    t_dim = 3
    for lj, lt, stats in zip(jk.params, tk.params, tk.last_search_stats):
        np.testing.assert_array_equal(lt["degrees"].numpy(),
                                      np.asarray(lj["degrees"]))
        assert lt["degrees"].tolist() == stats["degrees"]
        cj = np.asarray(lj["coefficients"])
        ct = lt["coefficients"].numpy()
        assert ct.dtype == cj.dtype == np.float64
        scale = np.abs(cj).max()
        bar = 1e-6 if method == "qr" else 1e-8
        np.testing.assert_allclose(ct[:, :, 0].sum(1), cj[:, :, 0].sum(1),
                                   rtol=0, atol=bar * scale)
        np.testing.assert_allclose(ct[:, :, 1:], cj[:, :, 1:], rtol=0,
                                   atol=bar * scale)
        np.testing.assert_allclose(ct, cj, rtol=0,
                                   atol=2.2e-8 * ct.shape[1] * 4 * scale)
        np.testing.assert_array_equal(lt["horizontal_weights"].numpy(),
                                      np.asarray(lj["horizontal_weights"]))
        assert stats["sweeps"][0]["devices"][0] == "cpu"
    x_test, _ = data(8, 50, 6)
    want = np.asarray(jk(jnp.asarray(x_test)))
    got = tk(torch.from_numpy(x_test)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-8 * np.abs(want).max())


def test_optimize_arguments():
    x, y = data(9, 60, 3, t_dim=2)
    tk = t_fk.FixedKAN(t_fk.FixedKANConfig([3, 2], 2), device="cpu")
    # rows that do not divide the mesh axis: the search runs unsharded and
    # says so (tests/test_torch_mesh_train.py runs the sharded search)
    from qkan_implementation_tpu_torch.parallel import make_mesh

    with pytest.warns(UserWarning, match="unsharded"):
        tk.optimize(x, y, solver="exact",
                    mesh=make_mesh(8, devices=["cpu"] * 8))
    with pytest.raises(ValueError, match="solver"):
        tk.optimize(x, y, solver="greedy")
    # integer labels: coefficients in the default float dtype, as numpy's
    # promotion gives the JAX package; a 1-D target becomes [B, 1]
    labels = (x[:, 0] > 0).astype(np.int64)
    jk = jax_fk.FixedKAN(jax_fk.FixedKANConfig([3, 2], 2))
    jk.optimize(jnp.asarray(x), jnp.asarray(labels), solver="exact")
    tk.optimize(x, labels, solver="exact")
    assert tk.params[0]["coefficients"].dtype == torch.float64
    assert tk.params[0]["coefficients"].shape == (2, 3, 3, 1)
    np.testing.assert_allclose(
        tk.params[0]["coefficients"].numpy(),
        np.asarray(jk.params[0]["coefficients"]), rtol=0, atol=1e-6)
    # float32 numpy stays float32; float64 takes the default dtype
    tk.optimize(x.astype(np.float32), y.astype(np.float32), solver="exact")
    assert tk.params[0]["coefficients"].dtype == torch.float32
    tk.optimize(x, y, solver="exact")
    assert tk.params[0]["coefficients"].dtype == torch.float64
