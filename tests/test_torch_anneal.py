"""anneal/ and native_bindings of the torch port against the JAX package,
on the CPU with the same numpy inputs.

Bars:
- the numpy copies (``degree_selection_qubo``, ``expr``'s compiled
  QUBOs, the beta heuristics, ``polish_one_hot_blocks``): equal, bit for
  bit;
- ``greedy_descent``: both sides descend in float32 from the same
  samples and pick the first steepest flip: the same samples;
- the native binding: both packages build the same C++ source with the
  same flags, so samples, energies and minima are equal;
- the annealers: the random streams differ (a ``torch.Generator`` here,
  JAX's keys there), so they are held to energies: the brute-force
  ground state within 1e-9 max(1, |E|), recomputed in float64 from the
  best sample.  The delayed sweep is a schedule of the per-variable
  sweep: at float64 on the same uniforms every block size gives the
  oracle's chain, sample for sample.
"""

import shutil

import numpy as np
import pytest
import torch

from qkan_implementation_tpu import anneal as jax_anneal
from qkan_implementation_tpu.anneal import expr as jax_expr
from qkan_implementation_tpu_torch import anneal as t_anneal
from qkan_implementation_tpu_torch.anneal import expr as t_expr
from qkan_implementation_tpu_torch.anneal import sa as t_sa

CPU = torch.device("cpu")


def dense_model(module, n, seed, offset=0.25):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, n))
    J = (a + a.T) / 2
    np.fill_diagonal(J, 0.0)
    return module.QuboModel(h=rng.normal(size=n), J=J, offset=offset)


def ground_energy(model, samples):
    """float64 energy of the best sample."""
    return float(np.min(model.energy(samples)))


def brute_force(model):
    n = model.num_variables
    states = ((np.arange(2**n)[:, None] >> np.arange(n)) & 1).astype(float)
    return float(np.min(model.energy(states)))


SCORES = [
    np.array([0.3, 0.2, 0.15, 0.14, 0.139, 0.1385]),
    np.array([0.09, 0.0277, 0.0196, 0.0168]),
    np.array([1.0, 1.0, 0.5]),
    np.array([0.05]),
]


@pytest.mark.parametrize("objective", ["reference", "penalized_mse"])
@pytest.mark.parametrize("k", range(len(SCORES)))
def test_degree_qubo_equals_jax(objective, k):
    for num_functions, cw in ((1, 0.1), (7, 0.001)):
        got = t_anneal.degree_selection_qubo(
            SCORES[k], num_functions, cw, objective=objective
        )
        want = jax_anneal.degree_selection_qubo(
            SCORES[k], num_functions, cw, objective=objective
        )
        np.testing.assert_array_equal(got.h, want.h)
        np.testing.assert_array_equal(got.J, want.J)
        assert got.offset == want.offset
    got = t_anneal.degree_selection_qubo(SCORES[0], 3, definitive_degree=2)
    want = jax_anneal.degree_selection_qubo(SCORES[0], 3, definitive_degree=2)
    np.testing.assert_array_equal(got.h, want.h)
    with pytest.raises(ValueError, match="objective"):
        t_anneal.degree_selection_qubo(SCORES[0], 2, objective="nope")
    sample = np.zeros(12)
    sample[[1, 4, 9]] = 1.0
    assert t_anneal.decode_degrees(sample, 2, 2, 2) == \
        jax_anneal.decode_degrees(sample, 2, 2, 2)


def _build(module):
    q = module.Array.create("q", (3, 3))
    H = 0.0
    for i in range(3):
        row = sum(q[i, d] for d in range(3))
        H = H + module.Constraint(10.0 * (row - 1) ** 2, f"one_hot_{i}")
        H = H + 0.3 * q[i, 1] - 1.5 * q[i, 2] + q[i, 0] * q[(i + 1) % 3, 2]
    return H.compile()


def test_compiled_expr_equals_jax():
    got, want = _build(t_expr), _build(jax_expr)
    assert got.variables == want.variables
    for a, b in zip((got.model.h, got.model.J), (want.model.h, want.model.J)):
        np.testing.assert_array_equal(a, b)
    assert got.model.offset == want.model.offset
    rng = np.random.default_rng(0)
    for s in rng.integers(0, 2, (5, 9)).astype(float):
        a, b = got.decode_sample(s), want.decode_sample(s)
        assert (a.sample, a.energy, a.broken_constraints) == (
            b.sample, b.energy, b.broken_constraints)
    with pytest.raises(ValueError, match="degree 3"):
        (t_expr.Binary("a") * t_expr.Binary("b") * t_expr.Binary("c")).compile()
    best = got.solve(num_reads=16, num_sweeps=100, seed=0, device="cpu")
    assert not best.broken_constraints


@pytest.mark.parametrize("seed", [0, 1])
def test_beta_ranges_equal_jax(seed):
    tm, jm = dense_model(t_anneal, 10, seed), dense_model(jax_anneal, 10, seed)
    assert t_anneal.default_beta_range(tm) == jax_anneal.default_beta_range(jm)
    assert t_anneal.default_tempering_beta_range(tm) == \
        jax_anneal.default_tempering_beta_range(jm)
    tq = t_anneal.degree_selection_qubo(SCORES[0], 4, 0.001,
                                        objective="penalized_mse")
    jq = jax_anneal.degree_selection_qubo(SCORES[0], 4, 0.001,
                                          objective="penalized_mse")
    assert t_anneal.default_beta_range(tq) == jax_anneal.default_beta_range(jq)


def test_polish_and_greedy_equal_jax():
    rng = np.random.default_rng(3)
    samples = rng.integers(0, 2, (32, 24)).astype(float)
    tq = t_anneal.degree_selection_qubo(SCORES[0], 4, 0.01,
                                        objective="penalized_mse")
    jq = jax_anneal.degree_selection_qubo(SCORES[0], 4, 0.01,
                                          objective="penalized_mse")
    np.testing.assert_array_equal(
        t_anneal.polish_one_hot_blocks(tq, samples, 6),
        jax_anneal.polish_one_hot_blocks(jq, samples, 6),
    )
    with pytest.raises(ValueError, match="divide"):
        t_anneal.polish_one_hot_blocks(tq, samples, 5)
    tm, jm = dense_model(t_anneal, 24, 5), dense_model(jax_anneal, 24, 5)
    got = t_anneal.greedy_descent(tm, samples, device="cpu")
    np.testing.assert_array_equal(got, jax_anneal.greedy_descent(jm, samples))
    # a local optimum: no single flip lowers the energy
    e = tm.energy(got)
    for i in range(24):
        flipped = got.copy()
        flipped[:, i] = 1 - flipped[:, i]
        assert np.all(tm.energy(flipped) >= e - 1e-9)


@pytest.fixture
def native_pair(monkeypatch, tmp_path):
    """Both bindings; the JAX one builds its library under tmp_path, so
    this test never writes native/ while another worker's test reads it."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build native/qkan_native.cpp")
    from qkan_implementation_tpu import native_bindings as jax_nb
    from qkan_implementation_tpu_torch import native_bindings as t_nb

    monkeypatch.setattr(jax_nb, "_LIB_PATH", tmp_path / "libqkan_native.so")
    monkeypatch.setattr(jax_nb, "_lib", None)
    return jax_nb, t_nb


def test_native_binding_equals_jax(native_pair):
    jax_nb, t_nb = native_pair
    assert t_nb.native_available()
    assert "qkan_implementation_tpu_torch" in str(t_nb._LIB_PATH)
    for n, seed in ((12, 0), (16, 1)):
        tm, jm = dense_model(t_anneal, n, seed), dense_model(jax_anneal, n,
                                                               seed)
        s_t, e_t = t_nb.anneal_native(tm, 32, 200, seed=seed)
        s_j, e_j = jax_nb.anneal_native(jm, 32, 200, seed=seed)
        np.testing.assert_array_equal(s_t, s_j)
        np.testing.assert_array_equal(e_t, e_j)
        g_t, g_j = t_nb.brute_force_native(tm), jax_nb.brute_force_native(jm)
        np.testing.assert_array_equal(g_t[0], g_j[0])
        assert g_t[1] == g_j[1]
        assert abs(g_t[1] - brute_force(tm)) <= 1e-9 * max(1, abs(g_t[1]))
        np.testing.assert_array_equal(t_nb.energies_native(tm, s_t),
                                      jax_nb.energies_native(jm, s_t))
        # the SA front end's 'native' backend is the same call
        s_b, e_b = t_anneal.simulated_annealing(tm, 32, 200, seed=seed,
                                                backend="native")
        np.testing.assert_array_equal(s_b, s_t)
    with pytest.raises(ValueError, match="positive"):
        t_nb.anneal_native(tm, 2, 2, beta_range=(0.0, 1.0))


@pytest.mark.parametrize("n", [16, 24])
def test_delayed_sweep_is_block_size_invariant(n):
    """At float64 on the same uniforms, every sweep block gives the chain
    of the per-variable sweep (the JAX package's test of its delayed
    kernel, held here to the oracle itself)."""
    model = dense_model(t_anneal, n, n)
    h = torch.as_tensor(model.h)
    J = torch.as_tensor(model.J)
    betas = t_sa._schedule(t_anneal.default_beta_range(model), 40,
                           torch.float64)
    ref = t_sa._anneal_kernel(h, J, betas, t_sa._generator(7, CPU), 16, 40)
    for block in (1, 4, 8):
        got = t_sa._anneal_kernel_delayed(
            h, J, betas, t_sa._generator(7, CPU), 16, 40, block
        )
        torch.testing.assert_close(got[0], ref[0], rtol=0, atol=0)
        torch.testing.assert_close(got[1], ref[1], rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError, match="multiple"):
        t_sa._anneal_kernel_delayed(h, J, betas, t_sa._generator(7, CPU),
                                    4, 2, 5)


@pytest.mark.parametrize("n", [12, 16])
def test_annealers_reach_ground_state(n):
    model = dense_model(t_anneal, n, 10 + n)
    ground = brute_force(model)
    bar = 1e-9 * max(1.0, abs(ground))
    runs = {
        "sa_delayed": t_anneal.simulated_annealing(
            model, 64, 200, seed=1, device="cpu"),
        "sa_delayed_f64_block4": t_anneal.simulated_annealing(
            model, 64, 200, seed=2, dtype=torch.float64, sweep_block=4,
            device="cpu"),
        "pt_delayed": t_anneal.parallel_tempering(
            model, num_chains=8, num_replicas=8, num_sweeps=200, seed=1,
            device="cpu"),
        "pt_reference": t_anneal.parallel_tempering(
            model, num_chains=8, num_replicas=8, num_sweeps=100, seed=1,
            kernel="reference", device="cpu"),
    }
    for name, (samples, energies) in runs.items():
        assert abs(ground_energy(model, samples) - ground) <= bar, name
        # the kernels' own energies (offset included) match the samples
        np.testing.assert_allclose(energies, model.energy(samples),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    # the block-diagonal kernel on a block-diagonal dense QUBO
    blocks = [dense_model(t_anneal, 4, s) for s in range(4)]
    J = np.zeros((16, 16))
    for b, m in enumerate(blocks):
        J[4 * b:4 * b + 4, 4 * b:4 * b + 4] = m.J
    bd = t_anneal.QuboModel(np.concatenate([m.h for m in blocks]), J, 0.0)
    samples, _ = t_anneal.simulated_annealing(
        bd, 32, 200, seed=0, block_structure=4, device="cpu")
    assert abs(ground_energy(bd, samples) - brute_force(bd)) <= 1e-9 * max(
        1.0, abs(brute_force(bd)))


def test_block_structure_falls_back_when_not_block_diagonal():
    model = dense_model(t_anneal, 8, 0)
    samples, energies = t_anneal.simulated_annealing(
        model, 8, 50, seed=0, block_structure=4, device="cpu")
    assert samples.shape == (8, 8)
    assert t_sa._block_diagonal_J(model, 4) is None


@pytest.mark.parametrize("objective", ["reference", "penalized_mse"])
def test_solve_qubo_degree_sample_equals_jax(objective):
    scores = np.array([0.09, 0.0277, 0.0196, 0.0168, 0.0161, 0.0159])
    tq = t_anneal.degree_selection_qubo(scores, 8, 0.001, objective=objective)
    jq = jax_anneal.degree_selection_qubo(scores, 8, 0.001,
                                          objective=objective)
    got, e_got = t_anneal.solve_qubo(tq, num_reads=64, num_sweeps=200,
                                     seed=0, one_hot_block_size=6,
                                     device="cpu")
    want, e_want = jax_anneal.solve_qubo(jq, num_reads=64, num_sweeps=200,
                                         seed=0, one_hot_block_size=6)
    np.testing.assert_array_equal(got, want)
    assert e_got == e_want
    # the blockwise argmin that optimize(solver='exact') takes
    exact = np.zeros(48)
    exact[int(np.argmin(tq.h[:6]))::6] = 1.0
    np.testing.assert_array_equal(got, exact)


def test_unported_and_invalid_arguments_raise():
    model = dense_model(t_anneal, 8, 0)
    with pytest.raises(ValueError, match="backend"):
        t_anneal.simulated_annealing(model, 2, 2, backend="jax",
                                     device="cpu")
    with pytest.raises(ValueError, match="kernel"):
        t_anneal.parallel_tempering(model, 2, 2, 2, kernel="fast",
                                    device="cpu")
    for bad in (0, -1, 2.5):
        with pytest.raises(ValueError, match="sweep_block"):
            t_anneal.simulated_annealing(model, 2, 2, sweep_block=bad,
                                         device="cpu")
    # the mesh samplers (tests/test_torch_mesh_train.py runs them) name
    # the axis their chains split over
    from qkan_implementation_tpu_torch.parallel import make_mesh

    mesh = make_mesh(2, axis_name="x", devices=["cpu"] * 2)
    for fn in (t_anneal.simulated_annealing_sharded,
               t_anneal.parallel_tempering_sharded,
               t_anneal.parallel_tempering_mesh_ladder):
        with pytest.raises(ValueError, match="not in mesh axes"):
            fn(model, mesh)
    assert set(t_anneal.__all__) == set(jax_anneal.__all__)
