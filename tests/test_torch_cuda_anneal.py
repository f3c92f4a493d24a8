"""The annealers and the degree sweeps of the torch port on the card,
against the same port code on the CPU.  Every test here needs a CUDA card
and skips without one.

This file imports torch and numpy only, so it runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_cuda_anneal.py -q

Bars: the annealers' streams differ between devices (a generator a
device), so they are held to exact answers: the blockwise argmin of the
degree QUBO, and the brute-force ground state within 1e-9 max(1, |E|)
(float64 energy of the best sample).  The delayed sweep on the card gives
the per-variable oracle's chain at every block size (float64, the same
uniforms).  The sweeps in float64: scores within rtol 1e-9 of the CPU's,
the T_0 sums and the other coefficients within 1e-8 max|c| (the split of
a T_0 sum among identical columns is set by the ridge: 10 eps cond max|c|,
cond = ||X_d||_F^2 / (ridge * trace(G)/F)); in
float32 (the card's route, TF32 off): scores within rtol 1e-3 (atol
1e-3 mean(y^2), for the near-interpolating underdetermined fits).
"""

import numpy as np
import pytest
import torch

from qkan_implementation_tpu_torch import anneal
from qkan_implementation_tpu_torch.anneal import sa
from qkan_implementation_tpu_torch.data import load_mnist, to_one_hot
from qkan_implementation_tpu_torch.experiments import run_mnist_experiment
from qkan_implementation_tpu_torch.models import FixedKAN, FixedKANConfig
from qkan_implementation_tpu_torch.ops.chebyshev import chebyshev_basis

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def dense_model(n, seed):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, n))
    J = (a + a.T) / 2
    np.fill_diagonal(J, 0.0)
    return anneal.QuboModel(h=rng.normal(size=n), J=J, offset=0.25)


def brute_force(model):
    n = model.num_variables
    states = ((np.arange(2**n)[:, None] >> np.arange(n)) & 1).astype(float)
    return float(np.min(model.energy(states)))


@pytest.mark.parametrize("objective", ["reference", "penalized_mse"])
@pytest.mark.parametrize("functions", [8, 32])
def test_solve_qubo_on_card_is_blockwise_argmin(cuda, objective, functions):
    scores = np.array([0.09, 0.0277, 0.0196, 0.0168, 0.0161, 0.0159])
    model = anneal.degree_selection_qubo(scores, functions, 0.001,
                                         objective=objective)
    exact = np.zeros(model.num_variables)
    exact[int(np.argmin(model.h[:6]))::6] = 1.0
    got, _ = anneal.solve_qubo(model, 256, 500, seed=0,
                               one_hot_block_size=6, device=cuda)
    np.testing.assert_array_equal(got, exact)
    cpu, _ = anneal.solve_qubo(model, 256, 500, seed=0,
                               one_hot_block_size=6, device="cpu")
    np.testing.assert_array_equal(got, cpu)


@pytest.mark.parametrize("n", [12, 16])
def test_annealers_on_card_reach_ground_state(cuda, n):
    model = dense_model(n, n)
    ground = brute_force(model)
    bar = 1e-9 * max(1.0, abs(ground))
    for samples, _ in (
        anneal.simulated_annealing(model, 128, 500, seed=1, device=cuda),
        anneal.simulated_annealing(model, 128, 500, seed=1, sweep_block=4,
                                   dtype=torch.float64, device=cuda),
        anneal.parallel_tempering(model, 8, 8, 300, seed=1, device=cuda),
        anneal.parallel_tempering(model, 8, 8, 100, seed=1,
                                  kernel="reference", device=cuda),
    ):
        assert abs(float(np.min(model.energy(samples))) - ground) <= bar
    polished = anneal.greedy_descent(model, samples, device=cuda)
    np.testing.assert_array_equal(
        polished, anneal.greedy_descent(model, samples, device="cpu"))


def test_delayed_sweep_on_card_matches_oracle(cuda):
    model = dense_model(24, 3)
    h = torch.as_tensor(model.h, device=cuda)
    J = torch.as_tensor(model.J, device=cuda)
    betas = sa._schedule(anneal.default_beta_range(model), 40, torch.float64)
    ref = sa._anneal_kernel(h, J, betas, sa._generator(7, cuda), 64, 40)
    assert ref[0].is_cuda
    for block in (1, 4, 8):
        got = sa._anneal_kernel_delayed(h, J, betas, sa._generator(7, cuda),
                                        64, 40, block)
        torch.testing.assert_close(got[0], ref[0], rtol=0, atol=0)


def _layer(seed, b, in_dim, dtype, device):
    rng = np.random.default_rng(seed)
    x = torch.tanh(torch.as_tensor(rng.uniform(-2, 2, (b, in_dim)),
                                   dtype=dtype, device=device))
    y = torch.as_tensor(rng.normal(size=(b, 3)), dtype=dtype, device=device)
    return x, y


@pytest.mark.parametrize("method,b,in_dim", [
    ("normal", 300, 6), ("qr", 300, 6), ("svd", 300, 6), ("svd", 40, 12),
    ("normal", 600, 64),
])
def test_sweeps_on_card_match_cpu_float64(cuda, method, b, in_dim):
    cfg = FixedKANConfig([in_dim, 4], 3, lstsq_method=method)
    card, cpu = FixedKAN(cfg, device=cuda), FixedKAN(cfg, device="cpu")
    x, y = _layer(b, b, in_dim, torch.float64, cuda)
    s_card, c_card = card._evaluate_layer_degrees(x, y)
    s_cpu, c_cpu = cpu._evaluate_layer_degrees(x.cpu(), y.cpu())
    X = chebyshev_basis(x.cpu(), 3, clip=False)
    assert card._sweep_log[-1]["route"] == cpu._sweep_log[-1]["route"]
    assert all(d.startswith("cuda") for d in card._sweep_log[-1]["devices"])
    np.testing.assert_allclose(s_card, s_cpu, rtol=1e-9,
                               atol=1e-12 * float(y.pow(2).mean()))
    for d, (g, w) in enumerate(zip(c_card, c_cpu)):
        assert g.is_cuda
        g = g.cpu().numpy().reshape(in_dim, d + 1, 3)
        w = w.numpy().reshape(in_dim, d + 1, 3)
        scale = np.abs(w).max()
        np.testing.assert_allclose(g[:, 0].sum(0), w[:, 0].sum(0), rtol=0,
                                   atol=1e-8 * scale)
        np.testing.assert_allclose(g[:, 1:], w[:, 1:], rtol=0,
                                   atol=1e-8 * scale)
        # the split of a T_0 sum among identical columns: 10 eps cond
        cond = float(X[:, :, : d + 1].pow(2).sum()
                     / (1e-8 * X.pow(2).sum() / X[0].numel()))
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=10 * 2.22e-16 * cond * scale)


@pytest.mark.parametrize("b,in_dim", [(500, 84), (300, 84), (200, 10)])
def test_float32_sweep_routes_on_card(cuda, b, in_dim):
    """float32: ridge 1e-4, a big layer to QR (or SVD when rows <
    columns), the rest Gram; the card's scores within 1e-3 of the CPU's
    float32 run on the same inputs."""
    cfg = FixedKANConfig([in_dim, 2], 4, lstsq_method="normal")
    card, cpu = FixedKAN(cfg, device=cuda), FixedKAN(cfg, device="cpu")
    x, y = _layer(in_dim, b, in_dim, torch.float32, cuda)
    s_card, _ = card._evaluate_layer_degrees(x, y)
    s_cpu, _ = cpu._evaluate_layer_degrees(x.cpu(), y.cpu())
    route = card._sweep_log[-1]["route"]
    assert route == cpu._sweep_log[-1]["route"]
    assert route == {500: "qr", 300: "svd", 200: "gram"}[b]
    np.testing.assert_allclose(s_card, s_cpu, rtol=1e-3,
                               atol=1e-3 * float(y.pow(2).mean()))


def test_optimize_and_experiment_on_card(cuda):
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        x, labels, _ = load_mnist(train=True)
        x, y = x[:600], to_one_hot(labels[:600])
        cfg = FixedKANConfig.preset("recommended", [64, 8, 10], 3,
                                    complexity_weight=0.001)
        card, cpu = FixedKAN(cfg, device=cuda), FixedKAN(cfg, device="cpu")
        card.optimize(x, y, num_reads=128, num_sweeps=300)
        cpu.optimize(x, y, solver="exact")
        for lc, lp in zip(card.params, cpu.params):
            assert lc["coefficients"].is_cuda
            np.testing.assert_array_equal(lc["degrees"].cpu().numpy(),
                                          lp["degrees"].numpy())
        with torch.no_grad():
            got = card(torch.as_tensor(x[:64])).cpu().numpy()
            want = cpu(torch.as_tensor(x[:64])).numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-8 * np.abs(want).max())
        kw = dict(network_shape=[64, 8, 10], max_degree=3, train_size=600,
                  solver="exact", degree_objective="penalized_mse",
                  complexity_weight=0.001, consistent_tanh=True,
                  weight_epochs=1, verbose=False)
        on_card = run_mnist_experiment(device=cuda, **kw)
        on_cpu = run_mnist_experiment(device="cpu", **kw)
        assert on_card["_model"].device.type == "cuda"
        assert on_card["metrics"]["test_accuracy"] > 0.5
        assert on_card["metrics"]["test_accuracy"] == \
            on_cpu["metrics"]["test_accuracy"]
    finally:
        torch.set_default_dtype(old)
