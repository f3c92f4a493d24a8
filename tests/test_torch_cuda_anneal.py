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
1e-3 mean(y^2), for the near-interpolating underdetermined fits).  The
polish on the card (S2) against the host route on the same state: the
polished reads and the best sample bit for bit, its energy within 1e-15
of the exact sum and 1e-12 of numpy's, relative to the larger of |E| and
the offset (``assert_energy``).
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
from polish_cases import (
    CELL_SHAPES,
    assert_energy,
    host_polish_route,
    polish_case,
)

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


def _blocked_state(bs, nb, reads, k, seed, dtype, device):
    """A block-diagonal anneal's (s, f, u, betas, J_blocks) on ``device``:
    state and couplings from numpy, fields h + J s, the uniforms from the
    card's generator (torch.rand, as the anneal draws them), a geometric
    schedule rounded to ``dtype`` that both accepts and rejects."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(nb, bs, bs))
    J = (a + a.transpose(0, 2, 1)) / 2
    J[:, np.arange(bs), np.arange(bs)] = 0.0
    h = rng.normal(size=(nb, bs))
    s = (rng.uniform(size=(bs, reads, nb)) < 0.5).astype(float)
    f = h.T[:, None, :] + np.einsum("bij,jrb->irb", J, s)
    s, f, J = (torch.as_tensor(v, dtype=dtype, device=device).contiguous()
               for v in (s, f, J))
    gen = sa._generator(seed, device)
    u = torch.rand((k, bs, reads, nb), generator=gen, dtype=dtype,
                   device=device)
    betas = torch.tensor(sa._schedule((0.05, 20.0), k, dtype), dtype=dtype,
                         device=device)
    return s, f, u, betas, J


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("reads", [1, 33, 1000])
@pytest.mark.parametrize("nb", [10, 79])
@pytest.mark.parametrize("bs", [1, 2, 4, 6, 8, 9, 17])
def test_blocked_kernel_equals_plain_on_card(cuda, bs, nb, reads, dtype):
    """The kernel against the plain sweeps on the card, on the same state,
    uniforms, schedule and couplings: states and fields bit for bit, and
    one launch for the chunk."""
    k = 9
    s, f, u, betas, J = _blocked_state(bs, nb, reads, k, bs * nb + reads,
                                       dtype, cuda)
    s0 = s.clone()
    s_ref, f_ref = s.clone(), f.clone()
    sa._blocked_sweeps(s_ref, f_ref, u, betas, J)
    launches = sa.blocked_sweeps.launches
    swept = sa.simulated_annealing.kernel_sweeps
    sa.blocked_sweeps(s, f, u, betas, J)
    torch.cuda.synchronize()
    assert sa.blocked_sweeps.launches - launches == 1
    assert sa.simulated_annealing.kernel_sweeps - swept == k
    assert torch.equal(s, s_ref)
    assert torch.equal(f, f_ref)
    if reads * nb >= 1000:
        # the chunk did flip spins both ways
        moved = int((s != s0).sum())
        assert 0 < moved < s.numel()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_blocked_anneal_short_last_chunk_on_card(cuda, dtype, monkeypatch):
    """A whole anneal in chunks of 4 sweeps (the chunk rule cut to 4), the
    last chunk short: the kernel's samples and energies equal the plain
    sweeps' on the card's same uniforms, with one launch a chunk."""
    bs, nb, reads, sweeps = 6, 32, 100, 10
    monkeypatch.setattr(sa, "_CHUNK_BYTES",
                        4 * bs * nb * reads * dtype.itemsize)
    assert sa._sweep_chunk((bs, reads, nb), dtype, sweeps) == 4
    rng = np.random.default_rng(5)
    a = rng.normal(size=(nb, bs, bs))
    J = torch.as_tensor((a + a.transpose(0, 2, 1)) / 2, dtype=dtype,
                        device=cuda)
    J[:, torch.arange(bs), torch.arange(bs)] = 0.0
    h = torch.as_tensor(rng.normal(size=(nb, bs)), dtype=dtype, device=cuda)
    betas = sa._schedule((0.05, 20.0), sweeps, dtype)
    launches = sa.blocked_sweeps.launches
    got = sa._anneal_kernel_blocked(h, J, betas, sa._generator(3, cuda),
                                    reads, sweeps)
    assert sa.blocked_sweeps.launches - launches == 3  # 4 + 4 + 2
    monkeypatch.setattr(sa, "blocked_sweeps", sa._blocked_sweeps)
    want = sa._anneal_kernel_blocked(h, J, betas, sa._generator(3, cuda),
                                     reads, sweeps)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])


def _block_diagonal_model(bs, nb, seed):
    rng = np.random.default_rng(seed)
    J = np.zeros((nb * bs, nb * bs))
    for b in range(nb):
        a = rng.normal(size=(bs, bs))
        blk = (a + a.T) / 2
        np.fill_diagonal(blk, 0.0)
        J[b * bs:(b + 1) * bs, b * bs:(b + 1) * bs] = blk
    return anneal.QuboModel(h=rng.normal(size=nb * bs), J=J, offset=0.25)


@pytest.mark.parametrize("bs,nb", [(4, 79), (6, 32), (17, 10)])
def test_blocked_anneal_energies_on_card(cuda, bs, nb):
    """simulated_annealing(block_structure=) on the card: its energies are
    the samples' (offset included), within 1e-5; every sweep ran in the
    kernel."""
    model = _block_diagonal_model(bs, nb, bs)
    swept = sa.simulated_annealing.kernel_sweeps
    samples, energies = anneal.simulated_annealing(
        model, 256, 300, seed=2, block_structure=bs, device=cuda)
    assert sa.simulated_annealing.kernel_sweeps - swept == 300
    np.testing.assert_allclose(energies, model.energy(samples), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("functions,scores", [
    (32, [0.09, 0.0277, 0.0196, 0.0168, 0.0161, 0.0159]),  # digits, bs 6
    (79, [0.09, 0.0277, 0.0196, 0.0168]),  # market, bs 4
])
def test_solve_qubo_on_card_at_the_cells_shapes(cuda, functions, scores):
    """solve_qubo at the search cells' shapes (1000 reads, 1000 sweeps)
    gives the blockwise argmin, its sweeps all in the kernel."""
    scores = np.array(scores)
    bs = scores.size
    model = anneal.degree_selection_qubo(scores, functions, 0.001,
                                         objective="penalized_mse")
    exact = np.zeros(model.num_variables)
    exact[int(np.argmin(model.h[:bs]))::bs] = 1.0
    launches = sa.blocked_sweeps.launches
    got, _ = anneal.solve_qubo(model, 1000, 1000, seed=11,
                               one_hot_block_size=bs, device=cuda)
    np.testing.assert_array_equal(got, exact)
    per = sa._sweep_chunk((bs, 1000, functions), torch.float32, 1000)
    assert sa.blocked_sweeps.launches - launches == -(-1000 // per)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("bs,nb,reads,degree_qubo", [
    *[(bs, nb, 1000, True) for bs, nb in CELL_SHAPES],
    *[(bs, nb, reads, False) for bs in range(1, 9)
      for nb, reads in ((3, 1), (33, 37), (79, 1000))],
])
def test_polish_on_card_equals_host_route(cuda, bs, nb, reads, degree_qubo,
                                          dtype):
    """S2 against the host route on the same annealed state: every read
    polished to the host loop's bits, the same best sample bit for bit,
    its energy as ``assert_energy`` bars it, one card call a call."""
    model, s = polish_case(bs, nb, reads, 7 * bs + nb + reads, degree_qubo,
                           dtype, cuda)
    polished, want, e_want = host_polish_route(model, s, bs)
    terms = sa._blocked_terms(model, sa._block_diagonal_J(model, bs),
                              torch.float64, cuda)
    calls = sa.polish_one_hot_blocks.card_calls
    best = sa.polish_blocked(s, *terms)
    torch.cuda.synchronize()
    assert sa.polish_one_hot_blocks.card_calls - calls == 1
    assert best.is_cuda and best.dtype == torch.float64
    best = best.cpu().numpy()
    np.testing.assert_array_equal(best[:-1], want)
    assert_energy(model, want, float(best[-1]) + model.offset, e_want)
    np.testing.assert_array_equal(
        s.permute(1, 2, 0).reshape(reads, -1).cpu().numpy(), polished)
    # the plain version on the card gives the same sample
    _, s2 = polish_case(bs, nb, reads, 7 * bs + nb + reads, degree_qubo,
                        dtype, cuda)
    plain = sa._polish_blocked(s2, *terms).cpu().numpy()
    np.testing.assert_array_equal(plain[:-1], want)


def test_polish_on_card_checks_its_arguments(cuda):
    model, s = polish_case(4, 5, 8, 0, True, torch.float32, cuda)
    h, J = sa._blocked_terms(model, sa._block_diagonal_J(model, 4),
                             torch.float64, cuda)
    with pytest.raises(ValueError, match="h must be contiguous float64"):
        sa.polish_blocked(s, h.float(), J)
    with pytest.raises(ValueError, match="J_blocks must be"):
        sa.polish_blocked(s, h, J[:, :3])
    with pytest.raises(ValueError, match="state must be"):
        sa.polish_blocked(s.half(), h, J)


@pytest.mark.parametrize("bs,nb,degree_qubo", [
    *[(bs, nb, True) for bs, nb in CELL_SHAPES], (5, 12, False),
])
def test_solve_qubo_polishes_on_card(cuda, bs, nb, degree_qubo):
    """solve_qubo on a block-diagonal QUBO on the card polishes there, one
    card call a call, and returns the host route's sample and energy on
    the same anneal (``simulated_annealing`` on the card, same seed)."""
    model, _ = polish_case(bs, nb, 1, bs + nb, degree_qubo, torch.float32,
                           cuda)
    calls = sa.polish_one_hot_blocks.card_calls
    got, e_got = anneal.solve_qubo(model, 1000, 300, seed=11,
                                   one_hot_block_size=bs, device=cuda)
    assert sa.polish_one_hot_blocks.card_calls - calls == 1
    samples, _ = anneal.simulated_annealing(model, 1000, 300, seed=11,
                                            block_structure=bs, device=cuda)
    polished = anneal.polish_one_hot_blocks(model, samples, bs)
    energies = model.energy(polished)
    best = int(np.argmin(energies))
    np.testing.assert_array_equal(got, polished[best])
    assert_energy(model, got, e_got, energies[best])


def test_solve_qubo_dense_on_card_keeps_the_host_polish(cuda):
    """Couplings across blocks: solve_qubo keeps the host polish (no card
    call) and its result is the host route's, energy and all."""
    model = dense_model(12, 5)
    assert sa._block_diagonal_J(model, 4) is None
    calls = sa.polish_one_hot_blocks.card_calls
    got, e_got = anneal.solve_qubo(model, 64, 200, seed=3,
                                   one_hot_block_size=4, device=cuda)
    assert sa.polish_one_hot_blocks.card_calls == calls
    samples, _ = anneal.simulated_annealing(model, 64, 200, seed=3,
                                            block_structure=4, device=cuda)
    polished = anneal.polish_one_hot_blocks(model, samples, 4)
    energies = model.energy(polished)
    best = int(np.argmin(energies))
    np.testing.assert_array_equal(got, polished[best])
    assert e_got == energies[best]
