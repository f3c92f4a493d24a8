"""The plain reference agrees with the program on the CPU at small sizes,
in float64."""

import numpy as np
import torch

from perfbench import counts, data
from perfbench.reference import kan as ref
from perfbench.reference import market as mref

SHAPE = [784, 32, 16, 16, 10]


def _params64(seed, shape=SHAPE):
    dims = counts.fixed_kan_dims(shape, 10)
    return [{k: (v.double() if v.is_floating_point() else v)
             for k, v in lp.items()}
            for lp in data.kan_params(dims, shape[1:], 5, seed, "cpu")]


def test_forward_matches_the_program():
    from qkan_implementation_tpu_torch.models.fixed_kan import kan_apply

    params = _params64(1)
    x = torch.from_numpy(data.digits_784(300, 1)[0]).double()
    got = kan_apply(params, x, 5, matmul_precision="highest")
    want = ref.forward(params, x, 5)
    assert torch.allclose(got, want, rtol=1e-12, atol=1e-12)


def test_three_adam_steps_match_the_program():
    from qkan_implementation_tpu_torch.models.fixed_kan import (
        FixedKAN, FixedKANConfig,
    )

    params = _params64(2)
    xn, labels = data.digits_784(192, 2)
    x, y = torch.from_numpy(xn).double(), torch.from_numpy(labels)
    kan = FixedKAN(FixedKANConfig.preset("recommended", SHAPE, 5),
                   device="cpu")
    kan.params = [{k: v.clone() for k, v in lp.items()} for lp in params]
    kan.train(x, y, epochs=1, batch_size=64, learning_rate=0.002,
              trainable="all", grad_clip=1.0, lr_scale="fanin",
              lr_schedule="cosine", seed=9, backend="xla")
    rows = np.random.default_rng(9).permutation(192).reshape(3, 64)
    out = ref.train_steps(params, x, y, [torch.from_numpy(r) for r in rows],
                          5, 0.002, 1.0, decay_steps=3)
    for got, want in zip(kan.params, out["params"]):
        for k in ("coefficients", "horizontal_weights"):
            assert torch.allclose(got[k], want[k], rtol=1e-9, atol=1e-12)


def test_degree_sweep_matches_the_program():
    from qkan_implementation_tpu_torch.models.fixed_kan import (
        FixedKAN, FixedKANConfig,
    )

    xn, labels = data.digits_784(400, 4)
    x = torch.tanh(torch.from_numpy(xn[:, 300:316]).double())
    y = torch.nn.functional.one_hot(torch.from_numpy(labels), 10).double()
    kan = FixedKAN(FixedKANConfig.preset("recommended", [16, 4], 5),
                   device="cpu")
    scores, coeffs = kan._evaluate_layer_degrees(x, y)
    assert kan._sweep_log[-1]["route"] == "gram"
    want, want_c = ref.layer_sweep(x, y, 5, 1e-8, apply_tanh=False)
    assert np.allclose(scores, want, rtol=1e-8)
    # the design is rank deficient (every feature's T_0 is the same
    # column): the fits agree, not the coefficients along the null space
    basis = ref.chebyshev(x, 5)
    for d, (c, w) in enumerate(zip(coeffs, want_c)):
        X = basis[:, :, : d + 1].reshape(400, -1)
        got, fit = X @ c, X @ w.reshape(-1, 10)
        assert torch.linalg.vector_norm(got - fit) <= (
            1e-7 * torch.linalg.vector_norm(fit))


def test_market_scores_and_layer_match_the_program():
    from qkan_implementation_tpu_torch.optim.degree_optimizer import (
        DegreeOptimizer,
    )

    tr, tt, tw, va, _, _ = data.market_arrays(
        data.market_columns(8000, 79, 40, 6, 0.1), 79, 0.8)
    opt = DegreeOptimizer([79, 1], 3, device="cpu")
    scores, _ = opt.evaluate_degree(tr, tt, weights=tw, method="gram")
    t = [torch.from_numpy(a) for a in (tr, tt, tw, va)]
    want = mref.degree_scores(t[0], t[1], t[2], 3)
    assert np.allclose(scores, want, rtol=1e-9)
    degrees = np.random.default_rng(1).integers(0, 4, (1, 79))
    opt.feature_means = tr.mean(axis=0)
    opt.feature_stds = tr.std(axis=0) + 1e-8
    opt.qkan_weights = opt._one_hot_weights(degrees.tolist(), 79, 1, 3)
    got = opt.predict(va)
    mean, std = t[0].mean(dim=0), t[0].std(dim=0, unbiased=False) + 1e-8
    assert np.allclose(got, mref.layer(t[3], degrees, 3, mean, std).numpy(),
                       rtol=1e-12, atol=1e-14)


def test_market_selection_matches_the_programs_qubo():
    from qkan_implementation_tpu_torch.anneal import degree_selection_qubo

    for scores in ([0.2545, 0.2477, 0.2455, 0.2449], [0.5, 0.2, 0.1, 0.05]):
        best = int(np.argmin(scores))
        rel = [(s - scores[best]) / (s + 1e-10) for s in scores]
        definitive = all(r >= 0.05 for i, r in enumerate(rel) if i != best)
        model = degree_selection_qubo(
            np.array(scores), 1, 0.1,
            definitive_degree=best if definitive else None)
        lin = model.h + 10.0  # h = lin - P in each one-hot block
        assert np.allclose(lin, mref.degree_objective(scores, 0.1, 0.05))
