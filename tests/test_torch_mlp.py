"""The MLP baseline of the torch port against the JAX package, on the CPU
in float64 (torch's default dtype set to it, the JAX side x64).

Both packages start from the same parameters: JAX's ``init_mlp`` carried
across with ``utils.convert.mlp_from_numpy`` (the port cannot draw
``jax.random``'s numbers), and see the same batches (one
``np.random.default_rng(seed)`` stream).  Bars: the per-epoch validation
MSE and comp-R^2 traces, the final parameters and the running batch-norm
statistics within 1e-9 (relative to each array's max; the two sides
differ by summation orders only, measured <= 4e-16 over 3 epochs), and
the plateau halvings and the early stop at the same epochs.
"""

import jax
import numpy as np
import pytest
import torch

from qkan_implementation_tpu.models import mlp as jax_mlp
from qkan_implementation_tpu_torch.models import mlp as t_mlp
from qkan_implementation_tpu_torch.utils.convert import (
    mlp_from_numpy,
    mlp_to_numpy,
)

RTOL = 1e-9


@pytest.fixture(autouse=True)
def x64():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


def data(n=256, n_val=64, f=4, seed=0, noise_val=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f))
    y = (np.tanh(x[:, 0]) + 0.3 * x[:, 1] ** 2
         + 0.1 * rng.normal(size=n)).reshape(-1, 1)
    xv = rng.normal(size=(n_val, f))
    yv = (np.tanh(xv[:, 0]) + 0.3 * xv[:, 1] ** 2).reshape(-1, 1)
    if noise_val:
        yv = rng.normal(size=(n_val, 1))
    return x, y, rng.uniform(0.5, 2.0, n), xv, yv, rng.uniform(0.5, 2, n_val)


def carried_start(cfg, seed):
    """JAX's initial (params, bn_state) as numpy, and the port's model
    holding the same numbers."""
    jcfg = jax_mlp.MLPConfig(cfg.input_dim, cfg.hidden_dims, cfg.output_dim)
    p, s = jax_mlp.init_mlp(jcfg, seed=seed, dtype=np.float64)
    p, s = jax.tree.map(np.asarray, p), jax.tree.map(np.asarray, s)
    return mlp_from_numpy(p, s, cfg, "cpu")


def configs(**kw):
    args = dict(input_dim=4, hidden_dims=[8], learning_rate=1e-2,
                batch_size=32, n_epochs=3)
    args.update(kw)
    return jax_mlp.MLPConfig(**args), t_mlp.MLPConfig(**args)


def assert_close_arrays(got, want):
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=RTOL * max(np.abs(w).max(), 1e-30))


def train_both(jcfg, tcfg, args, kw, seed=5):
    js, jr, jmodel = jax_mlp.train_mlp(jcfg, *args, seed=seed, **kw)
    ts, tr, tmodel = t_mlp.train_mlp(tcfg, *args, seed=seed, device="cpu",
                                     init_model=carried_start(tcfg, seed),
                                     **kw)
    return (js, jr, jmodel), (ts, tr, tmodel)


@pytest.mark.parametrize("validation", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_train_mlp_matches_jax(weighted, validation):
    x, y, w, xv, yv, wv = data()
    jcfg, tcfg = configs()
    kw = {}
    if weighted:
        kw["weights"] = w
    if validation:
        kw.update(x_val=xv, y_val=yv, w_val=wv if weighted else None)
    (js, jr, jm), (ts, tr, tm) = train_both(jcfg, tcfg, (x, y), kw)
    assert len(ts) == len(js) == (3 if validation else 0)
    assert len(tr) == len(jr) == (3 if validation and weighted else 0)
    np.testing.assert_allclose(ts, js, rtol=RTOL)
    np.testing.assert_allclose(tr, jr, rtol=RTOL)
    params, bn_state = mlp_to_numpy(tm)
    assert_close_arrays(params, jm["params"])
    assert_close_arrays(bn_state, jm["bn_state"])
    want = np.asarray(jax_mlp.mlp_predict(jm, xv))
    got = t_mlp.mlp_predict(tm, xv).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=RTOL * np.abs(want).max())


def halvings_from_trace(scores):
    """The epochs at which the per-epoch plateau rule halves the rate,
    replayed on a validation trace (relative threshold 1e-4, patience 2)."""
    best, wait, out = np.inf, 0, []
    for epoch, s in enumerate(scores):
        if s < best * (1 - 1e-4):
            best, wait = s, 0
        else:
            wait += 1
            if wait >= 2:
                out.append(epoch)
                wait = 0
    return out


def test_plateau_and_early_stop_fire_at_jax_epochs(monkeypatch):
    """A high rate on a validation set of noise: the validation MSE stops
    improving, the rate halves every 2 flat epochs and training stops 10
    epochs after the best one, at the same epochs in both packages."""
    x, y, w, xv, yv, wv = data(n=64, noise_val=True, seed=2)
    jcfg, tcfg = configs(learning_rate=0.5, n_epochs=40)
    rates = []

    class RecordingAdam(t_mlp.AdamGroup):
        def step(self, grads):
            rates.append(self.lr)
            super().step(grads)

    monkeypatch.setattr(t_mlp, "AdamGroup", RecordingAdam)
    kw = dict(weights=w, x_val=xv, y_val=yv, w_val=wv)
    (js, jr, jm), (ts, tr, tm) = train_both(jcfg, tcfg, (x, y), kw)
    np.testing.assert_allclose(ts, js, rtol=RTOL)
    np.testing.assert_allclose(tr, jr, rtol=RTOL)
    best = int(np.argmin(js))
    assert len(ts) == len(js) == best + 11 < 40  # the early stop
    halvings = halvings_from_trace(js[:-1])  # the last epoch breaks first
    assert halvings
    steps = len(x) // 32
    per_epoch = [rates[e * steps] for e in range(len(ts))]
    want = [0.5 * 0.5 ** sum(h < e for h in halvings)
            for e in range(len(ts))]
    assert per_epoch == want
    # the best epoch's state is restored
    assert_close_arrays(mlp_to_numpy(tm)[0], jm["params"])


def test_batch_norm_modes_and_single_row_batch():
    """Training mode normalises by the batch (biased variance) and moves
    the running statistics by the unbiased one; eval uses the running
    ones; a batch of one row trains (unbiased divisor max(n - 1, 1))."""
    cfg = t_mlp.MLPConfig(input_dim=3, hidden_dims=[5])
    model = t_mlp.init_mlp(cfg, seed=1, dtype=torch.float64, device="cpu")
    p, s = mlp_to_numpy(model)
    x = np.random.default_rng(0).normal(size=(7, 3))
    for n in (7, 1):
        jout, jstate = jax_mlp.mlp_apply(p, s, x[:n], train=True)
        m = mlp_from_numpy(p, s, cfg, "cpu")
        tout = t_mlp.mlp_apply(m, torch.from_numpy(x[:n]), train=True)
        np.testing.assert_allclose(tout.detach().numpy(), jout,
                                   rtol=1e-12, atol=1e-12)
        assert_close_arrays(mlp_to_numpy(m)[1], jstate)
    jout, _ = jax_mlp.mlp_apply(p, s, x, train=False)
    tout = t_mlp.mlp_apply(model, torch.from_numpy(x), train=False)
    np.testing.assert_allclose(tout.detach().numpy(), jout, rtol=1e-12)
    one = t_mlp.MLPConfig(input_dim=3, hidden_dims=[5], batch_size=8,
                          n_epochs=2)
    scores, _, trained = t_mlp.train_mlp(one, x[:1], np.ones((1, 1)),
                                         device="cpu")
    assert np.all(np.isfinite(mlp_to_numpy(trained)[0]["layers"][0]["w"]))


def test_init_mlp_distributions():
    """The port's own start: U(+-1/sqrt(fan_in)) weights from its seeded
    generator, zero biases, BN scale 1 / bias 0, running mean 0 / var 1;
    the same seed gives the same model."""
    cfg = t_mlp.MLPConfig(input_dim=64, hidden_dims=[32, 16])
    a = t_mlp.init_mlp(cfg, seed=3, device="cpu")
    b = t_mlp.init_mlp(cfg, seed=3, device="cpu")
    pa, sa = mlp_to_numpy(a)
    assert_close_arrays(pa, mlp_to_numpy(b)[0])
    for layer, fan_in in zip(pa["layers"], (64, 32, 16)):
        bound = 1 / np.sqrt(fan_in)
        assert np.abs(layer["w"]).max() <= bound
        assert np.abs(layer["w"]).max() > 0.9 * bound
        assert not layer["b"].any()
    assert (pa["bn_scale"] == 1).all() and not pa["bn_bias"].any()
    assert not sa["mean"].any() and (sa["var"] == 1).all()
    assert a.weights[0].dtype == torch.float32
