"""FixedKAN.train of the torch port against the JAX package's, on the CPU,
from the same numpy parameters and data: per-epoch losses and the final
parameters after a few epochs of Adam on a [12, 6, 3] network, D = 3,
batch 16.  Both sides draw the same batches (numpy's generator from the
same seed), so the trajectories can be held step for step.

Bars:
- 'xla' in float64 (the JAX suite runs x64): losses rtol 1e-9, final
  parameters rtol 1e-9 / atol 1e-12 over their max.  Both sides run the
  same float64 arithmetic; only summation orders differ.
- 'fused_dw' and 'fused': float32 kernels (the port's plain versions vs
  JAX's Pallas interpret) under float64 Adam: losses rtol 1e-4, final
  coefficients within 1e-4 after dividing by max|coef|, the bars of the
  JAX package's own test_train_fused_f32_tracks_xla_trajectory.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from qkan_implementation_tpu.models import fixed_kan as jax_fk
from qkan_implementation_tpu_torch.models import fixed_kan as torch_fk
from qkan_implementation_tpu_torch.models._optim import cosine_decay
from qkan_implementation_tpu_torch.utils.convert import params_from_numpy

SHAPE, D, T = [12, 6, 3], 3, 3

RECIPES = {
    # the reference trainer's knobs: constant lr, no clipping
    "plain": dict(learning_rate=0.01),
    # the 'recommended' train preset's knobs, with a clip small enough
    # that every label group is clipped, each by its own norm
    "recommended": dict(learning_rate=0.01, lr_scale="fanin",
                        lr_schedule="cosine", grad_clip=0.05),
}


def network(seed):
    rng = np.random.default_rng(seed)
    layers, in_dim = [], SHAPE[0]
    for out in SHAPE[1:]:
        sigma = 1.0 / np.sqrt(out * in_dim * (D + 1) / 4)
        layers.append({
            "degrees": rng.integers(1, D + 1, out).astype(np.int32),
            "coefficients": rng.normal(0, sigma, (out, in_dim, D + 1, T)),
            "horizontal_weights": rng.normal(1.0, 0.1, out),
        })
        in_dim = T
    return layers


def data(seed, n=80, loss="cross_entropy", dtype=np.float64):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, SHAPE[0])).astype(dtype)
    if loss == "cross_entropy":
        y = np.argmax(x @ rng.normal(size=(SHAPE[0], T)), axis=1)
    else:
        y = np.tanh(x[:, :T] * 2).astype(dtype)
    return x, y


def train_both(params, x, y, **kw):
    """(losses, params) of each package after the same train call."""
    cfg = dict(network_shape=SHAPE, max_degree=D)
    jkan = jax_fk.FixedKAN(jax_fk.FixedKANConfig(**cfg))
    jkan.params = [{k: jnp.asarray(v) for k, v in lp.items()}
                   for lp in params]
    jlosses = jkan.train(jnp.asarray(x), jnp.asarray(y), **kw)
    tkan = torch_fk.FixedKAN(torch_fk.FixedKANConfig(**cfg), device="cpu")
    tkan.params = params_from_numpy(params, "cpu")
    tlosses = tkan.train(x, y, **kw)
    for kan in (jkan, tkan):
        assert kan.last_train_diverged is False
        assert kan.last_train_losses == list(
            jlosses if kan is jkan else tlosses
        )
    assert tkan.last_matmul_precision == jkan.last_matmul_precision
    jparams = [{k: np.asarray(v) for k, v in lp.items()}
               for lp in jkan.params]
    tparams = [{k: v.numpy() for k, v in lp.items()} for lp in tkan.params]
    return (np.asarray(jlosses), jparams), (np.asarray(tlosses), tparams)


def assert_params_close(got, want, rtol, atol):
    for lp_t, lp_j in zip(got, want):
        np.testing.assert_array_equal(lp_t["degrees"], lp_j["degrees"])
        for k in ("coefficients", "horizontal_weights"):
            assert lp_t[k].dtype == lp_j[k].dtype
            scale = np.abs(lp_j[k]).max()
            np.testing.assert_allclose(lp_t[k] / scale, lp_j[k] / scale,
                                       rtol=rtol, atol=atol)


@pytest.mark.parametrize("recipe", sorted(RECIPES))
@pytest.mark.parametrize("trainable", ["all", "horizontal"])
@pytest.mark.parametrize("loss", ["cross_entropy", "mse"])
def test_xla_train_matches_jax_float64(loss, trainable, recipe):
    params = network(1)
    x, y = data(2, loss=loss)
    (jl, jp), (tl, tp) = train_both(
        params, x, y, epochs=3, batch_size=16, loss=loss,
        trainable=trainable, seed=4, **RECIPES[recipe],
    )
    assert len(tl) == 3 and np.all(np.isfinite(tl))
    np.testing.assert_allclose(tl, jl, rtol=1e-9)
    assert_params_close(tp, jp, rtol=1e-9, atol=1e-12)
    if trainable == "horizontal":
        # the coefficients never move
        for lp, lp0 in zip(tp, params):
            np.testing.assert_array_equal(lp["coefficients"],
                                          lp0["coefficients"])


@pytest.mark.parametrize(
    "loss,trainable,recipe",
    [("cross_entropy", "all", "recommended"), ("mse", "horizontal", "plain")],
)
@pytest.mark.parametrize("backend", ["fused_dw", "fused"])
def test_fused_train_matches_jax(backend, loss, trainable, recipe):
    params = network(3)
    x, y = data(5, loss=loss, dtype=np.float32)
    (jl, jp), (tl, tp) = train_both(
        params, x, y, epochs=3, batch_size=16, loss=loss,
        trainable=trainable, seed=6, backend=backend, **RECIPES[recipe],
    )
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert_params_close(tp, jp, rtol=0, atol=1e-4)
    # and the fused trajectory tracks the port's own 'xla' one
    tkan = torch_fk.FixedKAN(
        torch_fk.FixedKANConfig(network_shape=SHAPE, max_degree=D),
        device="cpu",
    )
    tkan.params = params_from_numpy(params, "cpu")
    xla = tkan.train(x, y, epochs=3, batch_size=16, loss=loss,
                     trainable=trainable, seed=6, **RECIPES[recipe])
    np.testing.assert_allclose(tl, xla, rtol=1e-4)


@pytest.mark.parametrize("clip", [None, 0.5])
@pytest.mark.parametrize("schedule", [False, True])
def test_adam_groups_match_optax_multi_transform(clip, schedule):
    """AdamGroup step for step against optax.multi_transform of
    chain(clip_by_global_norm, adam) per label group, with gradients
    whose norms fall on both sides of the clip.  Each group is clipped by
    its own norm: one clip over all leaves would be another optimizer."""
    import optax
    from qkan_implementation_tpu_torch.models._optim import AdamGroup

    rng = np.random.default_rng(0)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2)}
    labels = {"a": "g1", "b": "g1", "c": "g2"}
    lrs = {"g1": 0.05, "g2": 0.002}
    steps = 6

    def make(lr):
        if schedule:
            lr = optax.cosine_decay_schedule(lr, steps - 2)
        if clip:
            return optax.chain(optax.clip_by_global_norm(clip),
                               optax.adam(lr))
        return optax.adam(lr)

    tx = optax.multi_transform({k: make(v) for k, v in lrs.items()},
                               labels)
    init = {k: rng.normal(size=s) for k, s in shapes.items()}
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
    groups = {
        name: AdamGroup([tp[k] for k in sorted(tp) if labels[k] == name],
                        lr, clip, steps - 2 if schedule else None)
        for name, lr in lrs.items()
    }
    for step in range(steps):
        scale = 0.05 if step % 2 else 3.0  # below and above the clip
        grads = {k: rng.normal(size=s) * scale for k, s in shapes.items()}
        updates, state = tx.update(
            {k: jnp.asarray(v) for k, v in grads.items()}, state, jp
        )
        jp = optax.apply_updates(jp, updates)
        for name, grp in groups.items():
            grp.step([torch.from_numpy(grads[k]) for k in sorted(tp)
                      if labels[k] == name])
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-12, atol=1e-14)


def test_cosine_schedule_matches_optax():
    import optax

    sched = optax.cosine_decay_schedule(0.3, 17)
    for k in (0, 1, 8, 16, 17, 30):
        assert cosine_decay(0.3, 17, k) == pytest.approx(float(sched(k)),
                                                         rel=1e-12)
    with pytest.raises(ValueError, match="decay_steps"):
        cosine_decay(0.3, 0, 0)


def test_divergence_restores_finite_params():
    """As JAX test_train_divergence_detection_restores_finite_params: an
    absurd learning rate stops at the first non-finite loss and restores
    the last finite epoch's parameters."""
    rng = np.random.default_rng(8)
    x = rng.uniform(-1, 1, (128, 4))
    y = rng.normal(size=(128, 1))
    shape = [4, 6, 1]
    layers, in_dim = [], 4
    for out in shape[1:]:
        layers.append({
            "degrees": rng.integers(0, 4, out).astype(np.int32),
            "coefficients": rng.normal(0, 0.3, (out, in_dim, 4, 1)),
            "horizontal_weights": np.ones(out),
        })
        in_dim = 1
    cfg = dict(network_shape=shape, max_degree=3)
    jkan = jax_fk.FixedKAN(jax_fk.FixedKANConfig(**cfg))
    jkan.params = [{k: jnp.asarray(v) for k, v in lp.items()}
                   for lp in layers]
    tkan = torch_fk.FixedKAN(torch_fk.FixedKANConfig(**cfg), device="cpu")
    tkan.params = params_from_numpy(layers, "cpu")
    kw = dict(epochs=30, batch_size=32, learning_rate=1e200, loss="mse")
    jl = jkan.train(jnp.asarray(x), jnp.asarray(y), **kw)
    tl = tkan.train(x, y, **kw)
    assert tkan.last_train_diverged is True is jkan.last_train_diverged
    np.testing.assert_allclose(tl, jl, rtol=1e-9)
    for lp_t, lp_j in zip(tkan.params, jkan.params):
        for k in ("coefficients", "horizontal_weights"):
            assert torch.isfinite(lp_t[k]).all()
            np.testing.assert_allclose(lp_t[k].numpy(), np.asarray(lp_j[k]),
                                       rtol=1e-9, atol=1e-12)
    assert np.all(np.isfinite(tkan(x).numpy()))
    tkan.train(x, y, epochs=2, batch_size=32, learning_rate=1e-4,
               loss="mse")
    assert tkan.last_train_diverged is False
    assert len(tkan.last_train_losses) == 2


def test_precision_routing_per_backend_matches_jax():
    """As JAX test_train_precision_routing_per_backend, on both packages."""
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (120, 1)).astype(np.float32)
    y = (0.5 * x**2 + 0.3 * x + 0.1).astype(np.float32)
    cfg = dict(network_shape=[1, 4, 1], max_degree=3)
    layers = [{
        "degrees": np.array([3, 2, 1, 3], np.int32),
        "coefficients": rng.normal(0, 0.3, (4, 1, 4, 1)),
        "horizontal_weights": np.ones(4),
    }]
    cases = [
        (dict(backend="xla"), "high"),
        (dict(backend="xla", matmul_precision="highest"), "highest"),
        (dict(backend="fused_dw"), "high"),
        (dict(backend="fused_dw", compute_dtype="bfloat16"), "bf16"),
        (dict(backend="fused_dw", matmul_precision="highest"), "high"),
        (dict(backend="fused_dw", matmul_precision="bf16x2_x"), "high"),
        (dict(backend="fused_dw", matmul_precision=None), None),
        (dict(backend="fused"), "high"),
        (dict(backend="fused", matmul_precision=None), "high"),
    ]
    for kw, want in cases:
        jkw = dict(kw)
        if "compute_dtype" in kw:
            jkw["compute_dtype"] = jnp.bfloat16
        jkan = jax_fk.FixedKAN(jax_fk.FixedKANConfig(**cfg))
        jkan.params = [{k: jnp.asarray(v) for k, v in lp.items()}
                       for lp in layers]
        jkan.train(jnp.asarray(x), jnp.asarray(y), epochs=1,
                   learning_rate=1e-3, batch_size=60, loss="mse", **jkw)
        tkan = torch_fk.FixedKAN(torch_fk.FixedKANConfig(**cfg),
                                 device="cpu")
        tkan.params = params_from_numpy(layers, "cpu")
        losses = tkan.train(x, y, epochs=1, learning_rate=1e-3,
                            batch_size=60, loss="mse", **kw)
        assert np.isfinite(losses).all()
        assert jkan.last_matmul_precision == want, kw
        assert tkan.last_matmul_precision == want, kw


def test_train_errors_and_module_flag():
    cfg = torch_fk.FixedKANConfig(network_shape=SHAPE, max_degree=D)
    tkan = torch_fk.FixedKAN(cfg, device="cpu")
    x, y = data(0)
    with pytest.raises(RuntimeError, match="Run optimization"):
        tkan.train(x, y)
    tkan.params = params_from_numpy(network(0), "cpu")
    # mesh= trains on 'xla' only (tests/test_torch_mesh_train.py)
    from qkan_implementation_tpu_torch.parallel import make_mesh

    with pytest.raises(ValueError, match="shard_map"):
        tkan.train(x, y, mesh=make_mesh(2, devices=["cpu"] * 2),
                   backend="fused")
    for cd in ("int8", "int8x2", "int8x2w", torch.int8):
        with pytest.raises(ValueError, match="zero gradient"):
            tkan.train(x, y, compute_dtype=cd)
    with pytest.raises(ValueError, match="Unknown loss"):
        tkan.train(x, y, loss="hinge")
    with pytest.raises(ValueError, match="Unknown trainable"):
        tkan.train(x, y, trainable="degrees")
    with pytest.raises(ValueError, match="Unknown lr_schedule"):
        tkan.train(x, y, lr_schedule="linear")
    # torch's module machinery calls train(mode): it sets the flag only
    assert tkan.eval() is tkan and tkan.training is False
    assert tkan.train(True) is tkan and tkan.training is True


def test_train_horizontal_weights_matches_jax():
    params = network(11)
    x, y = data(12)
    cfg = dict(network_shape=SHAPE, max_degree=D)
    jkan = jax_fk.FixedKAN(jax_fk.FixedKANConfig(**cfg))
    jkan.params = [{k: jnp.asarray(v) for k, v in lp.items()}
                   for lp in params]
    tkan = torch_fk.FixedKAN(torch_fk.FixedKANConfig(**cfg), device="cpu")
    tkan.params = params_from_numpy(params, "cpu")
    jl = jkan.train_horizontal_weights(jnp.asarray(x), jnp.asarray(y), 2,
                                       batch_size=16)
    tl = tkan.train_horizontal_weights(x, y, 2, batch_size=16)
    np.testing.assert_allclose(tl, jl, rtol=1e-9)
    for lp, lp0 in zip(tkan.params, params):
        np.testing.assert_array_equal(lp["coefficients"].numpy(),
                                      lp0["coefficients"])
