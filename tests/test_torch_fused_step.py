"""The fused single-layer train step of the torch port (its plain version,
which CPU tensors take) against the JAX package's
``kan_train_step_fused`` in Pallas interpret mode, on the same numpy
inputs; the fold ``weights_to_m3``; and the headline QKAN-layer step
(N = K = 16, degree 7, no tanh, 'sumsq') at a small batch.

Bars:
- float32 x: both sides build the same basis and take f32 products; only
  the summation order and tanh's last ulp differ.  Loss rtol 1e-5, dW
  relative norm < 1e-5: the bars of the JAX package's own test of the
  step against ``jax.grad``.
- bfloat16 x: both sides round tanh, the recurrence and w2 to bf16 at the
  same points (the JAX side compiled without XLA's excess precision, as
  in test_torch_fused_layer.py) and multiply exactly in f32, so the same
  bars hold.  x is drawn again where XLA's f32 tanh and torch's differ in
  the last ulp, since that can flip a bf16 rounding.
- against float64 autograd (the port alone, at a batch JAX refuses): the
  f32 step within loss rtol 1e-5 and dW within 1e-5 max|dW|.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from qkan_implementation_tpu.experimental.pallas_layer import (
    weights_to_m3 as jax_weights_to_m3,
)
from qkan_implementation_tpu.ops.fused_layer import (
    kan_train_step_fused as jax_step,
)
from qkan_implementation_tpu_torch.experimental.pallas_layer import (
    weights_to_m3,
)
from qkan_implementation_tpu_torch.ops import (
    chebyshev_basis,
    kan_train_step_fused,
    kan_train_step_fused_reference,
    qkan_layer_forward_batched,
)

# tests/test_fused_layer.py::test_fused_train_step_matches_jax_grad
B, N_IN, DP1, T = 512, 16, 8, 16


def _inputs(b=B, n=N_IN, dp1=DP1, t_dim=T, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (b, n)).astype(np.float32)
    w2 = rng.uniform(-1, 1, (dp1 * n, t_dim)).astype(np.float32)
    y = rng.normal(0, 1, (b, t_dim)).astype(np.float32)
    return x, w2, y


def _jax_step(x, w2, y, loss, tanh, bf16_x=False):
    """(loss, dW) of the JAX step in interpret mode (4 tiles of 128 rows),
    compiled without XLA's excess precision."""
    xj = jnp.asarray(x, dtype=jnp.bfloat16 if bf16_x else jnp.float32)
    yj = jnp.asarray(y) if loss == "mse" else None

    def step(xx, ww, yy):
        return jax_step(xx, ww, DP1, y=yy, loss=loss, interpret=True,
                        apply_tanh=tanh, tile_b=128)

    comp = jax.jit(step).lower(xj, jnp.asarray(w2), yj).compile(
        compiler_options={"xla_allow_excess_precision": False}
    )
    got_l, got_dw = comp(xj, jnp.asarray(w2), yj)
    return float(got_l), np.asarray(got_dw, dtype=np.float64)


def _assert_step_close(got, want_l, want_dw):
    loss, dw = got
    assert loss.dtype == torch.float32 and loss.shape == ()
    assert dw.dtype == torch.float32
    np.testing.assert_allclose(float(loss), want_l, rtol=1e-5)
    dw = dw.double().numpy()
    rel = np.linalg.norm(dw - want_dw) / np.linalg.norm(want_dw)
    assert rel < 1e-5, rel


def _tanh_agreeing(x, seed=0):
    """x drawn again, from its own range, where XLA's f32 tanh and
    torch's differ."""
    x = x.copy()
    rng = np.random.default_rng(seed)
    for _ in range(200):
        bad = np.asarray(jnp.tanh(jnp.asarray(x))) != torch.tanh(
            torch.from_numpy(x)
        ).numpy()
        if not bad.any():
            return x
        x[bad] = rng.uniform(-1, 1, int(bad.sum())).astype(np.float32)
    raise AssertionError("no tanh-agreeing inputs")


@pytest.mark.parametrize("loss", ["sumsq", "mse"])
@pytest.mark.parametrize("tanh", [True, False], ids=["tanh", "raw"])
def test_plain_step_matches_jax_interpret(loss, tanh):
    x, w2, y = _inputs()
    got = kan_train_step_fused(
        torch.from_numpy(x), torch.from_numpy(w2), DP1,
        y=torch.from_numpy(y) if loss == "mse" else None, loss=loss,
        apply_tanh=tanh,
    )
    _assert_step_close(got, *_jax_step(x, w2, y, loss, tanh))


@pytest.mark.parametrize("loss", ["sumsq", "mse"])
@pytest.mark.parametrize("tanh", [True, False], ids=["tanh", "raw"])
def test_bf16_x_step_matches_jax_interpret(loss, tanh):
    x, w2, y = _inputs(seed=6)
    if tanh:
        x = _tanh_agreeing(x)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = kan_train_step_fused(
        xt, torch.from_numpy(w2), DP1,
        y=torch.from_numpy(y) if loss == "mse" else None, loss=loss,
        apply_tanh=tanh,
    )
    _assert_step_close(got, *_jax_step(x, w2, y, loss, tanh, bf16_x=True))
    # control: the bf16 step moves from the f32 step on the same values by
    # far more than the bar, so a version that skips the rounding fails
    _, dw32 = kan_train_step_fused(
        xt.float(), torch.from_numpy(w2), DP1,
        y=torch.from_numpy(y) if loss == "mse" else None, loss=loss,
        apply_tanh=tanh,
    )
    dw = got[1].double().numpy()
    gap = np.linalg.norm(dw32.double().numpy() - dw) / np.linalg.norm(dw)
    assert gap > 1e-4


def test_value_errors_match_jax():
    x, w2, y = _inputs(b=8)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w2)
    xj, wj = jnp.asarray(x), jnp.asarray(w2)
    for kw, match in (
        (dict(loss="mae"), "unknown loss"),
        (dict(loss="mse"), "needs targets"),
        (dict(precision="x9"), "unknown fused precision"),
    ):
        with pytest.raises(ValueError, match=match):
            jax_step(xj, wj, DP1, interpret=True, **kw)
        for fn in (kan_train_step_fused, kan_train_step_fused_reference):
            with pytest.raises(ValueError, match=match):
                fn(xt, wt, DP1, **kw)
    with pytest.raises(ValueError, match="B >= 1"):
        kan_train_step_fused(xt[:0], wt, DP1)


@pytest.mark.parametrize("loss", ["sumsq", "mse"])
def test_any_batch_against_float64_autograd(loss):
    """B = 300: JAX refuses a batch that is no multiple of its tile; the
    port masks rows and takes it.  Held to float64 autograd of the step's
    objective (the JAX test's ``fwd``)."""
    x, w2, y = _inputs(b=300, seed=7)
    with pytest.raises(ValueError, match="multiple of the tile"):
        jax_step(jnp.asarray(x), jnp.asarray(w2), DP1, interpret=True,
                 tile_b=256)
    got_l, got_dw = kan_train_step_fused(
        torch.from_numpy(x), torch.from_numpy(w2), DP1,
        y=torch.from_numpy(y) if loss == "mse" else None, loss=loss,
    )
    x64 = torch.tanh(torch.from_numpy(x).double())
    w64 = torch.from_numpy(w2).double().requires_grad_()
    bas = chebyshev_basis(x64, DP1 - 1, clip=False)
    out = bas.transpose(1, 2).reshape(300, -1) @ w64
    if loss == "sumsq":
        want_l = torch.sum(out**2)
    else:
        want_l = torch.mean((out - torch.from_numpy(y).double()) ** 2)
    (want_dw,) = torch.autograd.grad(want_l, [w64])
    np.testing.assert_allclose(float(got_l), want_l.item(), rtol=1e-5)
    err = float((got_dw.double() - want_dw).abs().max())
    assert err <= 1e-5 * float(want_dw.abs().max())


def test_wrapper_takes_plain_version_on_cpu_and_ignores_tile_b():
    x, w2, y = _inputs(b=64)
    args = (torch.from_numpy(x), torch.from_numpy(w2), DP1)
    before = kan_train_step_fused.launches
    for tile_b in (None, 8, 1000):
        got = kan_train_step_fused(*args, y=torch.from_numpy(y), loss="mse",
                                   tile_b=tile_b)
        want = kan_train_step_fused_reference(*args, y=torch.from_numpy(y),
                                              loss="mse")
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    # 'sumsq' never reads y
    sumsq = kan_train_step_fused(*args, y=torch.from_numpy(y))
    assert all(torch.equal(a, b) for a, b in
               zip(sumsq, kan_train_step_fused(*args)))
    assert kan_train_step_fused.launches == before == 0


# -- the headline QKAN-layer step --------------------------------------------

QN = QK = 16
QDEG = 7


def test_weights_to_m3_matches_jax():
    w = np.random.default_rng(9).uniform(-1, 1, (QDEG + 1, QN * QK))
    got = weights_to_m3(torch.from_numpy(w), QN, QK)
    want = np.asarray(jax_weights_to_m3(jnp.asarray(w), QN, QK))
    assert got.shape == (QDEG + 1, QN, QK) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-15)


def test_headline_fold_is_the_batched_layer():
    """The fold's w2 through the step's forward is
    ``qkan_layer_forward_batched``: the step trains that layer."""
    rng = np.random.default_rng(10)
    x = torch.from_numpy(rng.uniform(-1, 1, (64, QN)))
    w = torch.from_numpy(rng.uniform(-1, 1, (QDEG + 1, QN * QK)))
    w2 = weights_to_m3(w, QN, QK).reshape(-1, QK)
    bas = chebyshev_basis(x, QDEG, clip=False)  # [B, N, D+1]
    out = bas.transpose(1, 2).reshape(64, -1) @ w2
    want = qkan_layer_forward_batched(x, w, QN, QK)
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-12,
                               atol=1e-14)
    # the step takes out, err and the loss in f32, whatever x's dtype
    loss, _ = kan_train_step_fused_reference(x, w2, QDEG + 1,
                                             apply_tanh=False)
    np.testing.assert_allclose(float(loss), float(torch.sum(want**2)),
                               rtol=1e-6)


def test_headline_steps_match_jax():
    """Three steps w2 <- w2 - lr dW of the headline step at B = 256, x
    rotating between a batch and its reverse (the rotating-pool chain of
    benchmarks/fused_retune_probe.py), on the port's CPU path and in JAX.
    lr 1e-4 moves w2 about as far at B = 256 as the probe's 1e-7 at
    B = 262144 (dW sums over the batch)."""
    b, lr, steps = 256, 1e-4, 3
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (b, QN)).astype(np.float32)
    pool = np.stack([x, x[::-1]])
    w = rng.uniform(-1, 1, (QDEG + 1, QN * QK)).astype(np.float32)

    w2_t = weights_to_m3(torch.from_numpy(w), QN, QK).reshape(-1, QK)
    w2_j = jax_weights_to_m3(jnp.asarray(w), QN, QK).reshape(-1, QK)
    np.testing.assert_allclose(w2_t.numpy(), np.asarray(w2_j), rtol=1e-6,
                               atol=1e-7)
    losses_t, losses_j = [], []
    for i in range(steps):
        lt, dwt = kan_train_step_fused(torch.from_numpy(pool[i % 2]), w2_t,
                                       QDEG + 1, loss="sumsq",
                                       apply_tanh=False)
        lj, dwj = jax_step(jnp.asarray(pool[i % 2]), w2_j, QDEG + 1,
                           loss="sumsq", interpret=True, apply_tanh=False)
        w2_t = w2_t - lr * dwt
        w2_j = w2_j - lr * dwj
        losses_t.append(float(lt))
        losses_j.append(float(lj))
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-5)
    assert losses_t[-1] < losses_t[0]  # the steps descend
    w2_j = np.asarray(w2_j)
    moved = np.abs(w2_j - np.asarray(jax_weights_to_m3(
        jnp.asarray(w), QN, QK)).reshape(-1, QK)).max()
    err = np.abs(w2_t.numpy() - w2_j).max()
    assert err <= 1e-6 * np.abs(w2_j).max() and moved > 100 * err
