"""The int8 serving recipes of the torch port against the JAX package, on
the CPU (the JAX side x64, as its suite runs).

Both packages' int8 products are spied on: the JAX recipes call
``jax.lax.dot_general`` on int8 operands, the port's call
``ops.qkan_layer.int8_matmul``.  Bars:
- the quantised operands (int8) and the int32 accumulators are EQUAL;
- the float32 outputs within 4 float32 ulps of JAX's (the dequantisation
  is the same f32 arithmetic; only an operation order could differ);
- the shapes: an N = K = 16 layer (F = 128), a fan-in over 512
  (F = 1024), the flagship's last layer (F = 96, K = 10) at B = 1, and
  the flagship's layer 0 (F = 4704, K = 32): the padding edges of the
  card's ``torch._int_mm`` route, run here through the plain version.
- ``kan_layer_apply`` and ``FixedKAN(compute_dtype=...)`` on the same
  parameters: in float64 the same bars.  In float32 the basis comes
  through tanh, which XLA and torch compute up to an ulp apart, and an
  ulp can move a rounding across a half: there each operand element is
  within one level of JAX's (in at most 1 % of the elements), each
  side's accumulators are the exact products of its own operands, and
  the outputs within 1e-3 of max|out| (one first-level step of one
  basis element moves an output by at most s_w / 127; measured 6.1e-4).
- 'int8' warns at fan-in >= 512 as JAX does.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qkan_implementation_tpu.models import fixed_kan as jax_fk
from qkan_implementation_tpu.ops import qkan_layer as jax_ql
from qkan_implementation_tpu_torch.models import fixed_kan as t_fk
from qkan_implementation_tpu_torch.ops import qkan_layer as t_ql
from qkan_implementation_tpu_torch.utils.convert import params_from_numpy

ULPS = 4 * np.finfo(np.float32).eps
RECIPES = ("int8", "int8x2", "int8x2w")
# (B, F, K)
SHAPES = [(37, 128, 16), (64, 1024, 8), (1, 96, 10), (3, 4704, 32)]


def _jax_recipe(recipe, a, w):
    if recipe == "int8":
        return jax_ql.int8_quantized_matmul(a, w)
    return jax_ql.int8_residual_matmul(a, w, acts_residual=recipe == "int8x2")


def _port_recipe(recipe, a, w):
    if recipe == "int8":
        return t_ql.int8_quantized_matmul(a, w)
    return t_ql.int8_residual_matmul(a, w, acts_residual=recipe == "int8x2")


def spied(monkeypatch):
    """(jax products, port products): each a list of (qa, qw, acc) numpy
    triples in call order."""
    jax_calls, port_calls = [], []
    real_dot = jax.lax.dot_general
    real_mm = t_ql.int8_matmul

    def jax_spy(a, b, *args, **kw):
        out = real_dot(a, b, *args, **kw)
        if a.dtype == jnp.int8:
            jax_calls.append((np.asarray(a), np.asarray(b), np.asarray(out)))
        return out

    def port_spy(qa, qw):
        out = real_mm(qa, qw)
        port_calls.append((qa.numpy(), qw.numpy(), out.numpy()))
        return out

    monkeypatch.setattr(jax.lax, "dot_general", jax_spy)
    monkeypatch.setattr(t_ql, "int8_matmul", port_spy)
    return jax_calls, port_calls


def assert_products_equal(jax_calls, port_calls):
    assert len(jax_calls) == len(port_calls) > 0
    for (ja, jb, jacc), (ta, tb, tacc) in zip(jax_calls, port_calls):
        assert ja.dtype == ta.dtype == np.int8
        np.testing.assert_array_equal(ta, ja)
        np.testing.assert_array_equal(tb, jb)
        assert jacc.dtype == tacc.dtype == np.int32
        np.testing.assert_array_equal(tacc, jacc)


def assert_products_consistent(jax_calls, port_calls):
    """Operands within one level, in at most 1 % of the elements; each
    side's accumulators the exact products of its own operands."""
    assert len(jax_calls) == len(port_calls) > 0
    for side in (jax_calls, port_calls):
        for qa, qw, acc in side:
            np.testing.assert_array_equal(
                acc, qa.astype(np.int64) @ qw.astype(np.int64))
    for (ja, jb, _), (ta, tb, _) in zip(jax_calls, port_calls):
        for j, t in ((ja, ta), (jb, tb)):
            diff = np.abs(t.astype(np.int32) - j)
            assert diff.max() <= 1 and np.mean(diff != 0) <= 0.01


def assert_f32_close(got, want):
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=ULPS,
                               atol=ULPS * float(np.abs(want).max()))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("b,f,k", SHAPES)
@pytest.mark.parametrize("recipe", RECIPES)
def test_int8_recipe_operands_and_accumulators(monkeypatch, recipe, b, f, k,
                                               dtype):
    rng = np.random.default_rng(f + k + b)
    a = rng.uniform(-1, 1, (b, f)).astype(dtype)
    w = rng.normal(0, 0.3, (f, k)).astype(dtype)
    jax_calls, port_calls = spied(monkeypatch)
    want = np.asarray(_jax_recipe(recipe, jnp.asarray(a), jnp.asarray(w)))
    got = _port_recipe(recipe, torch.from_numpy(a), torch.from_numpy(w))
    assert_products_equal(jax_calls, port_calls)
    assert len(port_calls) == {"int8": 1, "int8x2": 3, "int8x2w": 2}[recipe]
    assert_f32_close(got.numpy(), want)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n,k,d,b", [(16, 16, 7, 256), (4, 4, 3, 1),
                                     (16, 10, 5, 37)])
def test_int8_layer_forward_matches_jax(monkeypatch, n, k, d, b, dtype):
    """``qkan_layer_forward_batched_int8``: the JAX suite's N = K = 16,
    degree 7, B = 256 case, and narrower layers at B = 1 and 37."""
    rng = np.random.default_rng(11)
    x = rng.uniform(-1, 1, (b, n)).astype(dtype)
    w = rng.uniform(-1, 1, (d + 1, n * k)).astype(dtype)
    jax_calls, port_calls = spied(monkeypatch)
    want = np.asarray(jax_ql.qkan_layer_forward_batched_int8(
        jnp.asarray(x), jnp.asarray(w), n, k))
    got = t_ql.qkan_layer_forward_batched_int8(
        torch.from_numpy(x), torch.from_numpy(w), n, k).numpy()
    assert_products_equal(jax_calls, port_calls)
    assert_f32_close(got, want)
    # the JAX suite's accuracy bar against the exact path holds here too
    exact = t_ql.qkan_layer_forward_batched(
        torch.from_numpy(x), torch.from_numpy(w), n, k).numpy()
    assert np.max(np.abs(got - exact)) < 2e-3


def test_int8_zero_weights_and_boundary_inputs():
    """Zero weights give exactly zero (the 1e-30 scale guard), inputs at
    +-1 quantise in range, and a second call gives the same bits."""
    n = k = 4
    d = 3
    x = torch.tensor([[-1.0, -0.5, 0.5, 1.0]])
    out = t_ql.qkan_layer_forward_batched_int8(
        x, torch.zeros(d + 1, n * k), n, k)
    assert torch.equal(out, torch.zeros(1, k))
    w = torch.from_numpy(
        np.random.default_rng(3).uniform(-1, 1, (d + 1, n * k)).astype(
            np.float32))
    got = t_ql.qkan_layer_forward_batched_int8(x, w, n, k)
    want = np.asarray(jax_ql.qkan_layer_forward_batched_int8(
        jnp.asarray(x.numpy()), jnp.asarray(w.numpy()), n, k))
    assert_f32_close(got.numpy(), want)
    assert torch.equal(got, t_ql.qkan_layer_forward_batched_int8(x, w, n, k))


def test_int8_matmul_plain_version_is_exact():
    rng = np.random.default_rng(0)
    qa = rng.integers(-127, 128, (5, 4704)).astype(np.int8)
    qw = rng.integers(-127, 128, (4704, 3)).astype(np.int8)
    got = t_ql.int8_matmul(torch.from_numpy(qa), torch.from_numpy(qw))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), qa.astype(np.int64) @ qw.astype(np.int64))
    with pytest.raises(ValueError, match="int8 operands"):
        t_ql.int8_matmul(torch.zeros(2, 2), torch.zeros(2, 2))


def layer_params(rng, in_dim, out, t_dim, d):
    return {
        "degrees": rng.integers(0, d + 1, out).astype(np.int32),
        "coefficients": rng.normal(0, 0.3, (out, in_dim, d + 1, t_dim)
                                   ).astype(np.float32),
        "horizontal_weights": rng.normal(0, 1, out).astype(np.float32),
    }


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("in_dim", [16, 256])
@pytest.mark.parametrize("recipe", RECIPES)
def test_kan_layer_apply_int8_routes(monkeypatch, recipe, in_dim, dtype):
    """The JAX suite's fan-in 1024 layer (in 256, D 3) and a narrow one:
    the port's routes give JAX's products and outputs; 'int8' warns at
    fan-in >= 512 in both packages and not below."""
    rng = np.random.default_rng(7)
    d = 3
    lp = {k: (v.astype(dtype) if v.dtype == np.float32 else v)
          for k, v in layer_params(rng, in_dim, 8, 4, d).items()}
    x = rng.uniform(-1, 1, (64, in_dim)).astype(dtype)
    jax_calls, port_calls = spied(monkeypatch)
    jlp = {k: jnp.asarray(v) for k, v in lp.items()}
    jdt = jnp.int8 if recipe == "int8" else recipe
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        want = np.asarray(jax_fk.kan_layer_apply(
            jlp, jnp.asarray(x), d, compute_dtype=jdt))
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        got = t_fk.kan_layer_apply(
            params_from_numpy([lp], "cpu")[0], torch.from_numpy(x), d,
            compute_dtype=recipe).numpy()
    if dtype == np.float64:
        assert_products_equal(jax_calls, port_calls)
        assert_f32_close(got, want)
    else:
        assert_products_consistent(jax_calls, port_calls)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-3 * float(np.abs(want).max()))
    fan_in = in_dim * (d + 1)
    j_warned = [w for w in jw if f"fan-in {fan_in}" in str(w.message)]
    t_warned = [w for w in tw if f"fan-in {fan_in}" in str(w.message)]
    expect = recipe == "int8" and fan_in >= 512
    assert bool(j_warned) == bool(t_warned) == expect


@pytest.mark.parametrize("recipe", RECIPES)
def test_fixed_kan_compute_dtype_serves_int8(recipe):
    """``FixedKAN(compute_dtype=recipe)`` on parameters carried from a
    JAX model optimized on the reference's quadratic, in float64 (torch's
    default dtype set to it, the port's x64): JAX's float32 output;
    training with the recipe raises (rounding has no gradient)."""
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        _serve_int8_model(recipe)
    finally:
        torch.set_default_dtype(old)


def _serve_int8_model(recipe):
    x = np.linspace(-1, 1, 100).reshape(-1, 1)
    y = 0.5 * x**2 + 0.3 * x + 0.1
    cfg = dict(network_shape=[1, 4, 1], max_degree=3,
               degree_objective="penalized_mse", complexity_weight=1e-3)
    exact = jax_fk.FixedKAN(jax_fk.FixedKANConfig(**cfg))
    exact.optimize(jnp.asarray(x), jnp.asarray(y), solver="exact")
    jq = jax_fk.FixedKAN(jax_fk.FixedKANConfig(
        **cfg, compute_dtype=jnp.int8 if recipe == "int8" else recipe))
    jq.params = exact.params
    tq = t_fk.FixedKAN(t_fk.FixedKANConfig(**cfg, compute_dtype=recipe),
                       device="cpu")
    tq.params = params_from_numpy(
        [{k: np.asarray(v) for k, v in lp.items()} for lp in exact.params],
        "cpu")
    want = np.asarray(jq(jnp.asarray(x)))  # jitted: no operands to spy on
    got = tq(x).numpy()
    assert_f32_close(got, want)
    out_e = np.asarray(exact(jnp.asarray(x)), dtype=np.float32)
    assert 0.0 < np.max(np.abs(got - out_e)) < 0.05 * max(
        float(np.std(out_e)), 1.0)
    with pytest.raises(ValueError, match="zero gradient"):
        tq.train(x, y, epochs=1, loss="mse", compute_dtype=recipe)
