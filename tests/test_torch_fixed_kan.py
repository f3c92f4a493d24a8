"""models/fixed_kan of the torch port against the JAX package, on the CPU
with the same numpy parameters and inputs.

Bars:
- 'xla' backend in float64 (the JAX suite runs x64): 1e-10.  Both sides
  fold the same coefficients and multiply the same basis.
- 'fused_dw' and 'fused' backends: float32 kernel semantics on both
  sides (the port's plain versions vs JAX's Pallas interpret), rtol 1e-5
  / atol 1e-6 with O(1) outputs; only summation order and tanh's last ulp
  differ.  'fused' on a float64 x runs its basis in float64 on both sides
  against the f32-rounded fold, so the same bar holds.
- bf16 recipes (bf16x2 splits, bf16 compute_dtype on 'xla'): the bf16
  operands are the same on both sides and multiply exactly in f32; sums
  are f32 in another order: rtol 1e-5 / atol 1e-6.
- 'fused_dw' with compute_dtype=bfloat16: both sides round at the same
  points and differ by the f32 summation order, but one tanh that lands
  an f32 ulp apart can flip a bf16 rounding (see
  test_torch_fused_layer.py): 1e-4 max|out| + 1e-5.  The output must
  also move from the f32 forward's by more than that bar.
"""

import dataclasses
import json

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from qkan_implementation_tpu.models import fixed_kan as jax_fk
from qkan_implementation_tpu_torch.models import fixed_kan as torch_fk
from qkan_implementation_tpu_torch.utils.convert import params_from_numpy
from qkan_implementation_tpu_torch.utils.platform import resolve_device

F32 = dict(rtol=1e-5, atol=1e-6)


def random_layer(rng, in_dim, out, t_dim, max_degree):
    """numpy params of one layer, scaled so its outputs are O(1)."""
    sigma = 1.0 / np.sqrt(out * in_dim * (max_degree + 1) / 4)
    return {
        "degrees": rng.integers(0, max_degree + 1, out).astype(np.int32),
        "coefficients": rng.normal(
            0, sigma, (out, in_dim, max_degree + 1, t_dim)
        ),
        "horizontal_weights": rng.normal(1.0, 0.1, out),
    }


def random_network(rng, shape, t_dim, max_degree):
    layers, in_dim = [], shape[0]
    for out in shape[1:]:
        layers.append(random_layer(rng, in_dim, out, t_dim, max_degree))
        in_dim = t_dim
    return layers


def to_jax(layer):
    return {k: jnp.asarray(v) for k, v in layer.items()}


def to_torch(layer):
    return params_from_numpy([layer], "cpu")[0]


@pytest.mark.parametrize(
    "precision", [None, "auto", "default", "high", "highest"]
)
@pytest.mark.parametrize("in_dim", [23, 90])  # fan-in 138 and 540 at D=5
def test_xla_layer_matches_jax_float64(precision, in_dim):
    rng = np.random.default_rng(in_dim)
    lp = random_layer(rng, in_dim, 7, 4, 5)
    x = rng.uniform(-2, 2, (37, in_dim))
    got = torch_fk.kan_layer_apply(
        to_torch(lp), torch.from_numpy(x), 5, matmul_precision=precision
    )
    want = jax_fk.kan_layer_apply(
        to_jax(lp), jnp.asarray(x), 5, matmul_precision=precision
    )
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10,
                               atol=1e-10)


@pytest.mark.parametrize(
    "kwargs",
    [
        {"matmul_precision": "bf16x2_w"},
        {"matmul_precision": "bf16x2_x"},
        {"compute_dtype": "bfloat16"},
    ],
    ids=["bf16x2_w", "bf16x2_x", "bf16io"],
)
def test_xla_bf16_recipes_match_jax(kwargs):
    rng = np.random.default_rng(3)
    lp = random_layer(rng, 30, 5, 3, 4)
    x = rng.uniform(-2, 2, (19, 30))
    jax_kwargs = dict(kwargs)
    if "compute_dtype" in kwargs:
        jax_kwargs["compute_dtype"] = jnp.bfloat16
    got = torch_fk.kan_layer_apply(to_torch(lp), torch.from_numpy(x), 4,
                                   **kwargs)
    want = jax_fk.kan_layer_apply(to_jax(lp), jnp.asarray(x), 4, **jax_kwargs)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("precision", ["auto", None, "high", "highest",
                                       "bf16x2_w"])
@pytest.mark.parametrize("in_dim", [23, 90])
def test_fused_dw_layer_matches_jax(precision, in_dim):
    rng = np.random.default_rng(100 + in_dim)
    lp = random_layer(rng, in_dim, 7, 4, 5)
    x = rng.uniform(-2, 2, (37, in_dim))
    got = torch_fk.kan_layer_apply(
        to_torch(lp), torch.from_numpy(x), 5, backend="fused_dw",
        matmul_precision=precision,
    )
    want = jax_fk.kan_layer_apply(
        to_jax(lp), jnp.asarray(x), 5, backend="fused_dw",
        matmul_precision=precision,
    )
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    # and the port's two backends agree at f32
    xla = torch_fk.kan_layer_apply(to_torch(lp), torch.from_numpy(x), 5)
    np.testing.assert_allclose(got.numpy(), xla.numpy(), **F32)


def test_fused_dw_bf16_compute_dtype_matches_jax():
    rng = np.random.default_rng(11)
    lp = random_layer(rng, 23, 7, 4, 5)
    x = rng.uniform(-2, 2, (37, 23))
    got = torch_fk.kan_layer_apply(
        to_torch(lp), torch.from_numpy(x), 5, backend="fused_dw",
        compute_dtype=torch.bfloat16,
    ).numpy()
    want = np.asarray(jax_fk.kan_layer_apply(
        to_jax(lp), jnp.asarray(x), 5, backend="fused_dw",
        compute_dtype=jnp.bfloat16,
    ))
    assert got.dtype == np.float32
    bar = 1e-4 * np.abs(want).max() + 1e-5
    assert np.abs(got - want).max() <= bar
    f32 = torch_fk.kan_layer_apply(
        to_torch(lp), torch.from_numpy(x), 5, backend="fused_dw"
    ).numpy()
    assert np.abs(got - f32).max() > bar


@pytest.mark.parametrize("backend", ["xla", "fused_dw", "fused"])
def test_kan_apply_matches_jax(backend):
    rng = np.random.default_rng(21)
    shape, t_dim, d = [12, 6, 5, 3], 3, 4
    params = random_network(rng, shape, t_dim, d)
    x = rng.uniform(-1, 1, (29, shape[0]))
    got = torch_fk.kan_apply(
        params_from_numpy(params, "cpu"), torch.from_numpy(x), d,
        backend=backend,
    )
    want = np.asarray(jax_fk.kan_apply(
        [to_jax(lp) for lp in params], jnp.asarray(x), d, backend=backend
    ))
    assert got.shape == (29, t_dim)
    tol = dict(rtol=1e-10, atol=1e-10) if backend == "xla" else F32
    np.testing.assert_allclose(got.numpy(), want, **tol)


def test_backend_and_dtype_errors():
    rng = np.random.default_rng(0)
    lp = to_torch(random_layer(rng, 4, 3, 2, 2))
    x = torch.zeros((5, 4), dtype=torch.float64)
    for typo in ("fuse", "fused-dw", "XLA"):
        with pytest.raises(ValueError, match="backend"):
            torch_fk.kan_layer_apply(lp, x, 2, backend=typo)
    # backend='fused' runs (the v1 pair) and matches the JAX package
    xr = torch.from_numpy(rng.uniform(-2, 2, (5, 4)))
    got = torch_fk.kan_layer_apply(lp, xr, 2, backend="fused")
    want = jax_fk.kan_layer_apply(
        {k: jnp.asarray(v.numpy()) for k, v in lp.items()},
        jnp.asarray(xr.numpy()), 2, backend="fused",
    )
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    for cd in ("int8", "int8x2", "int8x2w", torch.int8):
        with pytest.raises(NotImplementedError, match="qkan_layer"):
            torch_fk.kan_layer_apply(lp, x, 2, compute_dtype=cd)
        # as in the JAX package: the fused backends have no int8 path
        for backend in ("fused_dw", "fused"):
            with pytest.raises(ValueError, match="int8"):
                torch_fk.kan_layer_apply(lp, x, 2, compute_dtype=cd,
                                         backend=backend)
    with pytest.raises(ValueError, match="matmul_precision"):
        torch_fk.kan_layer_apply(lp, x, 2, matmul_precision="fastest")
    with pytest.raises(ValueError, match="compute_dtype"):
        torch_fk.kan_layer_apply(lp, x, 2, compute_dtype="float8")


def test_forward_precision_policy_matches_jax():
    assert (torch_fk._FORWARD_PRECISION_MIN_FANIN
            == jax_fk._FORWARD_PRECISION_MIN_FANIN == 512)
    for fan_in in (511, 512, 4704):
        for prec in ("auto", None, "high", "bf16x2_x"):
            assert torch_fk._resolve_forward_precision(prec, fan_in) == (
                jax_fk._resolve_forward_precision(prec, fan_in)
            )
    assert torch_fk._resolve_forward_precision("auto", 511) is None
    assert torch_fk._resolve_forward_precision("auto", 512) == "high"


def test_config_and_presets_match_jax():
    assert torch_fk.FixedKANConfig.PRESETS == jax_fk.FixedKANConfig.PRESETS
    assert (torch_fk.FixedKANConfig.TRAIN_PRESETS
            == jax_fk.FixedKANConfig.TRAIN_PRESETS)
    fields = [(f.name, f.default) for f in
              dataclasses.fields(torch_fk.FixedKANConfig)]
    assert fields == [(f.name, f.default) for f in
                      dataclasses.fields(jax_fk.FixedKANConfig)]
    for name in ("reference", "recommended"):
        a = torch_fk.FixedKANConfig.preset(name, [5, 3, 2], 4,
                                           layer_backend="fused_dw")
        b = jax_fk.FixedKANConfig.preset(name, [5, 3, 2], 4,
                                         layer_backend="fused_dw")
        # checkpoints carry this JSON: it must be byte-identical
        assert (json.dumps(dataclasses.asdict(a))
                == json.dumps(dataclasses.asdict(b)))
    with pytest.raises(ValueError, match="Unknown preset"):
        torch_fk.FixedKANConfig.preset("fast", [2, 1], 1)


@pytest.mark.parametrize("backend", ["xla", "fused_dw", "fused"])
def test_fixed_kan_module_matches_jax_model(backend):
    rng = np.random.default_rng(5)
    shape, d = [8, 4, 3], 3
    params = random_network(rng, shape, 2, d)
    cfg_kwargs = dict(network_shape=shape, max_degree=d,
                      layer_backend=backend)
    jkan = jax_fk.FixedKAN(jax_fk.FixedKANConfig(**cfg_kwargs))
    jkan.params = [to_jax(lp) for lp in params]
    tkan = torch_fk.FixedKAN(torch_fk.FixedKANConfig(**cfg_kwargs),
                             device="cpu")
    with pytest.raises(RuntimeError, match="Run optimization"):
        tkan(np.zeros((1, 8)))
    tkan.params = params_from_numpy(params, "cpu")
    assert sorted(tkan.state_dict()) == sorted(
        f"layer{i}_{k}" for i in range(2)
        for k in ("degrees", "coefficients", "horizontal_weights")
    )
    x = rng.uniform(-1, 1, (16, 8))
    tol = dict(rtol=1e-10, atol=1e-10) if backend == "xla" else F32
    np.testing.assert_allclose(tkan(x).numpy(), np.asarray(jkan(x)), **tol)
    tkan.params = None
    assert tkan.params is None and not list(tkan.buffers())


def test_device_is_explicit():
    cfg = torch_fk.FixedKANConfig(network_shape=[2, 1], max_degree=1)
    # no device means the card: without one it raises, never runs on CPU
    if torch.cuda.is_available():
        assert torch_fk.FixedKAN(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="is_available"):
            torch_fk.FixedKAN(cfg)
    assert torch_fk.FixedKAN(cfg, device="cpu").device == torch.device("cpu")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            resolve_device("cuda")
        with pytest.raises(RuntimeError, match="is_available"):
            torch_fk.FixedKAN(cfg, device="cuda")
