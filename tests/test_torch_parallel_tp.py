"""Tensor-parallel FixedKAN of the torch port (``parallel/tp.py``) against
the JAX package's ``parallel/tp.py``, on the CPU, on the same numpy
inputs.

The JAX side runs on the 8 virtual CPU devices of ``tests/conftest.py``
in x64; the port on ``Mesh(["cpu"] * 8, ("dp", "tp"), (2, 4))`` or an
8-slot ``tp`` mesh in float64 (torch's default dtype is set here).  The
cases mirror ``tests/test_parallel_tp.py`` at its bars: forwards within
atol 1e-10, the loss of a step within 1e-12, updated parameters within
1e-10.  The JAX results are computed once per case (module-scope cache).

The JAX test of the precision policy reads the lowered HLO; the port has
no HLO, so its counterpart records the ``matmul_precision`` each layer
hands ``kan_layer_apply``.
"""

import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from qkan_implementation_tpu.models.fixed_kan import kan_apply as jkan_apply
from qkan_implementation_tpu.parallel import tp as jtp
from qkan_implementation_tpu_torch.models.fixed_kan import kan_apply
from qkan_implementation_tpu_torch.parallel import (
    Mesh,
    Shards,
    gather_shards,
    kan_apply_tp,
    make_tp_train_step,
    shard_params,
)
from qkan_implementation_tpu_torch.parallel import tp
from qkan_implementation_tpu_torch.utils.convert import params_from_numpy

MAX_DEGREE = 3
FWD = 1e-10
LOSS = 1e-12
PARAM = 1e-10


@pytest.fixture(autouse=True)
def x64():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


def np_params(seed, in_dim, outs, target_dim, dtype=np.float64):
    rng = np.random.default_rng(seed)
    params, cur = [], in_dim
    for out in outs:
        params.append({
            "degrees": rng.integers(0, MAX_DEGREE + 1, out).astype(np.int32),
            "coefficients": (rng.normal(
                size=(out, cur, MAX_DEGREE + 1, target_dim)) * 0.3
            ).astype(dtype),
            "horizontal_weights": (rng.normal(size=out) + 1.0).astype(dtype),
        })
        cur = target_dim
    return params


def jparams(p):
    return [{k: jnp.asarray(v) for k, v in lp.items()} for lp in p]


def tparams(p):
    return params_from_numpy(p, "cpu")


@functools.lru_cache(maxsize=None)
def jmesh(kind):
    devs = np.array(jax.devices()[:8])
    if kind == "2d":
        return JMesh(devs.reshape(2, 4), ("dp", "tp"))
    return JMesh(devs, ("tp",))


MESHES = {"2d": Mesh(["cpu"] * 8, ("dp", "tp"), (2, 4)),
          "1d": Mesh(["cpu"] * 8, ("tp",))}


def data(seed, b, in_dim, t_dim=4):
    rng = np.random.default_rng(seed)
    return rng.uniform(-2, 2, (b, in_dim)), rng.normal(size=(b, t_dim))


def close(got, want, bar):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=bar)


# (params seed, in, outs, target, x seed, rows, mesh, dp_axis)
FORWARD = {
    "chained_sharded": (0, 8, (6, 5), 4, 1, 8, "2d", "dp"),
    "replicated_then_sharded": (2, 6, (5, 7), 4, 3, 6, "2d", "dp"),
    "tp_only": (4, 16, (4,), 8, 5, 3, "1d", None),
}


@functools.lru_cache(maxsize=None)
def jax_forward(case):
    ps, ind, outs, t, xs, rows, mesh, dp = FORWARD[case]
    x = np.random.default_rng(xs).uniform(-2, 2, (rows, ind))
    p = np_params(ps, ind, outs, t)
    return np.asarray(jtp.kan_apply_tp(jparams(p), jnp.asarray(x),
                                       MAX_DEGREE, jmesh(mesh), dp_axis=dp))


@pytest.mark.parametrize("case", sorted(FORWARD))
def test_forward_equals_jax(case):
    ps, ind, outs, t, xs, rows, mesh, dp = FORWARD[case]
    x = torch.from_numpy(np.random.default_rng(xs).uniform(-2, 2,
                                                           (rows, ind)))
    p = tparams(np_params(ps, ind, outs, t))
    out = kan_apply_tp(p, x, MAX_DEGREE, MESHES[mesh], dp_axis=dp)
    close(out, jax_forward(case), FWD)
    # and the single-slot forward of the port
    close(out, kan_apply(p, x, MAX_DEGREE), FWD)
    # the same through shard_params' layout
    sp = shard_params(p, ind, MESHES[mesh], dp_axis=dp)
    close(kan_apply_tp(sp, x, MAX_DEGREE, MESHES[mesh], dp_axis=dp),
          jax_forward(case), FWD)


def test_shard_params_layout():
    mesh = MESHES["2d"]
    p = tparams(np_params(6, 8, (6, 5), 4))
    sharded = shard_params(p, 8, mesh, dp_axis="dp")
    c0 = sharded[0]["coefficients"]
    assert isinstance(c0, Shards) and c0.dim == 1
    # in axis (8) split over tp=4: each master shard carries 2 features,
    # its own buffer of exactly a quarter of the layer's bytes, on its tp
    # slot; replicated leaves stay whole on slot 0
    assert {tuple(s.shape) for s in c0.parts} == {(6, 2, MAX_DEGREE + 1, 4)}
    whole = p[0]["coefficients"]
    assert all(s.untyped_storage().nbytes() * 4
               == whole.numel() * whole.element_size() for s in c0.parts)
    assert [s.device for s in c0.parts] == list(mesh.axis_devices("tp"))
    assert isinstance(sharded[0]["horizontal_weights"], torch.Tensor)
    assert tuple(sharded[0]["horizontal_weights"].shape) == (6,)
    assert c0.shape == whole.shape
    # layer 1 (in = target 4) divides tp too
    assert isinstance(sharded[1]["coefficients"], Shards)
    back = gather_shards(sharded)
    for got, want in zip(back, p):
        for k in want:
            assert torch.equal(got[k], want[k]), k
    x = np.random.default_rng(7).uniform(-1, 1, (4, 8))
    want = np.asarray(jtp.kan_apply_tp(
        jtp.shard_params(jparams(np_params(6, 8, (6, 5), 4)), 8,
                         jmesh("2d"), dp_axis="dp"),
        jnp.asarray(x), MAX_DEGREE, jmesh("2d"), dp_axis="dp"))
    close(kan_apply_tp(sharded, torch.from_numpy(x), MAX_DEGREE, mesh,
                       dp_axis="dp"), want, FWD)


STEPS = {
    "chained_sharded": (8, 8, (6, 5), 9),
    "replicated_then_sharded": (14, 6, (5, 4), 15),
}


def split(p):
    return ([lp["degrees"] for lp in p],
            [{k: v for k, v in lp.items() if k != "degrees"} for lp in p])


@functools.lru_cache(maxsize=None)
def jax_step(case):
    ps, ind, outs, ds = STEPS[case]
    x, y = data(ds, 8, ind)
    degrees, train = split(jparams(np_params(ps, ind, outs, 4)))
    step = jtp.make_tp_train_step(jmesh("2d"), MAX_DEGREE, learning_rate=0.05)
    new, loss = step(train, degrees, jnp.asarray(x), jnp.asarray(y))
    return [{k: np.asarray(v) for k, v in lp.items()} for lp in new], \
        float(loss)


@pytest.mark.parametrize("layout", ["global", "shard_params"])
@pytest.mark.parametrize("case", sorted(STEPS))
def test_train_step_equals_jax(case, layout):
    """Gradients through the psum / psum-scatter chain and through the
    replicated-output -> sharded-layer slice: autograd over the master
    copies must give the JAX transpose's psums, no more (module
    docstring: hand-inserted psums double count)."""
    ps, ind, outs, ds = STEPS[case]
    x, y = data(ds, 8, ind)
    p = tparams(np_params(ps, ind, outs, 4))
    if layout == "shard_params":
        p = shard_params(p, ind, MESHES["2d"])
    degrees, train = split(p)
    step = make_tp_train_step(MESHES["2d"], MAX_DEGREE, learning_rate=0.05)
    new, loss = step(train, degrees, torch.from_numpy(x),
                     torch.from_numpy(y))
    want, want_loss = jax_step(case)
    assert abs(float(loss) - want_loss) <= LOSS
    # the layout is kept: a sharded leaf comes back as Shards on its slots
    for got_lp, in_lp in zip(new, train):
        for k in in_lp:
            assert isinstance(got_lp[k], Shards) == isinstance(in_lp[k],
                                                               Shards)
    for got, w in zip(gather_shards(new), want):
        for k in w:
            close(got[k], w[k], PARAM)


def test_train_step_descends_as_jax():
    x, y = data(11, 16, 8)
    p_np = np_params(10, 8, (4,), 4)
    jdeg, jtrain = split(jparams(p_np))
    jstep = jtp.make_tp_train_step(jmesh("2d"), MAX_DEGREE,
                                   learning_rate=0.05)
    degrees, train = split(tparams(p_np))
    step = make_tp_train_step(MESHES["2d"], MAX_DEGREE, learning_rate=0.05)
    losses = []
    for _ in range(5):
        jtrain, jl = jstep(jtrain, jdeg, jnp.asarray(x), jnp.asarray(y))
        train, loss = step(train, degrees, torch.from_numpy(x),
                           torch.from_numpy(y))
        assert abs(float(loss) - float(jl)) <= LOSS
        losses.append(float(loss))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    for got, want in zip(train, jtrain):
        for k in want:
            close(got[k], want[k], PARAM)


def test_errors():
    mesh = MESHES["2d"]
    p = tparams(np_params(12, 8, (4,), 4))
    with pytest.raises(ValueError, match="not divisible"):
        kan_apply_tp(p, torch.ones(5, 8), MAX_DEGREE, mesh, dp_axis="dp")
    with pytest.raises(ValueError, match="no model axis"):
        kan_apply_tp(p, torch.ones(4, 8), MAX_DEGREE, mesh, tp_axis="model")
    with pytest.raises(ValueError, match="no dp axis"):
        kan_apply_tp(p, torch.ones(4, 8), MAX_DEGREE, MESHES["1d"],
                     dp_axis="dp")
    with pytest.raises(ValueError, match="unused mesh axes"):
        kan_apply_tp(p, torch.ones(4, 8), MAX_DEGREE, mesh, dp_axis=None)
    with pytest.raises(ValueError, match="in_dim=8"):
        kan_apply_tp(p, torch.ones(4, 6), MAX_DEGREE, mesh)
    # same guard as FixedKAN.train: int8 rounding has zero gradient
    for cd in ("int8", "int8x2", torch.int8):
        with pytest.raises(ValueError, match="int8"):
            make_tp_train_step(mesh, MAX_DEGREE, compute_dtype=cd)


def f32(p):
    return [{k: v if k == "degrees" else v.astype(np.float32)
             for k, v in lp.items()} for lp in p]


def test_forward_precision_policy_uses_global_fanin(monkeypatch):
    """in=128, D+1=4: global fan-in 512 (>= the policy's threshold), local
    64 on 8 tp slots.  'auto' must pin 'high' on every slot's product,
    and an explicit None must not."""
    seen = []
    real = tp.fixed_kan.kan_layer_apply

    def spy(lp, x, max_degree, compute_dtype=None, backend="xla",
            matmul_precision="auto"):
        seen.append((lp["coefficients"].shape[1], matmul_precision))
        return real(lp, x, max_degree, compute_dtype, backend,
                    matmul_precision)

    monkeypatch.setattr(tp.fixed_kan, "kan_layer_apply", spy)
    p = tparams(f32(np_params(7, 128, (4,), 3)))
    x = torch.from_numpy(np.random.default_rng(8).uniform(-1, 1, (16, 128))
                         .astype(np.float32))
    out = kan_apply_tp(p, x, MAX_DEGREE, MESHES["1d"])
    assert seen == [(16, "high")] * 8
    seen.clear()
    kan_apply_tp(p, x, MAX_DEGREE, MESHES["1d"], matmul_precision=None)
    assert seen == [(16, None)] * 8
    want = np.asarray(jtp.kan_apply_tp(
        jparams(f32(np_params(7, 128, (4,), 3))), jnp.asarray(x.numpy()),
        MAX_DEGREE, jmesh("1d")))
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-5)


def test_int8_tp_warns_on_global_fanin():
    x = torch.from_numpy(np.random.default_rng(8).uniform(-1, 1, (16, 128))
                         .astype(np.float32))
    p = tparams(f32(np_params(7, 128, (4,), 3)))  # global fan-in 512
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        kan_apply_tp(p, x, MAX_DEGREE, MESHES["1d"], compute_dtype=torch.int8)
    assert any("GLOBAL fan-in 512" in str(m.message) for m in w)
    # narrow global fan-in: quiet
    x_n = torch.from_numpy(np.random.default_rng(10).uniform(
        -1, 1, (16, 32)).astype(np.float32))
    p_n = tparams(f32(np_params(9, 32, (4,), 3)))  # global fan-in 128
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        kan_apply_tp(p_n, x_n, MAX_DEGREE, MESHES["1d"], compute_dtype="int8")
    assert not any("int8 tp serving" in str(m.message) for m in w)
