"""``FixedKAN.train(mesh=)``, ``FixedKAN.optimize(mesh=)`` and the mesh
samplers of the torch port against the JAX package, on the CPU.

The JAX side runs on the 8 virtual CPU devices of ``tests/conftest.py``;
the port on 8 CPU slots (``make_mesh(8, devices=["cpu"] * 8)``,
``Mesh(["cpu"] * 8, ("dp", "tp"), (2, 4))``).  Each training run starts
both packages from the JAX package's searched parameters, carried across
as numpy.

Bars, those of ``tests/test_models_fixed_kan.py``'s mesh cases:
- ``train(mesh=)``, float32 as there: losses rtol 1e-5, coefficients
  and horizontal weights atol 1e-6, against the JAX package's
  ``train(mesh=)`` and against the port's single-slot ``train`` (pure dp
  and (dp, tp); measured <= 4.5e-7 and 6e-8).  In float64 (the same runs
  on float64 data): rtol 1e-12 and atol 1e-12 (measured <= 3.6e-16
  relative and 5.6e-17 absolute: only the order of the slots' sums
  differs).
- ``optimize(mesh=)``, float32: degrees equal; coefficients within
  rtol 5e-2, atol 2e-2 and forwards within atol 5e-3 (the sharded Gram
  sum reorders an f32 reduction that the ridge solve amplifies by about
  1/ridge, and the layers compound it: that test's comment; measured
  2e-3 of max|c|).  float64: coefficients and forwards within 1e-7 of
  max|.|: the same amplification, eps_f64 / ridge (1e-8) ~ 2e-8
  (measured 1.3e-9 to 9.6e-9 against the single-slot search, 1.7e-8
  against the JAX package's sharded one), five orders inside the f32
  bars.
- the mesh samplers: the brute-force optimum on the JAX tests' QUBOs,
  R' = ceil(R / n) n rows, energies within 1e-3 of ``model.energy`` of
  the samples (float32 sweeps), and the JAX errors.  Their streams differ
  from JAX's, so samples are not compared.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from qkan_implementation_tpu.models import fixed_kan as jfk
from qkan_implementation_tpu_torch.anneal import (
    QuboModel,
    degree_selection_qubo,
    parallel_tempering_mesh_ladder,
    parallel_tempering_sharded,
    polish_one_hot_blocks,
    simulated_annealing_sharded,
)
from qkan_implementation_tpu_torch import models as tmodels
from qkan_implementation_tpu_torch.models import FixedKAN
from qkan_implementation_tpu_torch.native_bindings import brute_force_native
from qkan_implementation_tpu_torch.parallel import Mesh, make_mesh
from qkan_implementation_tpu_torch.utils.convert import (
    params_from_numpy,
    params_to_numpy,
)

DP = make_mesh(8, axis_name="dp", devices=["cpu"] * 8)
DP_TP = Mesh(["cpu"] * 8, ("dp", "tp"), (2, 4))
D8 = make_mesh(8, axis_name="d", devices=["cpu"] * 8)
BARS = {  # (loss rtol, coefficient atol)
    "float32": (1e-5, 1e-6),
    "float64": (1e-12, 1e-12),
}


@pytest.fixture(autouse=True)
def x64():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


@functools.lru_cache(maxsize=None)
def jmesh(kind):
    devs = np.array(jax.devices()[:8])
    if kind == "dp_tp":
        return JMesh(devs.reshape(2, 4), ("dp", "tp"))
    return JMesh(devs, ("dp",))


# (data seed, rows, in, hidden, epochs, batch)
TRAIN = {"dp": (5, 256, 6, 5, 3, 64), "dp_tp": (6, 128, 8, 5, 2, 32)}


def train_data(kind, dtype):
    seed, rows, ind, _, _, _ = TRAIN[kind]
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, 2, (rows, ind)).astype(np.float32)
    y = np.tanh(x @ rng.normal(0, 0.5, (ind, 2)).astype(np.float32))
    return x.astype(dtype), y.astype(dtype)


def train_cfg(kind, module):
    _, _, ind, hidden, _, _ = TRAIN[kind]
    return module.FixedKANConfig(
        network_shape=[ind, hidden, 2], max_degree=3,
        degree_objective="penalized_mse", complexity_weight=1e-3,
    )


def train_kw(kind, loss):
    _, _, _, _, epochs, batch = TRAIN[kind]
    return dict(epochs=epochs, batch_size=batch, learning_rate=2e-3,
                loss=loss, trainable="all", seed=7)


def targets(y, loss):
    return y if loss == "mse" else np.zeros(y.shape[0], dtype=y.dtype)


@functools.lru_cache(maxsize=None)
def jax_train(kind, dtype, loss):
    """(start params, losses, trained params) of the JAX package's
    train(mesh=), numpy."""
    x, y = train_data(kind, dtype)
    kan = jfk.FixedKAN(train_cfg(kind, jfk))
    kan.optimize(jnp.asarray(x), jnp.asarray(y), solver="exact")
    start = [{k: np.asarray(v) for k, v in lp.items()} for lp in kan.params]
    losses = kan.train(jnp.asarray(x), jnp.asarray(targets(y, loss)),
                       mesh=jmesh(kind), **train_kw(kind, loss))
    return start, np.asarray(losses), [
        {k: np.asarray(v) for k, v in lp.items()} for lp in kan.params]


def port_train(kind, dtype, loss, **kw):
    x, y = train_data(kind, dtype)
    start, _, _ = jax_train(kind, dtype, loss)
    kan = FixedKAN(train_cfg(kind, tmodels), device="cpu")
    kan.params = params_from_numpy(start, "cpu")
    losses = kan.train(x, targets(y, loss), **train_kw(kind, loss), **kw)
    return np.asarray(losses), params_to_numpy(kan.params)


def held(got, want, bars):
    (gl, gp), (wl, wp) = got, want
    rtol, atol = bars
    np.testing.assert_allclose(gl, wl, rtol=rtol)
    for a, b in zip(gp, wp):
        for k in ("coefficients", "horizontal_weights"):
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=atol)
        np.testing.assert_array_equal(a["degrees"], b["degrees"])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_train_data_parallel_equals_jax(dtype):
    got = port_train("dp", dtype, "mse", mesh=DP)
    _, jl, jp = jax_train("dp", dtype, "mse")
    held(got, (jl, jp), BARS[dtype])
    held(got, port_train("dp", dtype, "mse"), BARS[dtype])


@pytest.mark.parametrize("loss", ["mse", "cross_entropy"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_train_tensor_parallel_equals_jax(dtype, loss):
    # in = 8 divides tp = 4; the hidden in = target 2 does not: mixed
    # sharded / replicated layers exercise the static flag rule
    got = port_train("dp_tp", dtype, loss, mesh=DP_TP)
    _, jl, jp = jax_train("dp_tp", dtype, loss)
    held(got, (jl, jp), BARS[dtype])
    held(got, port_train("dp_tp", dtype, loss), BARS[dtype])


def test_train_tensor_axis_choice_and_errors():
    x, y = train_data("dp_tp", "float32")
    single = port_train("dp_tp", "float32", "mse")
    for kw in ({"tensor_axis": None}, {"tensor_axis": "tp"}):
        held(port_train("dp_tp", "float32", "mse", mesh=DP_TP, **kw),
             single, BARS["float32"])
    kan = FixedKAN(train_cfg("dp_tp", tmodels), device="cpu")
    kan.optimize(x, y, solver="exact")
    cases = [
        ({"mesh": DP_TP, "tensor_axis": "model"}, "no tensor axis"),
        ({"mesh": Mesh(["cpu"] * 4, ("tp",))}, "ambiguous"),
        ({"mesh": DP_TP, "mesh_axis": "tp"}, "tensor-parallel axis"),
        ({"mesh": DP, "batch_size": 63}, "divisible"),
        ({"mesh": make_mesh(3, devices=["cpu"] * 3)}, "divisible"),
        ({"mesh": DP, "backend": "fused"}, "shard_map"),
        ({"mesh": DP, "backend": "fused_dw"}, "shard_map"),
    ]
    for kw, match in cases:
        with pytest.raises(ValueError, match=match):
            kan.train(x, y, **{"epochs": 1, "loss": "mse", **kw})


def test_train_mesh_keeps_divergence_restore():
    """A run that diverges on the mesh restores the last finite epoch's
    parameters, as the single-slot run does."""
    x, y = train_data("dp", "float64")
    start, _, _ = jax_train("dp", "float64", "mse")
    runs = {}
    for name, kw in (("single", {}), ("dp", {"mesh": DP})):
        kan = FixedKAN(train_cfg("dp", tmodels), device="cpu")
        kan.params = params_from_numpy(start, "cpu")
        losses = kan.train(x, y, epochs=3, batch_size=64,
                           learning_rate=1e12, loss="mse", **kw)
        runs[name] = (losses, kan.last_train_diverged,
                      params_to_numpy(kan.params))
    assert runs["dp"][1] == runs["single"][1]
    assert len(runs["dp"][0]) == len(runs["single"][0])
    for a, b in zip(runs["dp"][2], runs["single"][2]):
        assert np.all(np.isfinite(a["coefficients"]))
        np.testing.assert_allclose(a["coefficients"], b["coefficients"],
                                   rtol=1e-9, atol=1e-9)


# -- optimize(mesh=) -------------------------------------------------------

SEARCH_BARS = {  # (coefficient rtol, atol, forward atol)
    "float32": (5e-2, 2e-2, 5e-3),
    "float64": (0.0, 1e-7, 1e-7),
}


def search_data(dtype):
    rng = np.random.default_rng(11)
    x = rng.uniform(-2, 2, (512, 6)).astype(np.float32)
    y = np.stack([np.sin(x.sum(1)), (x**2).mean(1)], 1).astype(np.float32)
    return x.astype(dtype), y.astype(dtype)


def search_cfg(module):
    return module.FixedKANConfig(
        network_shape=[6, 4, 2], max_degree=4, lstsq_method="normal",
        degree_objective="penalized_mse", complexity_weight=1e-3,
        consistent_tanh=True,
    )


SEARCH_KW = dict(num_reads=64, num_sweeps=200, seed=3)


@functools.lru_cache(maxsize=None)
def jax_search(dtype):
    x, y = search_data(dtype)
    kan = jfk.FixedKAN(search_cfg(jfk))
    kan.optimize(jnp.asarray(x), jnp.asarray(y), mesh=jmesh("dp"),
                 **SEARCH_KW)
    return [{k: np.asarray(v) for k, v in lp.items()} for lp in kan.params]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_optimize_data_parallel_equals_jax(dtype):
    x, y = search_data(dtype)
    kans = {}
    for name, kw in (("single", {}), ("dp", {"mesh": DP}),
                     ("dp_exact", {"mesh": DP, "solver": "exact"})):
        kans[name] = FixedKAN(search_cfg(tmodels), device="cpu")
        kans[name].optimize(x, y, **{**SEARCH_KW, **kw})
    stats = kans["dp"].last_search_stats
    assert [s["slots"] for s in stats] == [8, 8]
    assert [s["route"] for s in stats] == ["gram", "gram"]
    # a Gram partial a slot, each on its slot
    assert len(stats[0]["sweeps"][0]["devices"]) == 16
    rtol, atol, fwd = SEARCH_BARS[dtype]
    want = {"jax_dp": jax_search(dtype),
            "single": params_to_numpy(kans["single"].params),
            "dp_exact": params_to_numpy(kans["dp_exact"].params)}
    got = params_to_numpy(kans["dp"].params)
    for name, ref in want.items():
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a["degrees"], b["degrees"],
                                          err_msg=name)
            scale = 1.0 if dtype == "float32" else np.abs(
                b["coefficients"]).max()
            np.testing.assert_allclose(a["coefficients"],
                                       b["coefficients"], rtol=rtol,
                                       atol=atol * scale, err_msg=name)
    out = kans["dp"](x).numpy()
    ref = kans["single"](x).numpy()
    scale = 1.0 if dtype == "float32" else np.abs(ref).max()
    np.testing.assert_allclose(out, ref, rtol=0, atol=fwd * scale)


def test_optimize_mesh_rows_not_dividing_warn():
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (101, 4))  # 101 % 8 != 0
    y = np.sin(x.sum(1, keepdims=True))
    kan = FixedKAN(tmodels.FixedKANConfig(network_shape=[4, 1], max_degree=3),
                   device="cpu")
    with pytest.warns(UserWarning, match="unsharded"):
        kan.optimize(x, y, solver="exact", mesh=DP)
    assert kan.last_search_stats[0]["slots"] == 1
    ref = FixedKAN(tmodels.FixedKANConfig(network_shape=[4, 1], max_degree=3),
                   device="cpu")
    ref.optimize(x, y, solver="exact")
    for a, b in zip(kan.params, ref.params):
        assert torch.equal(a["coefficients"], b["coefficients"])


# -- the mesh samplers (tests/test_anneal.py:315-440) -----------------------


def dense(seed, n=16, offset=0.0):
    rng = np.random.default_rng(seed)
    J = rng.normal(0, 1, (n, n))
    J = J + J.T
    np.fill_diagonal(J, 0.0)
    return QuboModel(h=rng.normal(0, 1, n), J=J, offset=offset)


def test_parallel_tempering_sharded_reaches_ground():
    model = dense(5)
    samples, energies = parallel_tempering_sharded(
        model, D8, num_chains=16, num_replicas=4, num_sweeps=150, seed=0)
    assert samples.shape == (16 * 4, 16)  # ceil(16/8)*8 chains x 4
    np.testing.assert_allclose(energies, model.energy(samples), atol=1e-3)
    assert energies.min() <= brute_force_native(model)[1] + 1e-3
    # odd chain counts round up to the slots
    samples, _ = parallel_tempering_sharded(
        model, D8, num_chains=9, num_replicas=2, num_sweeps=5, seed=1)
    assert samples.shape == (16 * 2, 16)


def test_parallel_tempering_mesh_ladder_reaches_ground():
    """One global ladder split over 8 slots, boundary replicas exchanging
    through ppermute: the optimum of a dense frustrated instance, and
    energies consistent with the samples (offset included)."""
    model = dense(13, offset=0.25)
    samples, energies = parallel_tempering_mesh_ladder(
        model, D8, num_chains=8, num_replicas=16, num_sweeps=200, seed=0)
    assert samples.shape == (8 * 16, 16)
    np.testing.assert_allclose(energies, model.energy(samples), atol=1e-3)
    assert energies.min() <= brute_force_native(model)[1] + 1e-4
    # one replica a slot: every exchange crosses a boundary
    samples, energies = parallel_tempering_mesh_ladder(
        model, D8, num_chains=4, num_replicas=8, num_sweeps=100, seed=2)
    assert samples.shape == (4 * 8, 16)
    np.testing.assert_allclose(energies, model.energy(samples), atol=1e-3)


def test_mesh_ladder_and_axes_errors():
    model = QuboModel(h=np.zeros(4), J=np.zeros((4, 4)), offset=0.0)
    with pytest.raises(ValueError, match="must divide"):
        parallel_tempering_mesh_ladder(model, D8, num_replicas=12)
    for fn in (simulated_annealing_sharded, parallel_tempering_sharded,
               parallel_tempering_mesh_ladder):
        with pytest.raises(ValueError, match="not in mesh axes"):
            fn(model, D8, axis_name="x")


def test_sharded_annealing_multi_axis_mesh():
    """Chains split over the named axis alone (size 4 of a 2 x 4 mesh),
    not over the product of all axes: 16 reads give 16 rows."""
    mesh = Mesh(["cpu"] * 8, ("x", "y"), (2, 4))
    scores = np.array([0.8, 0.35, 0.3, 0.29])
    model = degree_selection_qubo(scores, num_functions=2,
                                  complexity_weight=0.1)
    samples, energies = simulated_annealing_sharded(
        model, mesh, axis_name="y", num_reads=16, num_sweeps=100, seed=0)
    assert samples.shape == (16, 8)
    np.testing.assert_allclose(energies, model.energy(samples), atol=1e-4)
    # R' = ceil(10 / 4) * 4; the polished best is the blockwise optimum
    samples, _ = simulated_annealing_sharded(
        model, mesh, axis_name="y", num_reads=10, num_sweeps=50, seed=1)
    assert samples.shape == (12, 8)
    polished = polish_one_hot_blocks(model, samples, 4)
    exact = np.zeros(8)
    exact[int(np.argmin(model.h[:4]))::4] = 1.0
    assert float(np.min(model.energy(polished))) == pytest.approx(
        float(model.energy(exact)), abs=1e-12)
