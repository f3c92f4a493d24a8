"""Pipeline-parallel FixedKAN of the torch port (``parallel/pp.py``)
against the JAX package's ``parallel/pp.py``, on the CPU, on the same
numpy inputs.

The JAX side runs on the virtual CPU devices of ``tests/conftest.py`` in
x64; the port on ``Mesh(["cpu"] * 4, ("pp",))`` and ``Mesh(["cpu"] * 8,
("dp", "pp"), (2, 4))`` in float64 (torch's default dtype is set here).
The cases mirror ``tests/test_parallel_pp.py`` at its bars: forwards
within atol 1e-10, the loss of a step within 1e-12, updated parameters
within 1e-10, padded neurons' weights exactly zero.  The JAX results are
computed once per case (module-scope cache).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from qkan_implementation_tpu.parallel import pp as jpp
from qkan_implementation_tpu_torch.models.fixed_kan import kan_apply
from qkan_implementation_tpu_torch.parallel import (
    Mesh,
    Shards,
    gather_shards,
    kan_apply_pp,
    make_pp_train_step,
    place_pipeline_params,
    stack_pipeline_params,
)
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


def np_params(seed, in_dim, outs, target_dim):
    rng = np.random.default_rng(seed)
    params, cur = [], in_dim
    for out in outs:
        params.append({
            "degrees": rng.integers(0, MAX_DEGREE + 1, out).astype(np.int32),
            "coefficients": rng.normal(
                size=(out, cur, MAX_DEGREE + 1, target_dim)) * 0.3,
            "horizontal_weights": rng.normal(size=out) + 1.0,
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
    if kind == "dp_pp":
        return JMesh(devs.reshape(2, 4), ("dp", "pp"))
    return JMesh(devs[:4], ("pp",))


MESHES = {"pp4": Mesh(["cpu"] * 4, ("pp",)),
          "dp_pp": Mesh(["cpu"] * 8, ("dp", "pp"), (2, 4))}


def close(got, want, bar):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=bar)


# (params seed, in, outs, x seed, rows, mesh, microbatches)
FORWARD = {
    "lead_mb1": (0, 7, (6, 5, 3, 4, 6), 1, 8, "pp4", 1),
    "lead_mb2": (0, 7, (6, 5, 3, 4, 6), 1, 8, "pp4", 2),
    "lead_mb4": (0, 7, (6, 5, 3, 4, 6), 1, 8, "pp4", 4),
    "no_lead_two_layers_per_stage": (2, 4, (5, 3, 6, 4, 5, 3, 4, 6), 3, 6,
                                     "pp4", 3),
    "dp_composed": (4, 7, (6, 5, 3, 4, 6), 5, 8, "dp_pp", 2),
}


@functools.lru_cache(maxsize=None)
def jax_forward(case):
    ps, ind, outs, xs, rows, mesh, mb = FORWARD[case]
    x = np.random.default_rng(xs).uniform(-2, 2, (rows, ind))
    return np.asarray(jpp.kan_apply_pp(
        jparams(np_params(ps, ind, outs, 4)), jnp.asarray(x), MAX_DEGREE,
        jmesh(mesh), microbatches=mb))


@pytest.mark.parametrize("case", sorted(FORWARD))
def test_forward_equals_jax(case):
    ps, ind, outs, xs, rows, mesh, mb = FORWARD[case]
    x = torch.from_numpy(np.random.default_rng(xs).uniform(-2, 2,
                                                           (rows, ind)))
    p = tparams(np_params(ps, ind, outs, 4))
    out = kan_apply_pp(p, x, MAX_DEGREE, MESHES[mesh], microbatches=mb)
    close(out, jax_forward(case), FWD)
    close(out, kan_apply(p, x, MAX_DEGREE), FWD)


def test_place_pipeline_params_layout():
    mesh = MESHES["pp4"]
    p_np = np_params(6, 7, (6, 5, 3, 4, 6), 4)
    lead, stacked = place_pipeline_params(tparams(p_np), mesh)
    assert lead is not None and set(lead) == {"degrees", "coefficients",
                                              "horizontal_weights"}
    c = stacked["coefficients"]
    # each stage holds ONE layer padded to max_out = 6, on its pp slot
    assert isinstance(c, Shards) and c.dim == 0
    assert {tuple(s.shape) for s in c.parts} == {(1, 1, 6, 4,
                                                  MAX_DEGREE + 1, 4)}
    assert [s.device for s in c.parts] == list(mesh.axis_devices("pp"))
    # the global stacked tensors equal the JAX package's stack
    jlead, jstacked = jpp.stack_pipeline_params(jparams(p_np), 4)
    for k, v in gather_shards(stacked).items():
        close(v, jstacked[k], 0.0)
    x = np.random.default_rng(7).uniform(-1, 1, (4, 7))
    out = kan_apply_pp((lead, stacked), torch.from_numpy(x), MAX_DEGREE,
                       mesh, microbatches=2)
    close(out, kan_apply(tparams(p_np), torch.from_numpy(x), MAX_DEGREE),
          FWD)
    close(out, np.asarray(jpp.kan_apply_pp(
        jpp.place_pipeline_params(jparams(p_np), jmesh("pp4")),
        jnp.asarray(x), MAX_DEGREE, jmesh("pp4"), microbatches=2)), FWD)
    _, plain = stack_pipeline_params(tparams(p_np), 4)
    with pytest.raises(ValueError, match="stages"):
        kan_apply_pp((lead, {k: v[:2] for k, v in plain.items()}),
                     torch.from_numpy(x), MAX_DEGREE, mesh)


@functools.lru_cache(maxsize=None)
def jax_step():
    p = jparams(np_params(8, 7, (6, 5, 3, 4, 5), 4))
    rng = np.random.default_rng(9)
    x, y = rng.uniform(-2, 2, (8, 7)), rng.normal(size=(8, 4))
    lead, stacked = jpp.stack_pipeline_params(p, 4)
    step = jpp.make_pp_train_step(jmesh("dp_pp"), MAX_DEGREE,
                                  learning_rate=0.05, microbatches=2)
    (new_lead, new_stacked), loss = step(
        {k: v for k, v in lead.items() if k != "degrees"}, lead["degrees"],
        {k: v for k, v in stacked.items() if k != "degrees"},
        stacked["degrees"], jnp.asarray(x), jnp.asarray(y))
    return ({k: np.asarray(v) for k, v in new_lead.items()},
            {k: np.asarray(v) for k, v in new_stacked.items()}, float(loss))


@pytest.mark.parametrize("layout", ["stacked", "placed"])
def test_train_step_equals_jax(layout):
    p_np = np_params(8, 7, (6, 5, 3, 4, 5), 4)
    rng = np.random.default_rng(9)
    x, y = rng.uniform(-2, 2, (8, 7)), rng.normal(size=(8, 4))
    place = (stack_pipeline_params if layout == "stacked" else
             lambda p, n: place_pipeline_params(p, MESHES["dp_pp"]))
    lead, stacked = place(tparams(p_np), 4)
    step = make_pp_train_step(MESHES["dp_pp"], MAX_DEGREE,
                              learning_rate=0.05, microbatches=2)
    (new_lead, new_stacked), loss = step(
        {k: v for k, v in lead.items() if k != "degrees"}, lead["degrees"],
        {k: v for k, v in stacked.items() if k != "degrees"},
        stacked["degrees"], torch.from_numpy(x), torch.from_numpy(y))
    want_lead, want_stacked, want_loss = jax_step()
    assert abs(float(loss) - want_loss) <= LOSS
    for k in want_lead:
        close(new_lead[k], want_lead[k], PARAM)
    assert all(isinstance(v, Shards) == (layout == "placed")
               for v in new_stacked.values())
    new_stacked = gather_shards(new_stacked)
    for k in want_stacked:
        close(new_stacked[k], want_stacked[k], PARAM)
    # padded rows stay exactly zero (hw = 0 kills their gradients)
    for s, out_dim in enumerate((5, 3, 4, 5)):
        pad = new_stacked["horizontal_weights"][s, 0, out_dim:]
        assert torch.equal(pad, torch.zeros_like(pad))


def test_train_step_descends_as_jax():
    p_np = np_params(10, 4, (4, 4, 4, 4), 4)
    rng = np.random.default_rng(11)
    x, y = rng.uniform(-2, 2, (8, 4)), rng.normal(size=(8, 4))
    _, jstacked = jpp.stack_pipeline_params(jparams(p_np), 4)
    jtrain = {k: v for k, v in jstacked.items() if k != "degrees"}
    jstep = jpp.make_pp_train_step(jmesh("pp4"), MAX_DEGREE,
                                   learning_rate=0.05, microbatches=2)
    _, stacked = stack_pipeline_params(tparams(p_np), 4)
    train = {k: v for k, v in stacked.items() if k != "degrees"}
    # defaults work on a 1-D pp mesh: dp_axis='auto' resolves to None
    step = make_pp_train_step(MESHES["pp4"], MAX_DEGREE, learning_rate=0.05,
                              microbatches=2)
    losses = []
    for _ in range(5):
        (_, jtrain), jl = jstep(None, None, jtrain, jstacked["degrees"],
                                jnp.asarray(x), jnp.asarray(y))
        (_, train), loss = step(None, None, train, stacked["degrees"],
                                torch.from_numpy(x), torch.from_numpy(y))
        assert abs(float(loss) - float(jl)) <= LOSS
        losses.append(float(loss))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    for k in jtrain:
        close(train[k], jtrain[k], PARAM)


def test_stack_errors():
    with pytest.raises(ValueError, match="do not split"):
        stack_pipeline_params(tparams(np_params(12, 7, (6, 5, 3), 4)), 4)
    bad = tparams(np_params(13, 4, (5, 3), 4))
    bad[1]["coefficients"] = torch.zeros((3, 5, MAX_DEGREE + 1, 4))
    with pytest.raises(ValueError, match="target_dim"):
        stack_pipeline_params(bad, 2)
    p = tparams(np_params(0, 7, (6, 5, 3, 4, 6), 4))
    with pytest.raises(ValueError, match="microbatches"):
        kan_apply_pp(p, torch.ones(6, 7), MAX_DEGREE, MESHES["pp4"],
                     microbatches=4)
    with pytest.raises(ValueError, match="not divisible"):
        kan_apply_pp(p, torch.ones(5, 7), MAX_DEGREE, MESHES["dp_pp"])


def test_train_step_rejects_int8():
    for cd in ("int8", torch.int8):
        with pytest.raises(ValueError, match="int8"):
            make_pp_train_step(MESHES["pp4"], MAX_DEGREE, compute_dtype=cd)
