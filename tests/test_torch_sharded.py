"""The torch port's mesh, collectives and sharded statevector engine
(``parallel/``, ``sim/sharded.py``) and the sharded quantum layer
(``ops/quantum.py``) against the JAX package on the CPU, on the same numpy
inputs.

The JAX side runs on the 8 virtual CPU devices of ``tests/conftest.py``;
the port on a mesh of 8 CPU slots (``make_mesh(8, devices=["cpu"] * 8)``).
The JAX suite runs x64, so torch's default dtype is float64 here, restored
after each test.

Bar: float64 within 1e-12 of max|reference| for states, the sharded
quantum layer and its gradients (JAX's own sharded-vs-dense tests hold
1e-12 on states); collectives and bookkeeping must agree exactly.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.sharding import PartitionSpec as P

from qkan_implementation_tpu.encoding import fable as jfable
from qkan_implementation_tpu.ops import quantum as jq
from qkan_implementation_tpu.parallel import collectives as jcoll
from qkan_implementation_tpu.parallel import make_mesh as jmake_mesh
from qkan_implementation_tpu.sim import Circuit as JCircuit
from qkan_implementation_tpu.sim import sharded as jsharded
from qkan_implementation_tpu_torch import parallel
from qkan_implementation_tpu_torch.encoding import fable
from qkan_implementation_tpu_torch.ops import quantum as q
from qkan_implementation_tpu_torch.parallel import collectives as coll
from qkan_implementation_tpu_torch.parallel import make_mesh, make_mesh_2d
from qkan_implementation_tpu_torch.sim import Circuit, simulate
from qkan_implementation_tpu_torch.sim import sharded
from qkan_implementation_tpu_torch.sim.sharded import (
    ShardedState,
    count_exchanges,
    shard_memory_report,
    sharded_simulate,
)

AXIS = "d"
NDEV = 8
BAR = 1e-12


@pytest.fixture(autouse=True)
def x64():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


@pytest.fixture(scope="module")
def jmesh():
    assert len(jax.devices()) >= NDEV, "conftest must provide 8 CPU devices"
    return jmake_mesh(NDEV, axis_name=AXIS)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(NDEV, axis_name=AXIS, devices=["cpu"] * NDEV)


def close(got, want, bar=BAR):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-300)
    err = float(np.abs(got - want).max())
    assert err <= bar * scale, (err, scale)


# -- circuits of tests/test_sim_sharded.py at 14-15 qubits ----------------------


def random15(cls):
    rng = np.random.default_rng(15)
    q = 15
    circ = cls(q)
    for t in range(q):
        circ.ry(float(rng.uniform(0, np.pi)), t)
    for _ in range(30):
        kind = rng.integers(0, 4)
        t = int(rng.integers(0, q))
        c = int((t + 1 + rng.integers(0, q - 1)) % q)
        if kind == 0:
            circ.h(t)
        elif kind == 1:
            circ.cx(c, t)
        elif kind == 2:
            circ.swap(c, t)
        else:
            circ.cry(float(rng.uniform(0, np.pi)), c, t)
    return circ


def chunked14(cls):
    rng = np.random.default_rng(18)
    q = 14
    circ = cls(q)
    for t in range(q):
        circ.ry(float(rng.uniform(0, np.pi)), t)
    circ.h(13).cx(13, 0).h(12).cx(12, 1).swap(11, 2)
    return circ


def global_ucry14(cls):
    """test_all_to_all_exchange_impl_matches_dense's exchange-heavy
    circuit (global H/CX and a full-register ucry on the top qubit),
    widened to 14 qubits, plus a diagonal on global qubits."""
    rng = np.random.default_rng(5)
    q = 14
    circ = cls(q)
    for t in range(q):
        circ.h(t)
    circ.cx(13, 2).ry(0.7, 12).cx(11, 0)
    circ.ucry(rng.uniform(-2, 2, 2 ** (q - 1)), tuple(range(q - 2, -1, -1)),
              q - 1)
    circ.h(13).swap(12, 1)
    circ.ucry(rng.uniform(-2, 2, 8), (13, 4, 12), 11)
    circ.diagonal(rng.uniform(0.5, 1.5, 8), (13, 12, 3))
    return circ


def fable15(cls):
    a = np.diag(np.random.default_rng(16).uniform(-1, 1, 128))
    return (jfable if cls is JCircuit else fable)(a)[0]


def fable_dense15(cls):
    a = np.random.default_rng(7).standard_normal((128, 128))
    a /= np.max(np.abs(a))
    return (jfable if cls is JCircuit else fable)(a)[0]


CIRCUITS = {f.__name__: f for f in
            (random15, chunked14, global_ucry14, fable15, fable_dense15)}
_JAX_STATES = {}


def _jax_state(name, jmesh):
    if name not in _JAX_STATES:
        _JAX_STATES[name] = np.asarray(jax.device_get(jsharded.sharded_simulate(
            CIRCUITS[name](JCircuit), jmesh, exchange_impl="collective")))
    return _JAX_STATES[name]


@pytest.mark.parametrize("chunks", [1, 4])
@pytest.mark.parametrize("impl", ["collective", "rdma", "all_to_all"])
@pytest.mark.parametrize("name", list(CIRCUITS))
def test_sharded_simulate_matches_jax_and_dense(jmesh, mesh, name, impl,
                                                chunks):
    circ = CIRCUITS[name](Circuit)
    got = sharded_simulate(circ, mesh, exchange_impl=impl,
                           exchange_chunks=chunks)
    assert isinstance(got, ShardedState) and len(got.shards) == NDEV
    close(got.full(), _jax_state(name, jmesh))
    close(got.full(), simulate(circ, device="cpu", backend="xla").numpy())
    if impl != "rdma":
        # the fused passes can park qubits where a later wall finds them
        # local, so only the collective schedules are what the dry walk
        # counts
        assert got.exchange_count == count_exchanges(circ, NDEV)


@pytest.mark.parametrize("backend", ["auto", "xla"])
def test_backends_and_psi0_forms_agree(mesh, backend):
    circ = fable15(Circuit)
    psi0 = np.random.default_rng(2).standard_normal(2**15)
    full = sharded_simulate(circ, mesh, psi0=torch.tensor(psi0),
                            backend=backend)
    shards = sharded_simulate(
        circ, mesh, psi0=[torch.tensor(p) for p in np.split(psi0, NDEV)],
        backend=backend)
    want = simulate(circ, psi0=torch.tensor(psi0), backend="xla").numpy()
    close(full.full(), want)
    close(shards.full(), want)
    close(full[:16], want[:16])


def test_complex_psi0_promotes_dtype(jmesh, mesh):
    q = 6
    rng = np.random.default_rng(4)
    psi0 = rng.normal(size=2**q) + 1j * rng.normal(size=2**q)
    psi0 /= np.linalg.norm(psi0)
    want = jsharded.sharded_simulate(JCircuit(q).h(0).h(q - 1), jmesh,
                                     psi0=jnp.asarray(psi0))
    got = sharded_simulate(Circuit(q).h(0).h(q - 1), mesh,
                           psi0=torch.tensor(psi0))
    assert got.dtype == torch.complex128
    close(got.full(), np.asarray(want))


# -- bookkeeping ------------------------------------------------------------------


@pytest.mark.parametrize("name", list(CIRCUITS))
def test_count_exchanges_matches_jax(name):
    for n_dev in (2, 8):
        assert (count_exchanges(CIRCUITS[name](Circuit), n_dev)
                == jsharded.count_exchanges(CIRCUITS[name](JCircuit), n_dev))


@pytest.mark.parametrize("controls", [
    (14, 13, 12),                 # every control global
    (14, 13, 12, *range(11, -1, -1)),  # FABLE's register: a plain slice
    (13, 2, 12, 5),               # partly local, interleaved
    (2, 14, 0, 13),               # unordered
    (5, 3),                       # every control local
])
def test_select_global_control_angles_matches_jax(jmesh, controls):
    q_local = 12
    params = np.random.default_rng(len(controls)).standard_normal(
        2 ** len(controls))

    def local(_):
        sel, _ = jsharded._select_global_control_angles(
            jnp.asarray(params), controls, q_local, AXIS)
        return sel

    want = np.asarray(jax.shard_map(
        local, mesh=jmesh, in_specs=P(AXIS), out_specs=P(AXIS),
        check_vma=False)(jnp.zeros(NDEV))).reshape(NDEV, -1)
    want_local = tuple(c for c in controls if c < q_local)
    for slot in range(NDEV):
        for kind in (np.asarray, torch.tensor):
            got, local_controls = sharded._select_global_control_angles(
                kind(params), controls, q_local, slot)
            assert local_controls == want_local
            np.testing.assert_array_equal(np.asarray(got), want[slot])


def test_move_bits_matches_pattern_index():
    """The run-wise bit mover behind the selections and the angle
    broadcast equals ``statevector._pattern_index`` bit by bit."""
    from qkan_implementation_tpu_torch.sim.statevector import _pattern_index

    rng = np.random.default_rng(12)
    for trial in range(60):
        q_ = int(rng.integers(1, 12))
        k = int(rng.integers(0, q_ + 1))
        picked = [int(v) for v in rng.choice(q_, k, replace=False)]
        if trial % 3 == 0:
            picked.sort(reverse=True)  # runs, as FABLE's registers give
        got = sharded._move_bits(torch.arange(2**q_), picked,
                                 range(k - 1, -1, -1))
        np.testing.assert_array_equal(got.numpy(),
                                      _pattern_index(picked, 2**q_))


def test_layout_restore_and_dry_run(mesh):
    """Real exchanges followed by ``restore`` give back the state; the
    bookkeeping of every step equals the JAX layout's."""
    q, q_local = 9, 6
    psi = np.random.default_rng(8).standard_normal(2**q)
    blocks = [torch.tensor(b) for b in np.split(psi, NDEV)]
    layout = sharded._QubitLayout(q, q_local, NDEV)
    jlayout = jsharded._QubitLayout(q, q_local, AXIS, NDEV, dry_run=True)
    for g, loc in ((8, 5), (6, 0), (7, 5), (8, 2)):
        blocks = layout.exchange(blocks, g, loc)
        jlayout.exchange(None, g, loc)
        assert (layout.phys, layout.occupant) == (jlayout.phys,
                                                  jlayout.occupant)
    blocks = layout.restore(blocks)
    jlayout.restore(None)
    assert layout.exchange_count == jlayout.exchange_count
    assert layout.phys == list(range(q)) == jlayout.phys
    np.testing.assert_array_equal(torch.cat(blocks).numpy(), psi)
    dry = sharded._QubitLayout(q, q_local, NDEV, dry_run=True)
    assert dry.exchange(None, 7, 0) is None and dry.exchange_count == 1
    dry.restore(None)
    assert dry.phys == list(range(q))


# -- the sharded quantum layer -------------------------------------------------------


@pytest.fixture
def jax_diag_template_as_found():
    """The JAX package keeps its packed-extraction circuits process-wide
    (``_diag_circuit_template``), each with a cache of sharded executors,
    and ``test_quantum_mode.py`` counts the entries of the 64-entry one:
    leave that cache as this test found it, whatever runs next in the
    process."""
    circ = jq._diag_circuit_template(6)[0]
    found = getattr(circ, "_sharded_exec_cache", None)
    saved = None if found is None else dict(found)
    yield
    if saved is None:
        vars(circ).pop("_sharded_exec_cache", None)
    else:
        circ._sharded_exec_cache.clear()
        circ._sharded_exec_cache.update(saved)


@pytest.mark.parametrize("impl", ["rdma", "collective"])
def test_quantum_layer_sharded_matches_jax(jmesh, mesh, impl,
                                           jax_diag_template_as_found):
    """TestShardedQuantumMode's N = K = 8 layer, forward and the gradient
    of sum(out^2) in x and w.  There JAX routes 'rdma' through its
    collective path (its block of 1024 is under two tiles); the port's
    K11 takes any block."""
    rng = np.random.default_rng(1)
    N = K = 8
    x_np = rng.uniform(-1, 1, N)
    w_np = rng.uniform(-0.5, 0.5, (4, N * K))

    def jloss(x, w):
        out = jq.qkan_layer_forward_quantum_sharded(x, w, N, K, jmesh,
                                                    exchange_impl=impl)
        return jnp.sum(out**2), out

    (_, want), (want_gx, want_gw) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(x_np),
                                             jnp.asarray(w_np))
    x = torch.tensor(x_np, requires_grad=True)
    w = torch.tensor(w_np, requires_grad=True)
    out = q.qkan_layer_forward_quantum_sharded(x, w, N, K, mesh,
                                               exchange_impl=impl)
    gx, gw = torch.autograd.grad((out**2).sum(), [x, w])
    close(out, want)
    close(gx, want_gx)
    close(gw, want_gw)
    dense = q.qkan_layer_forward_quantum(x, w, N, K)
    close(out, dense.detach().numpy())


# -- mesh and collectives ------------------------------------------------------------


def _jax_collective(jmesh, fn, x):
    return np.asarray(jax.jit(jax.shard_map(
        fn, mesh=jmesh, in_specs=P(AXIS), out_specs=P(AXIS),
        check_vma=False))(jnp.asarray(x)))


@pytest.mark.parametrize("name", ["psum", "pmean", "all_gather", "ppermute",
                                  "all_to_all", "pairwise_exchange",
                                  "pairwise_exchange_a2a"])
def test_collectives_match_jax(jmesh, name):
    x = np.random.default_rng(6).standard_normal((NDEV * NDEV, 3))
    perm = [(i, (i + 3) % NDEV) for i in range(NDEV - 2)]
    jfns = {
        "psum": lambda v: jcoll.psum(v, AXIS),
        "pmean": lambda v: jcoll.pmean(v, AXIS),
        "all_gather": lambda v: jcoll.all_gather(v, AXIS)[None],
        "ppermute": lambda v: jcoll.ppermute(v, AXIS, perm),
        "all_to_all": lambda v: jcoll.all_to_all(v, AXIS, 0, 0),
        "pairwise_exchange": lambda v: jcoll.pairwise_exchange(v, AXIS, 1,
                                                               NDEV),
        "pairwise_exchange_a2a": lambda v: jcoll.pairwise_exchange_a2a(
            v, AXIS, 2, NDEV),
    }
    fns = {
        "psum": coll.psum, "pmean": coll.pmean,
        "all_gather": lambda xs: [v[None] for v in coll.all_gather(xs)],
        "ppermute": lambda xs: coll.ppermute(xs, perm),
        "all_to_all": lambda xs: coll.all_to_all(xs, 0, 0),
        "pairwise_exchange": lambda xs: coll.pairwise_exchange(xs, 1),
        "pairwise_exchange_a2a": lambda xs: coll.pairwise_exchange_a2a(xs, 2),
    }
    want = _jax_collective(jmesh, jfns[name], x)
    got = fns[name](list(torch.tensor(x).chunk(NDEV)))
    close(torch.cat(got), want)


def test_collective_checks_raise():
    six = [torch.zeros(2)] * 6
    eight = [torch.zeros(2)] * 8
    for fn in (coll.pairwise_exchange, coll.pairwise_exchange_a2a):
        with pytest.raises(ValueError, match="power-of-two"):
            fn(six, 0)
        with pytest.raises(ValueError, match="out of range"):
            fn(eight, 3)


def test_mesh_helpers():
    m = make_mesh(devices=["cpu"] * 4, axis_name="sv")
    assert m.shape == {"sv": 4} and m.axis_names == ("sv",)
    assert m.devices == (torch.device("cpu"),) * 4
    m2 = make_mesh_2d((2, 4), devices=["cpu"] * 8)
    assert m2.shape["dp"] == 2 and m2.shape["sv"] == 4
    assert len(m2.axis_devices("sv")) == 4 and len(m2.axis_devices("dp")) == 2
    pieces = parallel.shard_batch(torch.arange(8.0), m, "sv")
    assert [p.tolist() for p in pieces] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    with pytest.raises(ValueError, match="divide"):
        parallel.shard_batch(torch.arange(6.0), m, "sv")
    # the tp / pp paths (tests/test_torch_parallel_{tp,pp}.py) want their
    # model axis on the mesh
    with pytest.raises(ValueError, match="no model axis 'tp'"):
        parallel.kan_apply_tp([], torch.zeros(4, 2), 1, m)
    with pytest.raises(ValueError, match="no model axis 'pp'"):
        parallel.make_pp_train_step(m, 1)


def test_raising_cases(mesh):
    with pytest.raises(ValueError, match="power of two"):
        sharded_simulate(Circuit(8).h(7),
                         make_mesh(6, devices=["cpu"] * 6))
    with pytest.raises(ValueError, match="more qubits"):
        sharded_simulate(Circuit(3).h(0), mesh)
    with pytest.raises(ValueError, match="exchange_impl"):
        sharded_simulate(Circuit(6).h(5), mesh, exchange_impl="nccl")
    with pytest.raises(ValueError, match="backend"):
        sharded_simulate(Circuit(6).h(5), mesh, backend="fuse")
    with pytest.raises(ValueError, match="axis"):
        sharded_simulate(Circuit(6).h(5), mesh, axis_name="x")
    with pytest.raises(ValueError, match="power of two"):
        count_exchanges(Circuit(5).h(4), 6)
    with pytest.raises(ValueError, match="more qubits"):
        count_exchanges(Circuit(5).h(4), 32)
    # the default mesh takes CUDA cards, never the CPU
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match="available"):
        make_mesh(n_cards + 1)
    with pytest.raises(ValueError, match="available"):
        make_mesh(9, devices=["cpu"] * 8)
    if n_cards == 0:
        with pytest.raises(ValueError, match="no CUDA card"):
            make_mesh()
    state = sharded_simulate(Circuit(6).h(5), mesh)
    with pytest.raises(IndexError, match="prefix"):
        state[4:12]


def test_shard_memory_report(mesh):
    q = 10
    circ = Circuit(q)
    for t in range(q):
        circ.ry(0.3 + 0.01 * t, t)
    state = sharded_simulate(circ, mesh, dtype=torch.float32)
    rep = shard_memory_report(state)
    assert rep["devices"] == NDEV and rep["cards"] == 1 and rep["balanced"]
    assert rep["max_bytes_per_device"] == 2**q * 4 // NDEV
    assert rep["total_bytes"] == rep["logical_bytes"] == 2**q * 4
    # shards that are views of one full buffer hold all of it each
    full = torch.zeros(2**q, dtype=torch.float32)
    rep2 = shard_memory_report(ShardedState(list(full.chunk(NDEV)), mesh))
    assert rep2["max_bytes_per_device"] == 2**q * 4 and not rep2["balanced"]
