"""The torch port's fused exchange + gate (K11, ``sim/rdma.py``) against
the JAX package on the CPU, on the same numpy inputs.

The JAX kernels run as ``tests/test_sim_rdma.py`` runs them: Pallas TPU
interpret mode on the 8 virtual CPU devices of ``tests/conftest.py``, at
q_local = 11 (the smallest block their 8x128 tile takes).  The port runs
its plain versions on 8 CPU slots.  The JAX suite runs x64, so torch's
default dtype is float64 here, restored after each test.

Bar: float64 within 1e-12 of max|JAX| (forward and gradients): both
sides do the same few flops an amplitude, and the gradients the same
elementwise VJP followed by the same exchange.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.sharding import PartitionSpec as P

import qkan_implementation_tpu.sim.rdma as jrdma
from qkan_implementation_tpu.ops.quantum import (
    quantum_extract_diag_packed_sharded as jextract_sharded,
)
from qkan_implementation_tpu.parallel import make_mesh as jmake_mesh
from qkan_implementation_tpu.sim import Circuit as JCircuit
from qkan_implementation_tpu.sim.sharded import sharded_simulate as jsharded
from qkan_implementation_tpu_torch.ops.quantum import (
    quantum_extract_diag_packed_sharded,
)
from qkan_implementation_tpu_torch.parallel import make_mesh
from qkan_implementation_tpu_torch.sim import Circuit
from qkan_implementation_tpu_torch.sim import rdma
from qkan_implementation_tpu_torch.sim import sharded_simulate

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


def _cat(ts):
    return torch.cat([t.detach() for t in ts])


def _split(a, n=NDEV, grad=True):
    return [torch.tensor(p, requires_grad=grad) for p in np.split(a, n)]


def _spy(monkeypatch, name: str) -> list:
    """Record the port's calls of an ``sim.rdma`` function (the engine
    calls it through the module), so a test can show K11 fired."""
    fired = []
    orig = getattr(rdma, name)

    def counting(*a, **k):
        fired.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(rdma, name, counting)
    return fired


def _inputs(q_local, dev_bit):
    m = 2 ** (q_local - 1)
    rng = np.random.default_rng(q_local * 10 + dev_bit)
    full = rng.standard_normal(NDEV * 2 * m)
    t = rng.standard_normal(NDEV * m)
    return full, np.cos(t / 2), np.sin(t / 2)


@pytest.mark.parametrize("dev_bit", [0, 1, 2])
def test_ucry_exchange_matches_jax(jmesh, dev_bit):
    """Forward and the gradients of sum(out^3) in block, cos and sin."""
    full, c, s = _inputs(11, dev_bit)

    def local(block, cc, ss):
        def loss(b, c_, s_):
            out = jrdma.ucry_exchange_fused_rdma(b, c_, s_, dev_bit, AXIS,
                                                 NDEV, interpret=True)
            return jnp.sum(out**3), out

        (_, out), grads = jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True)(block, cc, ss)
        return (out, *grads)

    want = jax.jit(jax.shard_map(
        local, mesh=jmesh, in_specs=(P(AXIS),) * 3, out_specs=(P(AXIS),) * 4,
        check_vma=False))(jnp.asarray(full), jnp.asarray(c), jnp.asarray(s))

    blocks, cs, sn = _split(full), _split(c), _split(s)
    outs = rdma.ucry_exchange_fused_rdma(blocks, cs, sn, dev_bit, AXIS, NDEV,
                                         interpret=True)
    grads = torch.autograd.grad(sum((o**3).sum() for o in outs),
                                [*blocks, *cs, *sn])
    close(_cat(outs), want[0])
    for k, w in enumerate(want[1:]):
        close(_cat(grads[k * NDEV:(k + 1) * NDEV]), w)
    # no gradient asked: the same forward, no autograd node
    with torch.no_grad():
        close(_cat(rdma.ucry_exchange_fused_rdma(blocks, cs, sn, dev_bit)),
              want[0])


@pytest.mark.parametrize("dev_bit", [0, 1, 2])
def test_h_exchange_matches_jax(jmesh, dev_bit):
    full, _, _ = _inputs(11, dev_bit)

    def local(block):
        def loss(b):
            out = jrdma.h_exchange_fused_rdma(b, dev_bit, AXIS, NDEV,
                                              interpret=True)
            return jnp.sum(out**3), out

        (_, out), grad = jax.value_and_grad(loss, has_aux=True)(block)
        return out, grad

    want = jax.jit(jax.shard_map(
        local, mesh=jmesh, in_specs=P(AXIS), out_specs=(P(AXIS),) * 2,
        check_vma=False))(jnp.asarray(full))

    blocks = _split(full)
    outs = rdma.h_exchange_fused_rdma(blocks, dev_bit)
    grads = torch.autograd.grad(sum((o**3).sum() for o in outs), blocks)
    close(_cat(outs), want[0])
    close(_cat(grads), want[1])


def test_plain_versions():
    """The plain versions pair kept/received by the device bit."""
    k, r = torch.tensor([1.0, 2.0]), torch.tensor([3.0, 4.0])
    ct, st = torch.tensor([0.6, 0.8]), torch.tensor([0.8, 0.6])
    close(rdma.ucry_exchange_reference(k, r, ct, st, 0),
          [0.6 - 2.4, 1.6 - 2.4, 0.8 + 1.8, 1.2 + 3.2])
    close(rdma.ucry_exchange_reference(k, r, ct, st, 1),
          [1.8 - 0.8, 3.2 - 1.2, 2.4 + 0.6, 2.4 + 1.6])
    h = np.sqrt(0.5)
    close(rdma.h_exchange_reference(k, r, 1), [4 * h, 6 * h, 2 * h, 2 * h])


def test_exchange_checks_raise():
    b = [torch.zeros(8) for _ in range(6)]
    with pytest.raises(ValueError, match="power-of-two"):
        rdma.h_exchange_fused_rdma(b, 0)
    b = [torch.zeros(8) for _ in range(8)]
    with pytest.raises(ValueError, match="dev_bit"):
        rdma.h_exchange_fused_rdma(b, 3)
    with pytest.raises(ValueError, match="n_dev"):
        rdma.h_exchange_fused_rdma(b, 0, n_dev=4)
    with pytest.raises(ValueError, match="coefficient"):
        rdma.ucry_exchange_fused_rdma(b, [torch.zeros(4)] * 2,
                                      [torch.zeros(4)] * 2, 0)
    assert rdma.ucry_exchange_eligible(2) and not rdma.ucry_exchange_eligible(1)


def _partial_control_circuit(cls, rng):
    q = 14  # q_local = 11 on 8 slots
    circ = cls(q)
    circ.h(2).h(5)
    circ.ucry(rng.uniform(-np.pi, np.pi, 8), controls=(7, 2, 4), target=q - 1)
    circ.h(0)
    # logical 10 was evicted to a global slot by the first fusion: a fused
    # ucry on the still-global q-2 with that global control
    circ.ucry(rng.uniform(-np.pi, np.pi, 4), controls=(10, 3), target=q - 2)
    return circ


def _fused_h_circuit(cls, rng):
    q = 14
    circ = cls(q)
    circ.h(q - 1)  # lone global H
    circ.ucry(rng.uniform(-np.pi, np.pi, 2), controls=(0,), target=1)
    circ.h(q - 2).h(10).h(2)  # wall: global, the local MSB, local
    circ.ucry(rng.uniform(-np.pi, np.pi, 4), controls=(3, 5), target=q - 1)
    return circ


@pytest.mark.parametrize("build,gate,calls", [
    (_partial_control_circuit, "ucry_exchange_fused_rdma", 2),
    (_fused_h_circuit, "h_exchange_fused_rdma", 3),
])
def test_rdma_engine_matches_jax(jmesh, mesh, monkeypatch, build, gate,
                                 calls):
    """test_sim_rdma.py's circuits: K11 fires as often as the JAX engine's
    kernel does there, and the state matches JAX's engine."""
    seed = 17 if gate.startswith("ucry") else 23
    want = np.asarray(jax.device_get(jsharded(
        build(JCircuit, np.random.default_rng(seed)), jmesh)))
    fired = _spy(monkeypatch, gate)
    got = sharded_simulate(build(Circuit, np.random.default_rng(seed)), mesh,
                           exchange_impl="rdma")
    assert len(fired) == calls
    close(got.full(), want)


def test_fused_h_gradient_matches_jax(jmesh, mesh, monkeypatch):
    """d sum(psi^3) / d psi0 through the fused H's backward."""
    q = 14
    rng = np.random.default_rng(29)
    u = rng.uniform(-np.pi, np.pi, 2)
    psi0 = rng.standard_normal(2**q)
    psi0 /= np.linalg.norm(psi0)

    def build(cls):
        circ = cls(q)
        circ.h(q - 1).h(4)  # wall with one global member
        circ.ucry(u, controls=(1,), target=0)
        circ.h(q - 2)  # lone global H
        return circ

    jc = build(JCircuit)
    want = jax.grad(lambda p: jnp.sum(jsharded(
        jc, jmesh, psi0=p, dtype=p.dtype) ** 3))(jnp.asarray(psi0))
    fired = _spy(monkeypatch, "h_exchange_fused_rdma")
    p = torch.tensor(psi0, requires_grad=True)
    out = sharded_simulate(build(Circuit), mesh, psi0=p, exchange_impl="rdma")
    (got,) = torch.autograd.grad(sum((s**3).sum() for s in out.shards), [p])
    assert fired
    close(got, want)


def test_packed_extraction_grad_matches_jax_rdma(jmesh, mesh, monkeypatch):
    """test_sim_rdma.py's 128-entry diagonal (15 qubits, q_local 12): the
    JAX engine runs its own K11 in interpret mode there.  Forward and the
    gradient of sum(rec^3), 'rdma' and 'collective' against JAX's 'rdma'."""
    diag = np.random.default_rng(5).uniform(-0.9, 0.9, 128)

    def jloss(d):
        rec = jextract_sharded(d, jmesh, exchange_impl="rdma")
        return jnp.sum(rec**3), rec

    (_, want), want_g = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(diag))
    fired = _spy(monkeypatch, "ucry_exchange_fused_rdma")
    for impl in ("rdma", "collective"):
        d = torch.tensor(diag, requires_grad=True)
        rec = quantum_extract_diag_packed_sharded(d, mesh, exchange_impl=impl)
        (g,) = torch.autograd.grad((rec**3).sum(), [d])
        close(rec, want)
        close(g, want_g)
    assert len(fired) == 1
