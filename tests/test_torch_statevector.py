"""The torch port's quantum runtime (``sim/``, ``encoding/``) against the
JAX package on the CPU, on the same numpy inputs.

The JAX kernels run as ``tests/test_pallas_kernels.py`` runs them
(``interpret=True``, q = 11, the smallest size their 8x128 tile takes);
the port's kernel functions run their plain versions on CPU tensors.  The
JAX suite runs x64, so torch's default dtype is float64 here too (the
port's counterpart of the x64 flag), restored after each test.

Bars: float64 within 1e-12 of max|JAX| (both sides do the same flops;
only the order of a few sums and the last ulp of cos/sin differ); float32
within 1e-6 of max|JAX|; gradients within 1e-6 of each leaf's max (the
VJPs in float32: the elementwise cotangent formulas against JAX's, in the
same precision).  FABLE's host-side parameters are numpy on both sides and
must agree exactly.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from qkan_implementation_tpu.encoding import fable as jfable
from qkan_implementation_tpu.encoding import fable_runtime_params as jparams
from qkan_implementation_tpu.encoding.fable import (
    gray_permutation as jgray,
    sfwht as jsfwht,
)
from qkan_implementation_tpu.sim import (
    Circuit as JCircuit,
    simulate as jsimulate,
    unitary as junitary,
)
from qkan_implementation_tpu.sim import measure as jmeasure
from qkan_implementation_tpu.sim import pallas_kernels as jpk
from qkan_implementation_tpu.sim.fusion import (
    BitPermutation as JBitPermutation,
    apply_bit_permutation as japply_perm,
    fuse_register_ops as jfuse,
    simulate_fable_runtime as jruntime,
)
from qkan_implementation_tpu.sim.ladder import simulate_fused as jsimulate_fused
from qkan_implementation_tpu_torch.encoding import (
    fable,
    fable_runtime_params,
    gray_permutation,
    sfwht,
)
from qkan_implementation_tpu_torch.parallel import make_mesh
from qkan_implementation_tpu_torch.sim import (
    Circuit,
    measure,
    sharded_simulate,
    simulate,
    unitary,
)
from qkan_implementation_tpu_torch.sim import pallas_kernels as pk
from qkan_implementation_tpu_torch.sim.fusion import (
    BitPermutation,
    HRegister,
    apply_bit_permutation,
    fuse_register_ops,
    simulate_fable_runtime,
)
from qkan_implementation_tpu_torch.sim.ladder import (
    LadderSegment,
    fuse_ladders,
    simulate_fused,
)
from qkan_implementation_tpu_torch.sim.statevector import _pallas_eligible

BAR = {torch.float32: 1e-6, torch.float64: 1e-12}
JDT = {torch.float32: jnp.float32, torch.float64: jnp.float64}
Q = 11  # the JAX kernels' smallest size (M = 1024 = one 8x128 tile)


@pytest.fixture(autouse=True)
def x64():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


def close(got, want, dtype=torch.float64, bar=None):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-300)
    err = float(np.abs(got - want).max())
    assert err <= (bar or BAR[dtype]) * scale, (err, scale)


def _t(a, dtype=torch.float64):
    return torch.from_numpy(np.asarray(a)).to(dtype)


def _normal(rng, shape):
    return rng.normal(size=shape)


# -- sim/pallas_kernels.py -----------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ucry_kernels_match_jax_interpret(dtype):
    rng = np.random.default_rng(0)
    psi = _normal(rng, 2**Q)
    th = rng.uniform(0, 2 * np.pi, 2 ** (Q - 1))
    c, s = np.cos(th / 2), np.sin(th / 2)
    jd = JDT[dtype]
    want = jpk.ucry_msb_pallas(jnp.asarray(psi, jd), jnp.asarray(th, jd),
                               interpret=True)
    close(pk.ucry_msb_pallas(_t(psi, dtype), _t(th, dtype)), want, dtype)
    args = [jnp.asarray(v, jd) for v in (psi, c, s)]
    for jfn, fn in ((jpk.ucry_msb_cs_pallas, pk.ucry_msb_cs_pallas),
                    (jpk.ucry_msb_cs_pallas_pair, pk.ucry_msb_cs_pallas_pair)):
        want = jfn(*args, interpret=True)
        close(fn(*(_t(v, dtype) for v in (psi, c, s))), want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_diag_and_h_kernels_match_jax_interpret(dtype):
    rng = np.random.default_rng(1)
    jd = JDT[dtype]
    psi = _normal(rng, 2**Q)
    diag = rng.uniform(-1, 1, 2**Q)
    want = jpk.diag_mult_pallas(jnp.asarray(psi, jd), jnp.asarray(diag, jd),
                                interpret=True)
    close(pk.diag_mult_pallas(_t(psi, dtype), _t(diag, dtype)), want, dtype)
    for qubit in (7, 9, 10):  # the qubits the TPU tiling takes at q = 11
        want = jpk.h_gate_pallas(jnp.asarray(psi, jd), qubit, interpret=True)
        close(pk.h_gate_pallas(_t(psi, dtype), qubit), want, dtype)
    for qubit in range(Q):  # the port takes every qubit
        want = jsimulate(JCircuit(Q).h(qubit), psi0=jnp.asarray(psi, jd),
                         dtype=jd, backend="xla")
        close(pk.h_gate_pallas(_t(psi, dtype), qubit), want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ucry_vjps_match_jax(dtype):
    rng = np.random.default_rng(5)
    jd = JDT[dtype]
    psi = _normal(rng, 2**Q)
    th = rng.uniform(-3, 3, 2 ** (Q - 1))
    tgt = _normal(rng, 2**Q)
    jtgt = jnp.asarray(tgt, jd)

    def jloss_trig(p, t):
        return jnp.sum((jpk.ucry_msb_pallas(p, t, True) - jtgt) ** 2)

    def jloss_pair(p, c, s):
        return jnp.sum((jpk.ucry_msb_cs_pallas_pair(p, c, s, True) - jtgt) ** 2)

    def grads(fn, *arrays):
        leaves = [_t(a, dtype).requires_grad_() for a in arrays]
        loss = torch.sum((fn(*leaves) - _t(tgt, dtype)) ** 2)
        return torch.autograd.grad(loss, leaves)

    want = jax.grad(jloss_trig, argnums=(0, 1))(jnp.asarray(psi, jd),
                                                jnp.asarray(th, jd))
    for g, w in zip(grads(pk.ucry_msb_pallas, psi, th), want):
        close(g, w, dtype)
    c, s = np.cos(th / 2), np.sin(th / 2)
    want = jax.grad(jloss_pair, argnums=(0, 1, 2))(
        *(jnp.asarray(v, jd) for v in (psi, c, s)))
    for fn in (pk.ucry_msb_cs_pallas_pair, pk.ucry_msb_cs_pallas):
        for g, w in zip(grads(fn, psi, c, s), want):
            close(g, w, dtype)


def test_batched_angles_match_jax_vmap():
    """Per-state angle rows [B, M] and shared angles [M] over a batched
    state, forward and VJP, against JAX's vmap of the same kernel."""
    rng = np.random.default_rng(6)
    B = 3
    psi = _normal(rng, (B, 2**Q))
    rows = rng.uniform(0, 2 * np.pi, (B, 2 ** (Q - 1)))
    shared = rows[0]
    tgt = _normal(rng, (B, 2**Q))
    for th in (rows, shared):
        axes = (0, 0 if th.ndim == 2 else None)

        def jloss(p, t):
            out = jax.vmap(lambda a, b: jpk.ucry_msb_pallas(a, b, True),
                           in_axes=axes)(p, t)
            return jnp.sum((out - tgt) ** 2), out

        (_, want_out), want_g = jax.value_and_grad(
            jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(psi),
                                                 jnp.asarray(th))
        leaves = [_t(psi).requires_grad_(), _t(th).requires_grad_()]
        out = pk.ucry_msb_pallas(*leaves)
        close(out, want_out)
        got_g = torch.autograd.grad(torch.sum((out - _t(tgt)) ** 2), leaves)
        for g, w in zip(got_g, want_g):
            close(g, w)
        assert got_g[1].shape == th.shape


def test_kernel_functions_take_sizes_below_the_tpu_tile():
    """q = 5 (M = 16): the JAX kernels refuse it (8x128 tile), the port's
    take it; held against JAX's XLA gate ops."""
    rng = np.random.default_rng(7)
    q = 5
    psi = _normal(rng, 2**q)
    th = rng.uniform(0, 2 * np.pi, 2 ** (q - 1))
    with pytest.raises(ValueError):
        jpk.ucry_msb_pallas(jnp.asarray(psi), jnp.asarray(th), interpret=True)
    controls = tuple(range(q - 2, -1, -1))
    want = jsimulate(JCircuit(q).ucry(th, controls, q - 1),
                     psi0=jnp.asarray(psi), backend="xla")
    close(pk.ucry_msb_pallas(_t(psi), _t(th)), want)
    close(pk.ucry_msb_cs_pallas_pair(_t(psi), _t(np.cos(th / 2)),
                                     _t(np.sin(th / 2))), want)
    close(pk.diag_mult_pallas(_t(psi), _t(th.repeat(2))), psi * th.repeat(2))
    for qubit in range(q):
        want = jsimulate(JCircuit(q).h(qubit), psi0=jnp.asarray(psi),
                         backend="xla")
        close(pk.h_gate_pallas(_t(psi), qubit), want)
    # q = 1: one amplitude pair, no controls
    c1 = Circuit(1).ucry(np.array([0.7]), (), 0)
    jc1 = JCircuit(1).ucry(np.array([0.7]), (), 0)
    close(simulate(c1, device="cpu"), jsimulate(jc1, backend="xla"))


def test_simulate_fable_pallas_matches_jax():
    rng = np.random.default_rng(3)
    a = rng.uniform(-1, 1, (32, 32))
    want, jalpha = jpk.simulate_fable_pallas(a, interpret=True)
    got, alpha = pk.simulate_fable_pallas(a, device="cpu")
    assert alpha == jalpha and got.dtype == torch.float32
    close(got, want, torch.float32)
    np.testing.assert_allclose(got.numpy()[:32] * alpha * 32, a[:, 0],
                               atol=1e-5)


def test_cpu_tensors_launch_nothing():
    owners = [pk.ucry_msb_pallas, pk.ucry_msb_cs_pallas_pair,
              pk.diag_mult_pallas, pk.h_gate_pallas]
    before = [o.launches for o in owners]
    pk.simulate_fable_pallas(np.eye(4), device="cpu")
    simulate(fable(np.eye(4))[0], device="cpu")
    assert [o.launches for o in owners] == before


# -- sim/statevector.py, fusion.py, ladder.py ------------------------------------


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("backend", ["auto", "xla", "pallas"])
def test_simulate_fable_circuits_match_jax(fused, backend):
    rng = np.random.default_rng(2)
    a = rng.uniform(-1, 1, (8, 8))
    circ, alpha = fable(a, fused=fused)
    jcirc, jalpha = jfable(a, fused=fused)
    assert alpha == jalpha and len(circ) == len(jcirc)
    psi0 = _normal(rng, 2**circ.num_qubits)
    jbackend = "xla" if backend == "pallas" else backend  # interpret-free
    want = jsimulate(jcirc, psi0=jnp.asarray(psi0), backend=jbackend)
    close(simulate(circ, psi0=_t(psi0), backend=backend), want)
    # the block contract, end to end, from |0>
    col = simulate(circ, backend=backend, device="cpu").numpy()
    np.testing.assert_allclose(col[:8] * alpha * 8, a[:, 0], atol=1e-10)


def test_elementary_fable_ladder_fuses_and_matches_jax():
    rng = np.random.default_rng(4)
    a = rng.uniform(-1, 1, (8, 8))
    circ, _ = fable(a, fused=False)
    jcirc, _ = jfable(a, fused=False)
    items = fuse_ladders(circ, min_len=8)
    assert any(isinstance(i, LadderSegment) for i in items)
    psi0 = _normal(rng, 2**circ.num_qubits)
    want = jsimulate_fused(jcirc, psi0=jnp.asarray(psi0))
    close(simulate_fused(circ, psi0=_t(psi0)), want)
    # a ladder longer than AUTO_LADDER_MIN goes through apply_ladder under
    # 'auto' (n = 4: 2 * 4^4 = 512 gates)
    a4 = rng.uniform(-1, 1, (16, 16))
    circ4, alpha4 = fable(a4, fused=False)
    jcirc4, _ = jfable(a4, fused=False)
    want = jsimulate(jcirc4, backend="auto")
    got = simulate(circ4, backend="auto", device="cpu")
    close(got, want)
    np.testing.assert_allclose(got.numpy()[:16] * alpha4 * 16, a4[:, 0],
                               atol=1e-10)


def test_unitary_matches_jax():
    rng = np.random.default_rng(8)
    a = rng.uniform(-1, 1, (4, 4))
    circ, alpha = fable(a)
    jcirc, _ = jfable(a)
    u = unitary(circ, device="cpu")
    close(u, junitary(jcirc))
    np.testing.assert_allclose(u.numpy()[:4, :4] * alpha * 4, a, atol=1e-12)
    # a mixed circuit with complex gates promotes to complex128
    circ = Circuit(3).h(0).rz(0.3, 1).cry(0.4, 0, 2).swap(0, 2).ry(0.2, 1)
    jc = JCircuit(3).h(0).rz(0.3, 1).cry(0.4, 0, 2).swap(0, 2).ry(0.2, 1)
    u = unitary(circ, device="cpu")
    assert u.dtype == torch.complex128
    close(u, junitary(jc))


def test_mixed_gates_and_tensor_angles_match_jax():
    rng = np.random.default_rng(9)
    q = 6
    phases = rng.uniform(-1, 1, 2**3)
    mat = np.linalg.qr(rng.normal(size=(4, 4)))[0]
    th = rng.uniform(-np.pi, np.pi, 2**2)

    def build(C, th_in):
        return (C(q).h(0).x(1).z(2).cx(0, 3).cz(1, 4).swap(2, 5)
                .ry(0.3, 4).cry(0.5, 1, 3).diagonal(phases, (5, 0, 2))
                .unitary(mat, (1, 4)).ucry(th_in, (0, 3), 2))

    psi0 = _normal(rng, 2**q)
    want = jsimulate(build(JCircuit, th), psi0=jnp.asarray(psi0),
                     backend="xla")
    for th_in in (th, _t(th)):  # static and tensor angles
        close(simulate(build(Circuit, th_in), psi0=_t(psi0), backend="auto"),
              want)
    # a tensor angle carries grad into the Ry matrix
    t = torch.tensor(0.3, requires_grad=True)
    out = simulate(Circuit(1).ry(t, 0), device="cpu")
    out[1].backward()
    assert abs(float(t.grad) - 0.5 * np.cos(0.15)) < 1e-12


def test_routing_follows_the_angle_kind(monkeypatch):
    """Static numpy angles take K6 (cos/sin on the host), tensor angles K8
    (trig in the state's dtype), ineligible layouts the plain gate ops."""
    q = 5
    controls = tuple(range(q - 2, -1, -1))
    th = np.linspace(0.1, 3.0, 2 ** (q - 1))
    circ = Circuit(q).ucry(th, controls, q - 1)
    assert _pallas_eligible(circ.gates[0], q, torch.float32)
    assert not _pallas_eligible(circ.gates[0], q, torch.complex64)
    other = Circuit(q).ucry(th, tuple(reversed(controls)), q - 1)
    assert not _pallas_eligible(other.gates[0], q, torch.float64)
    assert not _pallas_eligible(Circuit(q).ucry(th, (4, 3, 2, 1), 0).gates[0],
                                q, torch.float64)

    calls = []
    k6, k8 = pk.ucry_msb_cs_pallas_pair, pk.ucry_msb_pallas
    monkeypatch.setattr(pk, "ucry_msb_cs_pallas_pair",
                        lambda *a: calls.append("K6") or k6(*a))
    monkeypatch.setattr(pk, "ucry_msb_pallas",
                        lambda *a: calls.append("K8") or k8(*a))
    simulate(circ, device="cpu")
    simulate(Circuit(q).ucry(_t(th), controls, q - 1), device="cpu")
    simulate(other, device="cpu")
    simulate(circ, device="cpu", backend="xla")
    assert calls == ["K6", "K8"]


def test_fuse_register_ops_matches_jax():
    rng = np.random.default_rng(1)
    circ, _ = fable(rng.uniform(-1, 1, (8, 8)))
    jcirc, _ = jfable(rng.uniform(-1, 1, (8, 8)))
    got = fuse_register_ops(circ.gates, circ.num_qubits)
    want = jfuse(jcirc.gates, jcirc.num_qubits)
    assert [type(i).__name__ for i in got] == [type(i).__name__ for i in want]
    assert [getattr(i, "qubits", None) for i in got] == [
        getattr(i, "qubits", None) for i in want]
    assert [getattr(i, "perm", None) for i in got] == [
        getattr(i, "perm", None) for i in want]
    assert isinstance(got[0], HRegister) and isinstance(got[2], BitPermutation)


@pytest.mark.parametrize("perm", [
    (3, 4, 5, 0, 1, 2, 6),                      # register swap: few blocks
    (1, 0, 3, 2, 5, 4, 7, 6, 9, 8, 11, 10),     # 12 blocks: the gather
])
def test_apply_bit_permutation_matches_jax(perm):
    rng = np.random.default_rng(len(perm))
    q = len(perm)
    psi = _normal(rng, (2, 2**q))
    want = np.stack([np.asarray(japply_perm(jnp.asarray(p),
                                            JBitPermutation(perm), q))
                     for p in psi])
    close(apply_bit_permutation(_t(psi), BitPermutation(perm), q), want)


def test_simulate_fable_runtime_matches_jax_and_differentiates():
    rng = np.random.default_rng(5)
    n = 3
    a = rng.uniform(-1, 1, (2**n, 2**n))
    cs, sn, alpha, n_ = fable_runtime_params(a)
    jcs, jsn, jalpha, _ = jparams(a)
    assert n_ == n and alpha == jalpha
    np.testing.assert_array_equal(cs, jcs)
    np.testing.assert_array_equal(sn, jsn)
    e = np.zeros(2 ** (2 * n + 1))
    e[3] = 1.0
    want = jruntime(jnp.asarray(cs), jnp.asarray(sn), n, psi0=jnp.asarray(e))
    close(simulate_fable_runtime(_t(cs), _t(sn), n, psi0=_t(e)), want)
    np.testing.assert_allclose(
        simulate_fable_runtime(_t(cs), _t(sn), n).numpy()[: 2**n]
        * alpha * 2**n, a[:, 0], atol=1e-12)
    tgt = _normal(rng, 2 ** (2 * n + 1))

    def jloss(c, s):
        return jnp.sum((jruntime(c, s, n, psi0=jnp.asarray(e)) - tgt) ** 2)

    want_g = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(cs), jnp.asarray(sn))
    leaves = [_t(cs).requires_grad_(), _t(sn).requires_grad_()]
    loss = torch.sum((simulate_fable_runtime(*leaves, n, psi0=_t(e))
                      - _t(tgt)) ** 2)
    for g, w in zip(torch.autograd.grad(loss, leaves), want_g):
        close(g, w)


# -- sim/measure.py ---------------------------------------------------------------


def test_measure_matches_jax():
    rng = np.random.default_rng(11)
    q = 4
    psi = _normal(rng, 2**q)
    diag = rng.uniform(-1, 1, 2**q)
    close(measure.probabilities(_t(psi)), jmeasure.probabilities(jnp.asarray(psi)))
    close(measure.expectation_diagonal(_t(psi), _t(diag)),
          jmeasure.expectation_diagonal(jnp.asarray(psi), jnp.asarray(diag)))
    for qubits in ((0,), (3, 1), (2, 0, 3)):
        close(measure.marginal_probabilities(_t(psi), qubits, q),
              jmeasure.marginal_probabilities(jnp.asarray(psi), qubits, q))


def test_sample_counts_follow_the_distribution():
    """Sampling draws other numbers than JAX's: hold it to the
    distribution.  GHZ on 3 qubits: only |000> and |111>, each p = 1/2;
    4000 shots put each within 5 sigma (sigma = 31.6) of 2000."""
    circ = Circuit(3).h(0).cx(0, 1).cx(1, 2)
    psi = simulate(circ, device="cpu")
    gen = torch.Generator().manual_seed(0)
    idx, counts = measure.sample_counts(psi, 4000, gen)
    assert idx.shape == (4000,) and set(counts) == {0, 7}
    assert all(abs(c - 2000) < 5 * 31.6 for c in counts.values())
    # a skewed state: p = (0.1, 0.2, 0.3, 0.4) by a chi-square bound
    p = np.array([0.1, 0.2, 0.3, 0.4])
    _, counts = measure.sample_counts(_t(np.sqrt(p)), 20000, gen)
    chi2 = sum((counts.get(i, 0) - 20000 * p[i]) ** 2 / (20000 * p[i])
               for i in range(4))
    assert chi2 < 16.3  # p = 0.001 at 3 degrees of freedom


# -- encoding/fable.py, gate IR -------------------------------------------------------


def test_fable_helpers_match_jax():
    rng = np.random.default_rng(12)
    v = rng.normal(size=16)
    np.testing.assert_array_equal(sfwht(v), jsfwht(v))
    np.testing.assert_array_equal(gray_permutation(v), jgray(v))
    for a, kw in ((rng.uniform(-1, 1, (4, 4)), {}),
                  (rng.uniform(-3, 3, (3, 5)), {}),
                  (rng.uniform(-1, 1, (4, 4)), {"fused": False}),
                  (rng.uniform(-1, 1, (4, 4)),
                   {"fused": False, "compression_threshold": 0.05})):
        circ, alpha = fable(a, **kw)
        jcirc, jalpha = jfable(a, **kw)
        assert alpha == jalpha and circ.num_qubits == jcirc.num_qubits
        assert [(g.name, g.qubits) for g in circ.gates] == [
            (g.name, g.qubits) for g in jcirc.gates]
        for g, jg in zip(circ.gates, jcirc.gates):
            np.testing.assert_array_equal(np.asarray(g.params, dtype=float),
                                          np.asarray(jg.params, dtype=float))
        assert circ.depth() == jcirc.depth()
    with pytest.raises(ValueError):
        fable(np.eye(2) * 1j)
    with pytest.raises(ValueError):
        fable(np.eye(2), compression_threshold=0.1)


def test_gate_ir_keeps_tensors_and_checks_shapes():
    th = torch.zeros(3, 4, requires_grad=True)
    circ = Circuit(3).ucry(th, (1, 0), 2)
    assert circ.gates[0].params is th
    assert isinstance(Circuit(3).ucry([0.1] * 4, (1, 0), 2).gates[0].params,
                      np.ndarray)
    with pytest.raises(ValueError):
        Circuit(3).ucry(torch.zeros(3), (1, 0), 2)
    with pytest.raises(ValueError):
        Circuit(2).h(2)
    with pytest.raises(ValueError):
        simulate(Circuit(2).h(0), backend="fuse", device="cpu")
    with pytest.raises(ValueError, match="more qubits"):
        sharded_simulate(Circuit(2), make_mesh(8, devices=["cpu"] * 8))
