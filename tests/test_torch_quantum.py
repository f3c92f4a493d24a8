"""The torch port's QKAN step pipeline (``ops/qkan_layer``), quantum-mode
layer (``ops/quantum``) and QSVT neuron against the JAX package on the
CPU, on the same numpy inputs.

The JAX suite runs x64, so torch's default dtype is float64 here too (the
port's counterpart of the x64 flag), restored after each test.  Bars:
float64 within 1e-12 of max|JAX| (1e-10 where the JAX tests hold 1e-10:
the quantum extractions, whose arccos -> cos round trip amplifies the last
ulp); float32 within 1e-6 of max|JAX|; gradients within 1e-6 of each
leaf's max.  The JAX side of a batch is ``jax.vmap``; the port's is one
batched simulation.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from qkan_implementation_tpu.models.qsvt_neuron import (
    compare_classical_quantum as jcompare,
)
from qkan_implementation_tpu.ops import qkan_layer as jql
from qkan_implementation_tpu.ops import quantum as jq
from qkan_implementation_tpu_torch.models import (
    QSVTNeuron,
    compare_classical_quantum,
)
from qkan_implementation_tpu_torch.ops import qkan_layer as ql
from qkan_implementation_tpu_torch.ops import quantum as q
from qkan_implementation_tpu_torch.sim import pallas_kernels as pk
from qkan_implementation_tpu_torch.utils import array_from_numpy, array_to_numpy


@pytest.fixture(autouse=True)
def x64():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


def close(got, want, bar=1e-12):
    got = array_to_numpy(got) if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-300)
    err = float(np.abs(got - want).max())
    assert err <= bar * scale, (err, scale)


def _t(a, dtype=torch.float64):
    return array_from_numpy(a, "cpu", dtype)


def _layer_inputs(seed, N, K, d, lead=()):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (*lead, N)),
            rng.uniform(-1, 1, (d + 1, N * K)))


# -- ops/qkan_layer.py -----------------------------------------------------------


@pytest.mark.parametrize("N,K,d", [(4, 4, 3), (3, 2, 2), (5, 3, 0)])
def test_qkan_layer_pipeline_matches_jax(N, K, d):
    x, w = _layer_inputs(N * 10 + K, N, K, d)
    jx, jw = jnp.asarray(x), jnp.asarray(w)
    close(ql.weighted_chebyshev_diag(_t(x), _t(w[d]), K, d),
          jql.weighted_chebyshev_diag(jx, jw[d], K, d))
    close(ql.lcu_combine_diag(_t(x), _t(w), K), jql.lcu_combine_diag(jx, jw, K))
    close(ql.qkan_layer_forward(_t(x), _t(w), N, K),
          jql.qkan_layer_forward(jx, jw, N, K))
    close(ql.qkan_weight_tensor(_t(w), N, K), jql.qkan_weight_tensor(jw, N, K))
    got = ql.qkan_intermediates(_t(x), _t(w), N, K)
    want = jql.qkan_intermediates(jx, jw, N, K)
    for key in ("lcu", "reshaped", "final"):
        close(got[key], want[key])
    for deg in range(d + 1):
        close(got["cheb"][deg], want["cheb"][deg])
        close(got["weighted"][deg], want["weighted"][deg])


def test_sum_step_is_fortran_order():
    """out[k] = mean_i lcu[i + k*N]: a ramp tells the order apart from
    the C-order reading."""
    N, K = 3, 4
    lcu = np.arange(N * K, dtype=float)
    got = ql.sum_step(_t(lcu), N, K)
    close(got, jql.sum_step(jnp.asarray(lcu), N, K))
    np.testing.assert_array_equal(
        array_to_numpy(got), [np.mean(lcu[k * N:(k + 1) * N]) for k in range(K)])


def test_batched_forward_and_bf16_recipe_match_jax():
    N, K, d, B = 4, 6, 3, 9
    x, w = _layer_inputs(1, N, K, d, (B,))
    close(ql.qkan_layer_forward_batched(_t(x), _t(w), N, K),
          jql.qkan_layer_forward_batched(jnp.asarray(x), jnp.asarray(w), N, K))
    close(ql.qkan_layer_forward_batched(_t(x), _t(w), N, K),
          jax.vmap(lambda r: jql.qkan_layer_forward(r, jnp.asarray(w), N, K))(
              jnp.asarray(x)))
    # bf16: both sides round the basis and the folded weights to bf16 and
    # sum in f32, so they differ by the f32 summation order only
    got = ql.qkan_layer_forward_batched(_t(x, torch.bfloat16), _t(w), N, K,
                                        compute_dtype=torch.bfloat16)
    want = jql.qkan_layer_forward_batched(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w), N, K,
        compute_dtype=jnp.bfloat16)
    assert got.dtype == torch.float32
    close(got, want, bar=1e-6)
    with pytest.raises(ValueError):
        ql.qkan_layer_forward_batched(_t(x), _t(w), N, K, compute_dtype="int8")


# -- ops/quantum.py ------------------------------------------------------------------


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("N,K,d", [(4, 4, 3), (3, 2, 2)])
def test_quantum_layer_and_gradient_match_jax(N, K, d, packed):
    x, w = _layer_inputs(2, N, K, d)
    jx = jnp.asarray(x)

    def jloss(w):
        return jnp.sum(jq.qkan_layer_forward_quantum(jx, w, N, K, packed) ** 2)

    want_out = jq.qkan_layer_forward_quantum(jx, jnp.asarray(w), N, K, packed)
    want_g = jax.grad(jloss)(jnp.asarray(w))
    wt = _t(w).requires_grad_()
    out = q.qkan_layer_forward_quantum(_t(x), wt, N, K, packed=packed)
    close(out, want_out, bar=1e-10)
    close(out, jql.qkan_layer_forward(jx, jnp.asarray(w), N, K), bar=1e-8)
    (g,) = torch.autograd.grad(torch.sum(out**2), [wt])
    close(g, want_g, bar=1e-6)


def test_quantum_layer_n16_k16_batched_matches_jax():
    """The headline size (17-qubit packed circuits), a batch of 2: one
    batched simulation against JAX's vmap, forward and gradient."""
    N = K = 16
    d, B = 7, 2
    rng = np.random.default_rng(7)
    x = rng.uniform(-0.9, 0.9, (B, N))
    w = rng.uniform(-0.9, 0.9, (d + 1, N * K))
    jx = jnp.asarray(x)

    def jloss(w):
        return jnp.sum(jq.qkan_layer_forward_quantum_batched(jx, w, N, K) ** 2)

    want_out = jq.qkan_layer_forward_quantum_batched(jx, jnp.asarray(w), N, K)
    want_g = jax.grad(jloss)(jnp.asarray(w))
    wt = _t(w).requires_grad_()
    out = q.qkan_layer_forward_quantum_batched(_t(x), wt, N, K)
    close(out, want_out, bar=1e-10)
    (g,) = torch.autograd.grad(torch.sum(out**2), [wt])
    close(g, want_g, bar=1e-6)
    close(g, jax.grad(lambda w: jnp.sum(
        jql.qkan_layer_forward_batched(jx, w, N, K) ** 2))(jnp.asarray(w)),
          bar=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_extractions_match_jax(dtype):
    jd = {torch.float32: jnp.float32, torch.float64: jnp.float64}[dtype]
    bar = {torch.float32: 1e-6, torch.float64: 1e-10}[dtype]
    rng = np.random.default_rng(6)
    diag = rng.uniform(-1, 1, 16)
    for fn, jfn in ((q.quantum_extract_diag, jq.quantum_extract_diag),
                    (q.quantum_extract_diag_packed,
                     jq.quantum_extract_diag_packed)):
        got = fn(_t(diag, dtype))
        assert got.dtype == dtype
        close(got, jfn(jnp.asarray(diag, jd)).astype(jd), bar=bar)
    # alpha > 1 rescale, and a batch of diagonals as one simulation each
    diag = np.array([[2.0, -3.0, 0.5, 1.0], [0.1, 0.2, -0.3, 0.4]])
    for fn, jfn in ((q.quantum_extract_diag, jq.quantum_extract_diag),
                    (q.quantum_extract_diag_packed,
                     jq.quantum_extract_diag_packed)):
        close(fn(_t(diag, dtype)), jax.vmap(jfn)(jnp.asarray(diag, jd)),
              bar=bar)


def test_fable_diag_angles_match_jax_at_ties():
    """alpha's max and the clip tie where two entries share max|d| and the
    scaled entry lands on the clip bound: values and gradients as JAX
    gives them (ties split the gradient evenly)."""
    for diag, dtype in (([1.5, 0.3, -1.5, 0.7], torch.float64),
                        ([1.5, 0.3, -0.2, 0.7], torch.float32),
                        ([0.5, -0.25, 0.125, 0.0], torch.float64)):
        jd = jnp.float32 if dtype == torch.float32 else jnp.float64
        circ, alpha = q.fable_diag_traced(_t(diag, dtype))
        jcirc, jalpha = jq.fable_diag_traced(jnp.asarray(diag, jd))
        bar = 1e-6 if dtype == torch.float32 else 1e-12
        close(alpha, jalpha, bar=0.0)
        # the angles: XLA's arccos and torch's may differ in the last ulp
        close(circ.gates[circ.num_qubits // 2].params,
              jcirc.gates[jcirc.num_qubits // 2].params, bar=bar)
        w = np.linspace(0.1, 1.0, 16)

        def jloss(d):
            flat, a = jq._diag_angles(d)
            return jnp.sum(flat * jnp.asarray(w, jd)) + a

        leaf = _t(diag, dtype).requires_grad_()
        flat, a = q._diag_angles(leaf)
        (g,) = torch.autograd.grad(torch.sum(flat * _t(w, dtype)) + a, [leaf])
        close(g, jax.grad(jloss)(jnp.asarray(diag, jd)), bar=1e-6)


def test_quantum_grad_finite_f32_at_saturation():
    """The JAX suite's f32 saturation case (|d| >= 1 activates alpha): the
    gradient stays finite and matches JAX's; the round trip is within f32
    rounding."""
    diag = np.array([1.5, 0.3, -0.2, 0.7], dtype=np.float32)

    def jloss(d):
        return jnp.sum(jq.quantum_extract_diag_packed(d) ** 2)

    want_g = jax.grad(jloss)(jnp.asarray(diag))
    leaf = _t(diag, torch.float32).requires_grad_()
    rec = q.quantum_extract_diag_packed(leaf)
    (g,) = torch.autograd.grad(torch.sum(rec**2), [leaf])
    assert g.dtype == torch.float32 and bool(torch.isfinite(g).all())
    close(g, want_g, bar=1e-6)
    np.testing.assert_allclose(array_to_numpy(rec), diag, atol=1e-4)


def test_block_columns_match_jax_and_take_integer_input():
    rng = np.random.default_rng(8)
    a = rng.uniform(-1, 1, (6, 5))  # non-square, non-pow2 -> padded to 8x8
    rec, circ, alpha = q.quantum_extract_block_columns(
        a, chunk=3, return_encoding=True, device="cpu")
    close(rec, jq.quantum_extract_block_columns(a, chunk=3), bar=1e-12)
    np.testing.assert_allclose(rec, a, atol=1e-10)
    assert circ.num_qubits == 7 and alpha == 1.0
    out = q.quantum_extract_block_columns(np.eye(4, dtype=np.int64),
                                          device="cpu")
    assert np.issubdtype(out.dtype, np.floating)
    np.testing.assert_allclose(out, np.eye(4), atol=1e-6)


def test_verify_pipeline_matches_jax():
    N = K = 2
    x, w = _layer_inputs(4, N, K, 2)
    got = q.quantum_verify_pipeline(_t(x), _t(w), N, K)
    want = jq.quantum_verify_pipeline(jnp.asarray(x), jnp.asarray(w), N, K)
    assert set(got) == set(want)
    for stage, err in got.items():
        assert err < 1e-6, (stage, err)
        assert abs(err - want[stage]) < 1e-12, (stage, err, want[stage])


def test_quantum_layer_batch_is_one_rotation(monkeypatch):
    """A batch of B samples is one batched state: the rotation runs once
    (through K8's function, its plain version on the CPU)."""
    calls = []
    orig = pk.ucry_msb_pallas
    N = K = 4
    x, w = _layer_inputs(9, N, K, 2, (5,))
    monkeypatch.setattr(pk, "ucry_msb_pallas",
                        lambda *a: calls.append(a[0].shape) or orig(*a))
    q.qkan_layer_forward_quantum_batched(_t(x), _t(w), N, K)
    assert calls == [torch.Size([5, 2**9])]


def test_sharded_quantum_paths_are_not_ported():
    """The sharded paths no longer raise (the name predates their port):
    on 8 CPU slots they give the dense paths' values
    (``tests/test_torch_sharded.py`` holds them against JAX)."""
    from qkan_implementation_tpu_torch.parallel import make_mesh

    mesh = make_mesh(8, devices=["cpu"] * 8)
    N = K = 4
    x, w = _layer_inputs(10, N, K, 2)
    close(q.qkan_layer_forward_quantum_sharded(_t(x), _t(w), N, K, mesh),
          q.qkan_layer_forward_quantum(_t(x), _t(w), N, K).numpy())
    d = _t(np.random.default_rng(11).uniform(-1, 1, 16))
    close(q.quantum_extract_diag_packed_sharded(d, mesh, "rdma"),
          q.quantum_extract_diag_packed(d).numpy())


# -- models/qsvt_neuron.py ---------------------------------------------------------------


def test_qsvt_neuron_matches_jax():
    x = np.linspace(-1, 1, 20).reshape(-1, 1)
    y = 0.5 * x**2 + 0.3 * x + 0.1
    got = compare_classical_quantum(x, y, input_dim=1, max_degree=2,
                                    device="cpu")
    want = jcompare(x, y, input_dim=1, max_degree=2)
    assert got[0] < 1e-10 and got[1] < 1e-6
    assert abs(got[1] - want[1]) < 1e-12
    assert got[2] == want[2]
    neuron = QSVTNeuron(input_dim=1, max_degree=2, device="cpu")
    with pytest.raises(RuntimeError):
        neuron.forward(np.zeros((2, 1)))
