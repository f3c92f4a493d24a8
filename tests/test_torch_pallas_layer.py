"""The batched QKAN layer over M3 in the torch port (its plain versions,
which CPU tensors take, forward and hand-written backward) against the JAX
package's ``experimental.pallas_layer`` in Pallas interpret mode, on the
same numpy inputs.

Bars: the JAX suite's own (tests/test_pallas_layer.py): forward atol 1e-5,
gradients atol 1e-4, dM atol 1e-5, loss rtol 1e-6, taken on the outputs
over max(1, their max) where the values grow past 1 (x in [-2, 2]).  A
bf16 x: both sides round the recurrences to bf16 at the same points (the
JAX side compiled with ``xla_allow_excess_precision=False``, as in
test_torch_fused_layer.py) and take f32 products, so the f32 sums differ
only in their order; out and dx are rounded to bf16 once from those sums
and are held at 1e-4 max + 1e-5 with at most one element one bf16 step
off.  float64 (torch's default dtype float64, JAX x64): both sides
multiply in f64 and round the contractions to f32 (JAX's
``preferred_element_type``), so they agree to 1e-12 relative.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from qkan_implementation_tpu.experimental import pallas_layer as jpl
from qkan_implementation_tpu.ops.qkan_layer import (
    qkan_layer_forward_batched as jax_batched,
)
from qkan_implementation_tpu_torch.experimental import pallas_layer as tpl
from qkan_implementation_tpu_torch.experimental.pallas_layer import (
    m3_dm_partial_sum,
    qkan_layer_forward_batched_fused,
    qkan_layer_fused,
    qkan_layer_fused_bwd_reference,
    qkan_layer_fused_dw,
    qkan_layer_fused_reference,
    weights_to_m3,
)
from qkan_implementation_tpu_torch.ops import qkan_layer as tql
from qkan_implementation_tpu_torch.ops import qkan_layer_forward_batched


def _setup(B=64, N=4, K=3, deg=5, seed=0, lo=-1.0, hi=1.0):
    """tests/test_pallas_layer.py's inputs, as float32 numpy."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(lo, hi, (B, N)).astype(np.float32)
    w = (rng.standard_normal((deg + 1, N * K)) * 0.3).astype(np.float32)
    return x, w, N, K


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _close(got, want, atol):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= atol * scale, (err, atol * scale)


def _jax_vjp(x, m3, g, bf16=False):
    """(out, dx, dm) of the JAX layer's custom VJP in interpret mode; a
    bf16 x is compiled without XLA's excess precision."""
    xj = jnp.asarray(x, dtype=jnp.bfloat16 if bf16 else x.dtype)

    def both(xx, mm, gg):
        out, vjp = jax.vjp(lambda a, b: jpl.qkan_layer_fused(a, b, True),
                           xx, mm)
        return (out, *vjp(gg.astype(out.dtype)))

    args = (xj, jnp.asarray(m3), jnp.asarray(g))
    comp = jax.jit(both).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False}
    )
    return [np.asarray(a.astype(jnp.float64)) for a in comp(*args)]


def _held_bf16(got, want):
    """1e-4 max + 1e-5, one element at most one bf16 step (2^-8 of its
    value) beyond it."""
    got = np.asarray(got, dtype=np.float64)
    bar = 1e-4 * np.abs(want).max() + 1e-5
    over = np.abs(got - want) > bar
    assert over.sum() <= 1
    assert np.all(np.abs(got - want)[over] <= 2.0**-7 * np.abs(want)[over])


# -- the four JAX tests, mirrored -------------------------------------------


def test_fused_forward_matches_batched():
    x, w, N, K = _setup()
    got = qkan_layer_forward_batched_fused(_t(x), _t(w), N, K, interpret=True)
    assert got.dtype == torch.float32 and got.shape == (64, K)
    want = jpl.qkan_layer_forward_batched_fused(jnp.asarray(x), jnp.asarray(w),
                                                N, K, interpret=True)
    _close(got.detach(), want, 1e-5)
    _close(got.detach(), jax_batched(jnp.asarray(x), jnp.asarray(w), N, K),
           1e-5)


def test_fused_vjp_matches_xla_grads():
    """Chained through ``weights_to_m3``, the port's backward gives the
    batched layer's gradients in (x, w)."""
    x, w, N, K = _setup(B=32, deg=4)
    xt, wt = _t(x, True), _t(w, True)
    loss = torch.sum(qkan_layer_fused(xt, weights_to_m3(wt, N, K)) ** 2)
    loss.backward()

    def loss_ref(xx, ww):
        return jnp.sum(jax_batched(xx, ww, N, K) ** 2)

    def loss_fused(xx, ww):
        return jnp.sum(jpl.qkan_layer_fused(
            xx, jpl.weights_to_m3(ww, N, K), True) ** 2)

    xj, wj = jnp.asarray(x), jnp.asarray(w)
    np.testing.assert_allclose(loss.item(), float(loss_ref(xj, wj)),
                               rtol=1e-6)
    for fn in (loss_ref, loss_fused):
        gx, gw = jax.grad(fn, argnums=(0, 1))(xj, wj)
        _close(xt.grad, gx, 1e-4)
        _close(wt.grad, gw, 1e-4)


def test_dw_only_backward_matches_full_dm_and_zero_dx():
    x, w, N, K = _setup(B=48, deg=6, seed=3)
    m3 = weights_to_m3(_t(w), N, K)
    x_full, m_full = _t(x, True), m3.clone().requires_grad_()
    x_dw, m_dw = _t(x, True), m3.clone().requires_grad_()
    out_full = qkan_layer_fused(x_full, m_full)
    out_dw = qkan_layer_fused_dw(x_dw, m_dw)
    assert torch.equal(out_full, out_dw)
    torch.sum(out_full**2).backward()
    torch.sum(out_dw**2).backward()
    _close(m_dw.grad, m_full.grad, 1e-5)
    assert torch.all(x_dw.grad == 0.0) and x_dw.grad.dtype == torch.float32
    assert torch.any(x_full.grad != 0.0)
    # and the JAX dw-only backward
    m3j = jpl.weights_to_m3(jnp.asarray(w), N, K)
    gx, gm = jax.grad(
        lambda a, b: jnp.sum(jpl.qkan_layer_fused_dw(a, b, True) ** 2),
        argnums=(0, 1),
    )(jnp.asarray(x), m3j)
    _close(m_dw.grad, gm, 1e-5)
    assert np.all(np.asarray(gx) == 0.0)


def test_fused_padding_path():
    """B = 100 with N = 3, K = 2: the JAX kernel pads to its tile; the
    port takes the rows as they are."""
    x, w, N, K = _setup(B=100, N=3, K=2, deg=3, seed=5)
    got = qkan_layer_forward_batched_fused(_t(x), _t(w), N, K)
    want = jpl.qkan_layer_forward_batched_fused(jnp.asarray(x), jnp.asarray(w),
                                                N, K, interpret=True)
    _close(got, want, 1e-5)
    _close(got, jax_batched(jnp.asarray(x), jnp.asarray(w), N, K), 1e-5)


# -- jax.vjp of qkan_layer_fused in both arguments ---------------------------


@pytest.mark.parametrize("B,N,K,deg,seed", [
    (64, 4, 3, 5, 0), (48, 4, 3, 6, 3), (100, 3, 2, 3, 5), (96, 16, 16, 7, 1),
])
def test_vjp_both_arguments_f32(B, N, K, deg, seed):
    x, w, N, K = _setup(B, N, K, deg, seed)
    m3 = np.asarray(jpl.weights_to_m3(jnp.asarray(w), N, K))
    assert m3.dtype == np.float32
    g = np.random.default_rng(seed + 100).normal(size=(B, K)).astype(np.float32)
    out, dx, dm = _jax_vjp(x, m3, g)
    xt, mt = _t(x, True), _t(m3, True)
    got = qkan_layer_fused(xt, mt)
    got.backward(_t(g))
    _close(got.detach(), out, 1e-5)
    _close(xt.grad, dx, 1e-4)
    _close(mt.grad, dm, 1e-5)
    assert xt.grad.dtype == torch.float32 and mt.grad.dtype == torch.float32


@pytest.mark.parametrize("B,N,K,deg,seed", [
    (64, 4, 3, 5, 0), (100, 3, 2, 3, 5), (96, 16, 16, 7, 1),
])
def test_vjp_both_arguments_bf16_x(B, N, K, deg, seed):
    """bf16 x with f32 M3: out and dx in bf16, dM in f32."""
    x, w, N, K = _setup(B, N, K, deg, seed)
    m3 = np.asarray(jpl.weights_to_m3(jnp.asarray(w), N, K))
    g = np.random.default_rng(seed + 200).normal(size=(B, K)).astype(np.float32)
    gb = torch.from_numpy(g).to(torch.bfloat16)
    out, dx, dm = _jax_vjp(x, m3, gb.float().numpy(), bf16=True)
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    mt = _t(m3, True)
    got = qkan_layer_fused(xt, mt)
    assert got.dtype == torch.bfloat16
    got.backward(gb)
    assert xt.grad.dtype == torch.bfloat16 and mt.grad.dtype == torch.float32
    _held_bf16(got.detach().double().numpy(), out)
    _held_bf16(xt.grad.double().numpy(), dx)
    _close(mt.grad, dm, 1e-5)
    # control: the bf16 recurrences move dM by far more than the bar
    m_f32 = _t(m3, True)
    qkan_layer_fused(xt.detach().float(), m_f32).backward(gb.float())
    gap = float((m_f32.grad - mt.grad).abs().max())
    assert gap > 1e-4 * max(1.0, float(mt.grad.abs().max()))


# -- no clip -----------------------------------------------------------------


def test_unclipped_x_agrees_with_jax_and_not_with_clipping_layer():
    """x in [-2, 2]: the fused layer evaluates the polynomials where the
    batched layer clips x to [-1, 1]; port and JAX agree on it, forward
    and backward."""
    x, w, N, K = _setup(B=64, N=4, K=3, deg=5, seed=11, lo=-2.0, hi=2.0)
    m3 = np.asarray(jpl.weights_to_m3(jnp.asarray(w), N, K))
    g = np.random.default_rng(12).normal(size=(64, K)).astype(np.float32)
    out, dx, dm = _jax_vjp(x, m3, g)
    xt, mt = _t(x, True), _t(m3, True)
    got = qkan_layer_fused(xt, mt)
    got.backward(_t(g))
    _close(got.detach(), out, 1e-5)
    _close(xt.grad, dx, 1e-4)
    _close(mt.grad, dm, 1e-5)
    clipped = qkan_layer_forward_batched(_t(x), _t(w), N, K)
    jax_clipped = jax_batched(jnp.asarray(x), jnp.asarray(w), N, K)
    _close(clipped, jax_clipped, 1e-5)
    gap = float(np.abs(got.detach().numpy() - clipped.numpy()).max())
    assert gap > 1.0  # T_5(2) = 362


# -- float64 -------------------------------------------------------------------


@pytest.fixture
def torch_f64():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


@pytest.mark.parametrize("B,N,K,deg", [(64, 4, 3, 5), (37, 16, 16, 7)])
def test_float64_matches_jax_x64(torch_f64, B, N, K, deg):
    rng = np.random.default_rng(B + deg)
    x = rng.uniform(-1, 1, (B, N))
    w = rng.standard_normal((deg + 1, N * K)) * 0.3
    g = rng.normal(size=(B, K))
    m3 = np.asarray(jpl.weights_to_m3(jnp.asarray(w), N, K))
    assert m3.dtype == np.float64
    out, dx, dm = _jax_vjp(x, m3, g)
    xt, mt = _t(x, True), weights_to_m3(_t(w), N, K).detach()
    mt.requires_grad_()
    got = qkan_layer_fused(xt, mt)
    got.backward(_t(g))
    for a, b in ((got.detach(), out), (xt.grad, dx), (mt.grad, dm)):
        assert a.dtype == torch.float64
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-12 * np.abs(b).max())
    # the contractions round to f32, as JAX's preferred_element_type does
    basis = torch.cat(tpl._cheb_blocks(xt.detach(), deg + 1), dim=1)
    exact = basis @ mt.detach().reshape(-1, K)
    assert torch.equal(got.detach(), exact.float().double())


# -- edges -----------------------------------------------------------------------


def test_dp1_one_matches_jax():
    """D = 0: out = colsum over n of M3[0]; dM[0, n] = colsum(g); dx = 0."""
    x, w, N, K = _setup(B=40, N=5, K=4, deg=0, seed=7)
    m3 = np.asarray(jpl.weights_to_m3(jnp.asarray(w), N, K))
    g = np.random.default_rng(8).normal(size=(40, K)).astype(np.float32)
    out, dx, dm = _jax_vjp(x, m3, g)
    xt, mt = _t(x, True), _t(m3, True)
    got = qkan_layer_fused(xt, mt)
    got.backward(_t(g))
    _close(got.detach(), out, 1e-5)
    assert torch.all(xt.grad == 0.0) and np.all(dx == 0.0)
    _close(mt.grad, dm, 1e-5)
    _close(mt.grad[0, 2], g.sum(axis=0), 1e-5)


def test_empty_batch():
    """B = 0 (JAX's padding refuses it): [0, K] out, dx [0, N], dM zeros,
    in the wrapper's dtypes."""
    m3 = torch.randn(4, 3, 2, dtype=torch.float32, requires_grad=True)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.zeros((0, 3), dtype=dtype, requires_grad=True)
        out = qkan_layer_fused(x, m3)
        assert out.shape == (0, 2) and out.dtype == dtype
        dx, dm = torch.autograd.grad(out.sum(), [x, m3])
        assert dx.shape == (0, 3) and dx.dtype == dtype
        assert torch.equal(dm, torch.zeros_like(m3))
    assert qkan_layer_fused_reference(x.detach(), m3.detach()).shape == (0, 2)


def test_backward_routes_k13_for_x_grad_and_k14_for_data_x(monkeypatch):
    """The backward asks for dx (K13 on the card) only when x needs a
    gradient; a data x, or ``qkan_layer_fused_dw``, takes the dM-only
    backward (K14).  The CPU path launches nothing."""
    calls = []
    real = tpl.qkan_layer_fused_bwd_reference

    def spy(x, m3, g, want_dx=True):
        calls.append(want_dx)
        return real(x, m3, g, want_dx)

    monkeypatch.setattr(tpl, "qkan_layer_fused_bwd_reference", spy)
    x, w, N, K = _setup(B=16)
    m3 = weights_to_m3(_t(w), N, K).detach()
    counts = (qkan_layer_fused.launches, qkan_layer_fused.bwd_launches,
              qkan_layer_fused.bwd_dw_launches, m3_dm_partial_sum.launches)
    for fn, x_grad, want in ((qkan_layer_fused, False, [False]),
                             (qkan_layer_fused, True, [True]),
                             (qkan_layer_fused_dw, True, [False])):
        calls.clear()
        xt, mt = _t(x, x_grad), m3.clone().requires_grad_()
        torch.sum(fn(xt, mt) ** 2).backward()
        assert calls == want
        assert mt.grad is not None
    # trains the weights through weights_to_m3 with x as data
    wt = _t(w, True)
    torch.sum(qkan_layer_forward_batched_fused(_t(x), wt, N, K) ** 2).backward()
    assert wt.grad is not None and bool(torch.any(wt.grad != 0))
    assert (qkan_layer_fused.launches, qkan_layer_fused.bwd_launches,
            qkan_layer_fused.bwd_dw_launches,
            m3_dm_partial_sum.launches) == counts == (0, 0, 0, 0)


def test_bwd_reference_matches_autograd_of_reference():
    """The hand-written backward is the gradient of the plain forward
    (float64, where no rounding point differs)."""
    rng = np.random.default_rng(21)
    x = torch.from_numpy(rng.uniform(-1.5, 1.5, (30, 5))).requires_grad_()
    m3 = torch.from_numpy(rng.normal(size=(7, 5, 6))).requires_grad_()
    g = torch.from_numpy(rng.normal(size=(30, 6)))
    dp1 = m3.shape[0]
    basis = torch.cat(tpl._cheb_blocks(x, dp1), dim=1)
    out = basis @ m3.reshape(dp1 * 5, 6)
    want_dx, want_dm = torch.autograd.grad(out, [x, m3], g)
    dx, dm = qkan_layer_fused_bwd_reference(x.detach(), m3.detach(), g)
    # f32-rounded contractions: 1e-6 of the values' scale
    for a, b in ((dx, want_dx), (dm, want_dm)):
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())
    assert qkan_layer_fused_bwd_reference(x.detach(), m3.detach(), g,
                                          want_dx=False)[0] is None


# -- the headline chain ------------------------------------------------------------


def test_headline_chain_matches_jax():
    """Three steps w <- w - lr grad_w sum(qkan_layer_forward_batched_fused(x_i,
    w)^2) at N = K = 16, degree 7, B = 256, x rotating between a batch and
    its reverse: the port's CPU path against JAX in interpret mode.  lr
    1e-4 moves w about as far at B = 256 as 1e-7 at B = 262144."""
    n = k = 16
    b, deg, lr, steps = 256, 7, 1e-4, 3
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (b, n)).astype(np.float32)
    pool = [x, np.ascontiguousarray(x[::-1])]
    w0 = rng.uniform(-1, 1, (deg + 1, n * k)).astype(np.float32)

    def jax_loss(ww, xx):
        return jnp.sum(jpl.qkan_layer_forward_batched_fused(
            xx, ww, n, k, interpret=True) ** 2)

    grad_j = jax.jit(jax.value_and_grad(jax_loss))
    wt, wj = _t(w0), jnp.asarray(w0)
    losses_t, losses_j = [], []
    for i in range(steps):
        leaf = wt.clone().requires_grad_()
        loss = torch.sum(qkan_layer_forward_batched_fused(
            _t(pool[i % 2]), leaf, n, k) ** 2)
        loss.backward()
        wt = wt - lr * leaf.grad
        lj, gj = grad_j(wj, jnp.asarray(pool[i % 2]))
        wj = wj - lr * gj
        losses_t.append(loss.item())
        losses_j.append(float(lj))
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-5)
    assert losses_t[-1] < losses_t[0]
    moved = float(np.abs(np.asarray(wj) - w0).max())
    err = float(np.abs(wt.numpy() - np.asarray(wj)).max())
    assert err <= 1e-6 * float(np.abs(np.asarray(wj)).max())
    assert moved > 100 * err


# -- the fold's index tensors ---------------------------------------------------


def test_fold_indices_are_uploaded_once_and_usable_under_autograd():
    """``qkan_weight_tensor`` builds its index tensors once per (N, K,
    device); built first under inference_mode, they still serve a call
    that records autograd, and the fold is unchanged."""
    tql._FOLD_INDICES.pop((5, 3, torch.device("cpu")), None)
    w = torch.from_numpy(np.random.default_rng(2).normal(size=(4, 15)))
    with torch.inference_mode():
        first = tql.qkan_weight_tensor(w, 5, 3)
    idx = tql._FOLD_INDICES[(5, 3, torch.device("cpu"))]
    leaf = w.clone().requires_grad_()
    again = tql.qkan_weight_tensor(leaf, 5, 3)
    assert tql._FOLD_INDICES[(5, 3, torch.device("cpu"))] is idx
    assert torch.equal(first, again.detach())
    again.sum().backward()
    # every weight lands in exactly one slot, scaled by 1 / (N (D+1))
    assert torch.allclose(leaf.grad, torch.full_like(w, 1.0 / (5 * 4)))
