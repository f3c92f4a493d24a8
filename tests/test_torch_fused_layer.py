"""ops/fused_layer of the torch port (the plain versions of the kernels,
which CPU tensors take) against the JAX package's ``kan_layer_fused_dw``
and ``kan_layer_fused`` in Pallas interpret mode, on the same numpy
inputs: forwards, and backwards against ``jax.vjp``.

Bars:
- 'high' / 'default': float32 on both sides, the same recurrence and fold;
  only the summation order of the f32 products and tanh's last ulp
  differ: rtol 1e-5, atol 1e-6 (outputs are O(1)).
- 'bf16': both sides round T_d and W_d (d >= 1) to bf16 before each
  product and accumulate in f32; with a bf16 x, tanh and every recurrence
  op round to bf16 too.  So they differ by the f32 summation order, as
  'high' does, except where XLA's tanh and torch's land one f32 ulp apart
  and flip the bf16 rounding of one T_d: that moves the output by about
  |W_d| * 2^-8 (1.09e-4 at the 96x24x6x32 case with an f32 x, under its
  bar of 2.79e-4).  Bar: 1e-4 max|out| + 1e-5.  Control: where dp1 > 1,
  'bf16' must differ from 'high' on the same x by more than that bar (by
  about 10x here), so a version that skips the rounding fails.
- backwards (dx and dW, each against its own max): float32 x, rtol 1e-5
  / atol 1e-6 (dW is O(B) at these shapes, so the bars are taken on the
  outputs divided by their max); bfloat16 x, 1e-4 max + 1e-5, as the
  forward.  With a bf16 x the JAX function is compiled with
  ``xla_allow_excess_precision=False``: by default XLA's CPU compiler
  drops a bf16 rounding wherever the value is widened again (measured:
  tanh of a bf16 x came out of the interpret kernel unrounded, 1.9e-3
  from the bf16 value), which is not the bf16 arithmetic the JAX code
  writes.  With the flag both sides round every op to bf16 and dx (bf16)
  agrees to within 9.5e-7.  XLA's f32 tanh and torch's differ in the
  last ulp on 57% of these inputs, and where that flips the bf16 rounding
  of one T_d, 'bf16' dW moves by up to 2^-8 |g| (measured 3.9e-3 against
  a bar of 2.9e-3 at 96x24x6x32).  So the backward tests draw each f32 x
  again, from the same range, until the two tanhs agree: they hold the
  rounding points of the backward, and the forward tests above hold tanh.
- hand derivation: each plain backward against ``torch.autograd`` of the
  v1 plain forward in float64 (the same function); the hand backward's
  products are f32, as the TPU kernels' are: 1e-5 max + 1e-6.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import jax

from qkan_implementation_tpu.ops.fused_layer import (
    kan_layer_fused as jax_fused,
    kan_layer_fused_dw as jax_fused_dw,
)
from qkan_implementation_tpu_torch.ops.fused_layer import (
    _resolve_mode,
    kan_layer_fused,
    kan_layer_fused_bwd_reference,
    kan_layer_fused_dw,
    kan_layer_fused_dw_bwd_reference,
    kan_layer_fused_dw_reference,
    kan_layer_fused_reference,
)

# the four shape cases of test_fused_layer.py's degree-wise parity test
CASES = [
    (96, 24, 6, 32, True),
    (64, 16, 8, 16, False),
    (40, 8, 1, 4, True),  # dp1 = 1: colsum(W_0) only
    (33, 5, 2, 3, True),  # batch that is no multiple of any tile
]


def _inputs(case, seed=5):
    b, n, dp1, t_dim, tanh = case
    rng = np.random.default_rng(seed)
    lo, hi = (-2, 2) if tanh else (-0.95, 0.95)
    x = rng.uniform(lo, hi, (b, n)).astype(np.float32)
    # weights scaled so every output is O(1): the f32 bars below are
    # absolute at that scale
    w2 = rng.normal(0, 1 / np.sqrt(dp1 * n), (dp1 * n, t_dim))
    w2 = w2.astype(np.float32)
    return x, w2


def _jax(x, w2, dp1, tanh, precision, bf16_x=False):
    xj = jnp.asarray(x, dtype=jnp.bfloat16 if bf16_x else jnp.float32)
    return np.asarray(
        jax_fused_dw(xj, jnp.asarray(w2), dp1, True, tanh, precision)
    )


def _ids(case):
    return "x".join(map(str, case[:4]))


@pytest.mark.parametrize("case", CASES, ids=_ids)
@pytest.mark.parametrize("precision", ["high", "default"])
def test_plain_version_matches_jax_interpret(case, precision):
    x, w2 = _inputs(case)
    _, _, dp1, t_dim, tanh = case
    got = kan_layer_fused_dw(
        torch.from_numpy(x), torch.from_numpy(w2), dp1, tanh, precision
    )
    assert got.dtype == torch.float32 and got.shape == (x.shape[0], t_dim)
    np.testing.assert_allclose(
        got.numpy(), _jax(x, w2, dp1, tanh, precision), rtol=1e-5, atol=1e-6
    )


@pytest.mark.parametrize("case", CASES, ids=_ids)
@pytest.mark.parametrize("bf16_x", [False, True], ids=["f32_x", "bf16_x"])
def test_bf16_mode_matches_jax_interpret(case, bf16_x):
    x, w2 = _inputs(case, seed=6)
    _, _, dp1, t_dim, tanh = case
    xt = torch.from_numpy(x)
    got = kan_layer_fused_dw(
        xt.to(torch.bfloat16) if bf16_x else xt, torch.from_numpy(w2), dp1,
        tanh, "bf16",
    )
    assert got.dtype == torch.float32 and got.shape == (x.shape[0], t_dim)
    want = _jax(x, w2, dp1, tanh, "bf16", bf16_x=bf16_x)
    bar = 1e-4 * np.abs(want).max() + 1e-5
    assert np.abs(got.numpy() - want).max() <= bar
    if dp1 > 1:
        high = kan_layer_fused_dw(
            xt.to(torch.bfloat16) if bf16_x else xt, torch.from_numpy(w2),
            dp1, tanh, "high",
        )
        assert np.abs(got.numpy() - high.numpy()).max() > bar


def test_wrapper_takes_plain_version_on_cpu_without_launching():
    x, w2 = _inputs(CASES[0])
    before = kan_layer_fused_dw.launches
    got = kan_layer_fused_dw(torch.from_numpy(x), torch.from_numpy(w2), 6)
    want = kan_layer_fused_dw_reference(
        torch.from_numpy(x), torch.from_numpy(w2), 6
    )
    assert torch.equal(got, want)
    assert kan_layer_fused_dw.launches == before == 0


def test_unknown_precision_raises_like_jax():
    x = torch.zeros((8, 4))
    w2 = torch.zeros((8, 2))
    with pytest.raises(ValueError, match="precision"):
        kan_layer_fused_dw(x, w2, 2, True, "bf32")
    with pytest.raises(ValueError, match="precision"):
        jax_fused_dw(jnp.asarray(x.numpy()), jnp.asarray(w2.numpy()), 2,
                     True, True, "bf32")
    assert _resolve_mode("high") == _resolve_mode("default") == "plain"
    assert _resolve_mode("bf16") == "bf16"


# -- backwards and the v1 pair ----------------------------------------------


def _cotangent(b, t_dim, seed=7):
    return np.random.default_rng(seed).normal(0, 1, (b, t_dim)).astype(
        np.float32
    )


def _jax_vjp(fn, x, w2, g, bf16_x):
    """(out, dx, dw) of the JAX function at these inputs, in interpret
    mode, compiled without XLA's excess precision (module docstring)."""
    xj = jnp.asarray(x, dtype=jnp.bfloat16 if bf16_x else jnp.float32)

    def both(xx, ww, gg):
        out, vjp = jax.vjp(fn, xx, ww)
        return (out,) + vjp(gg)

    args = (xj, jnp.asarray(w2), jnp.asarray(g))
    comp = jax.jit(both).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False}
    )
    return [np.asarray(a.astype(jnp.float32)) for a in comp(*args)]


def _assert_bar(got, want, bf16):
    """F32: rtol 1e-5 / atol 1e-6 on the outputs over their max; bf16:
    1e-4 max + 1e-5."""
    got = np.asarray(got, dtype=np.float32)
    scale = np.abs(want).max()
    if bf16:
        assert np.abs(got - want).max() <= 1e-4 * scale + 1e-5
    else:
        scale = max(scale, 1.0)
        np.testing.assert_allclose(got / scale, want / scale, rtol=1e-5,
                                   atol=1e-6)


def _tanh_agreeing(x, seed=0):
    """x drawn again, from its own range, where XLA's tanh and torch's
    differ."""
    x = x.copy()
    rng = np.random.default_rng(seed)
    lo, hi = float(x.min()), float(x.max())
    for _ in range(200):
        bad = np.asarray(jnp.tanh(jnp.asarray(x))) != torch.tanh(
            torch.from_numpy(x)
        ).numpy()
        if not bad.any():
            return x
        x[bad] = rng.uniform(lo, hi, int(bad.sum())).astype(np.float32)
    raise AssertionError("no tanh-agreeing inputs")


def _torch_x(x, bf16_x):
    xt = torch.from_numpy(x)
    return xt.to(torch.bfloat16) if bf16_x else xt


@pytest.mark.parametrize("case", CASES, ids=_ids)
@pytest.mark.parametrize("precision", ["high", "default", "bf16"])
@pytest.mark.parametrize("bf16_x", [False, True], ids=["f32_x", "bf16_x"])
def test_dw_backward_matches_jax_vjp(case, precision, bf16_x):
    x, w2 = _inputs(case, seed=8)
    x = _tanh_agreeing(x)
    b, _, dp1, t_dim, tanh = case
    g = _cotangent(b, t_dim)
    _, jdx, jdw = _jax_vjp(
        lambda xx, ww: jax_fused_dw(xx, ww, dp1, True, tanh, precision),
        x, w2, g, bf16_x,
    )
    dx, dw = kan_layer_fused_dw_bwd_reference(
        _torch_x(x, bf16_x), torch.from_numpy(w2), torch.from_numpy(g), dp1,
        tanh, precision,
    )
    assert dx.dtype == (torch.bfloat16 if bf16_x else torch.float32)
    assert dw.dtype == torch.float32 and dw.shape == w2.shape
    bf16 = bf16_x or precision == "bf16"
    _assert_bar(dx.float().numpy(), jdx, bf16)
    _assert_bar(dw.numpy(), jdw, bf16)
    if precision == "bf16" and dp1 > 1:
        # control: the 'bf16' dW moves from the 'high' one by more than
        # the bar, so a version that skips the rounding fails
        _, dw_high = kan_layer_fused_dw_bwd_reference(
            _torch_x(x, bf16_x), torch.from_numpy(w2), torch.from_numpy(g),
            dp1, tanh, "high",
        )
        gap = np.abs(dw.numpy() - dw_high.numpy()).max()
        assert gap > 1e-4 * np.abs(jdw).max() + 1e-5


@pytest.mark.parametrize("case", CASES, ids=_ids)
@pytest.mark.parametrize("precision", ["high", "default"])
@pytest.mark.parametrize("bf16_x", [False, True], ids=["f32_x", "bf16_x"])
def test_v1_forward_and_backward_match_jax(case, precision, bf16_x):
    x, w2 = _inputs(case, seed=9)
    x = _tanh_agreeing(x)
    b, _, dp1, t_dim, tanh = case
    g = _cotangent(b, t_dim, seed=10)
    jout, jdx, jdw = _jax_vjp(
        lambda xx, ww: jax_fused(xx, ww, dp1, True, tanh, precision),
        x, w2, g, bf16_x,
    )
    xt = _torch_x(x, bf16_x)
    out = kan_layer_fused(xt, torch.from_numpy(w2), dp1, tanh, precision)
    assert out.dtype == torch.float32 and out.shape == (b, t_dim)
    _assert_bar(out.numpy(), jout, bf16_x)
    dx, dw = kan_layer_fused_bwd_reference(
        xt, torch.from_numpy(w2), torch.from_numpy(g), dp1, tanh, precision
    )
    assert dx.dtype == xt.dtype and dw.dtype == torch.float32
    _assert_bar(dx.float().numpy(), jdx, bf16_x)
    _assert_bar(dw.numpy(), jdw, bf16_x)
    if bf16_x and dp1 > 1:
        # control: the v1 forward rounds all of w2 (W_0 too) for a bf16
        # x, the degree-wise 'high' forward none of it
        dw_out = kan_layer_fused_dw(xt, torch.from_numpy(w2), dp1, tanh)
        gap = np.abs(out.numpy() - dw_out.numpy()).max()
        assert gap > 1e-4 * np.abs(jout).max() + 1e-5


@pytest.mark.parametrize("case", CASES, ids=_ids)
@pytest.mark.parametrize("v1", [False, True], ids=["dw", "v1"])
def test_plain_backward_matches_autograd_float64(case, v1):
    x, w2 = _inputs(case, seed=11)
    b, _, dp1, t_dim, tanh = case
    g = torch.from_numpy(_cotangent(b, t_dim, seed=12)).double()
    x64 = torch.from_numpy(x).double().requires_grad_()
    w64 = torch.from_numpy(w2).double().requires_grad_()
    out = kan_layer_fused_reference(x64, w64, dp1, tanh).double()
    want_dx, want_dw = torch.autograd.grad(out, (x64, w64), g,
                                           allow_unused=True)
    if want_dx is None:  # dp1 = 1: the output does not depend on x
        want_dx = torch.zeros_like(x64)
    bwd = (kan_layer_fused_bwd_reference if v1
           else kan_layer_fused_dw_bwd_reference)
    dx, dw = bwd(x64.detach(), w64.detach(), g, dp1, tanh)
    for got, want in ((dx, want_dx), (dw, want_dw)):
        want = want.numpy()
        bar = 1e-5 * np.abs(want).max() + 1e-6
        assert np.abs(got.double().numpy() - want).max() <= bar


@pytest.mark.parametrize("v1", [False, True], ids=["dw", "v1"])
def test_wrapper_backward_runs_plain_backward_on_cpu(v1):
    """On a CPU tensor the autograd Function runs the hand-written plain
    backward (not autograd's derivative) and launches nothing."""
    x, w2 = _inputs(CASES[0], seed=13)
    b, _, dp1, t_dim, tanh = CASES[0]
    g = torch.from_numpy(_cotangent(b, t_dim))
    layer = kan_layer_fused if v1 else kan_layer_fused_dw
    bwd = (kan_layer_fused_bwd_reference if v1
           else kan_layer_fused_dw_bwd_reference)
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w2).requires_grad_()
    out = layer(xt, wt, dp1, tanh)
    assert out.grad_fn is not None
    out.backward(g)
    dx, dw = bwd(xt.detach(), wt.detach(), g, dp1, tanh)
    assert torch.equal(xt.grad, dx) and torch.equal(wt.grad, dw)
    # w2 alone needs a gradient: the Function still returns dW
    wt.grad = None
    layer(xt.detach(), wt, dp1, tanh).backward(g)
    assert torch.equal(wt.grad, dw)
    assert (layer.launches, layer.bwd_launches) == (0, 0)


def test_v1_rejects_bf16_precision_like_jax():
    x = torch.zeros((8, 4))
    w2 = torch.zeros((8, 2))
    for fn in (kan_layer_fused, kan_layer_fused_reference):
        with pytest.raises(ValueError, match="'high' or 'default'"):
            fn(x, w2, 2, True, "bf16")
    with pytest.raises(ValueError, match="precision"):
        jax_fused(jnp.asarray(x.numpy()), jnp.asarray(w2.numpy()), 2, True,
                  True, "bf16")
