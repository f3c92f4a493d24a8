"""ops/fused_layer of the torch port (the plain version of the degree-wise
kernel, which CPU tensors take) against the JAX package's
``kan_layer_fused_dw`` in Pallas interpret mode, on the same numpy inputs.

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
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from qkan_implementation_tpu.ops.fused_layer import (
    kan_layer_fused_dw as jax_fused_dw,
)
from qkan_implementation_tpu_torch.ops.fused_layer import (
    _resolve_mode,
    kan_layer_fused_dw,
    kan_layer_fused_dw_reference,
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
