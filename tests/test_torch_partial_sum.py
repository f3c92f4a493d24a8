"""The plain version of the fixed-order partial-sum pass
(``ops.fused_layer.fixed_order_sum_reference``), on the CPU: the order in
which the CUDA pass of ``csrc/partial_sum.cu`` sums per-block partials
[nblk, per] over their first axis (``segments`` runs of ceil(nblk /
segments) partials, each summed in block order, then the run sums in run
order).  The kernel itself is held to this version bit for bit on the card
(``tests/test_torch_cuda_layer_m3.py``, ``test_torch_cuda_kernels.py``,
``test_torch_cuda_step.py``).

Bars:
- against the float64 sum: any order of f32 additions of n terms is
  within gamma_{n-1} sum|x_i| of the exact sum, and gamma_{n-1} <= n 2^-24
  at these n: the bar is nblk 2^-24 sum_b |part[b, i]|, per element;
- against ``torch.sum(part, 0)`` (another order): twice that;
- with one segment the order is the in-order loop: equal bit for bit;
- through the backwards: per-row-block partials of the port's plain M3
  and K2 backwards, summed in the pass's order, against the JAX package's
  backward (interpret mode) at the shapes and bars of the existing parity
  tests (``test_torch_pallas_layer.py``: dM atol 1e-5 over max(1, max);
  ``test_torch_fused_layer.py``: rtol 1e-5 / atol 1e-6 on dW over its
  max), reusing their inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qkan_implementation_tpu.experimental import pallas_layer as jpl
from qkan_implementation_tpu.ops.fused_layer import (
    kan_layer_fused_dw as jax_fused_dw,
)
from qkan_implementation_tpu_torch.experimental.pallas_layer import (
    qkan_layer_fused_bwd_reference,
)
from qkan_implementation_tpu_torch.ops.fused_layer import (
    fixed_order_sum_reference,
    kan_layer_fused_dw_bwd_reference,
)
from test_torch_fused_layer import (
    CASES as DW_CASES,
    _assert_bar,
    _cotangent,
    _ids,
    _inputs as _dw_inputs,
    _jax_vjp as _dw_jax_vjp,
    _tanh_agreeing,
)
from test_torch_pallas_layer import _close, _jax_vjp as _m3_jax_vjp, _setup

# partials of the kernels' main shapes: 1 (B = 1), 2 (layer 0, B = 64),
# 26 (layer 0, B = 4096), 264 (the M3 headline), 547 (the K5 headline
# workspace); widths 1, 3 (no multiple of 4), 2048 (the M3 headline's dM),
# 47040 (layer 0's dW)
SUM_CASES = [(nblk, per, segments)
             for nblk in (1, 2, 26, 264, 547)
             for per in (1, 3, 2048, 47040)
             for segments in (1, 2, 8, 32) if segments <= nblk]
ROWS = 16  # rows a block in the backward tests below


@pytest.fixture(autouse=True)
def one_thread():
    """The reference's many small adds run faster on one thread than
    spread over a CPU's: each case stays under a second."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("nblk,per,segments", SUM_CASES)
def test_fixed_order_sum_matches_float64_and_torch_sum(nblk, per, segments):
    rng = np.random.default_rng(nblk * 7 + per + segments)
    part = rng.random((nblk, per), dtype=np.float32) - np.float32(0.5)
    got = fixed_order_sum_reference(torch.from_numpy(part), segments)
    assert got.dtype == torch.float32 and got.shape == (per,)
    got = got.numpy()
    bar = nblk * 2.0**-24 * np.abs(part).sum(axis=0, dtype=np.float64)
    assert np.all(np.abs(got - part.sum(axis=0, dtype=np.float64)) <= bar)
    torch_sum = torch.from_numpy(part).sum(dim=0).numpy()
    assert np.all(np.abs(got.astype(np.float64) - torch_sum) <= 2 * bar)
    if segments == 1:
        loop = np.zeros(per, dtype=np.float32)
        for b in range(nblk):
            loop = loop + part[b]
        assert np.array_equal(got.view(np.uint32), loop.view(np.uint32))


def test_fixed_order_sum_rejects_segments_out_of_range():
    part = torch.ones(4, 3)
    for segments in (0, 5):
        with pytest.raises(ValueError, match="segments"):
            fixed_order_sum_reference(part, segments)
    # as many segments as partials: one partial each, in order
    assert torch.equal(fixed_order_sum_reference(part, 4),
                       fixed_order_sum_reference(part, 1))


def _row_blocks(b):
    return [(r, min(b, r + ROWS)) for r in range(0, b, ROWS)]


@pytest.mark.parametrize("B,N,K,deg,seed", [
    (64, 4, 3, 5, 0), (48, 4, 3, 6, 3), (100, 3, 2, 3, 5), (96, 16, 16, 7, 1),
])
def test_m3_backward_through_block_partials_matches_jax(B, N, K, deg, seed):
    """dM as the card forms it: the plain K14 backward on each row block,
    the partials summed in the pass's order, against ``jax.vjp``."""
    x, w, N, K = _setup(B, N, K, deg, seed)
    m3 = np.asarray(jpl.weights_to_m3(jnp.asarray(w), N, K))
    g = np.random.default_rng(seed + 100).normal(size=(B, K))
    g = g.astype(np.float32)
    _, _, jdm = _m3_jax_vjp(x, m3, g)
    xt, mt, gt = map(torch.from_numpy, (x, m3, g))
    part = torch.stack([
        qkan_layer_fused_bwd_reference(xt[r0:r1], mt, gt[r0:r1], False)[1]
        for r0, r1 in _row_blocks(B)])
    whole = qkan_layer_fused_bwd_reference(xt, mt, gt, False)[1]
    for segments in sorted({1, 2, part.shape[0]}):
        dm = fixed_order_sum_reference(part, segments)
        assert dm.dtype == torch.float32 and dm.shape == mt.shape
        _close(dm, jdm, 1e-5)
        _close(dm, whole, 1e-5)


@pytest.mark.parametrize("case", DW_CASES, ids=_ids)
def test_k2_backward_through_block_partials_matches_jax(case):
    """dW as the card forms it: the plain K2 backward on each row block
    gives the dW_d partials and the colsum(g) partial; both are summed in
    the pass's order, colsum(g) once and written to every row of dW_0."""
    x, w2 = _dw_inputs(case, seed=8)
    x = _tanh_agreeing(x)
    b, n, dp1, t_dim, tanh = case
    g = _cotangent(b, t_dim)
    _, _, jdw = _dw_jax_vjp(
        lambda xx, ww: jax_fused_dw(xx, ww, dp1, True, tanh, "high"),
        x, w2, g, False,
    )
    xt, wt, gt = map(torch.from_numpy, (x, w2, g))
    blocks = [kan_layer_fused_dw_bwd_reference(xt[r0:r1], wt, gt[r0:r1],
                                               dp1, tanh)[1]
              for r0, r1 in _row_blocks(b)]
    part = torch.stack([d[n:].reshape(-1) for d in blocks])
    gpart = torch.stack([d[0] for d in blocks])  # colsum(g) of the block
    for segments in sorted({1, 2, len(blocks)}):
        dw = torch.cat([
            fixed_order_sum_reference(gpart, segments).expand(n, -1),
            fixed_order_sum_reference(part, segments).view(-1, t_dim),
        ])
        assert dw.shape == w2.shape
        _assert_bar(dw.numpy(), jdw, False)
