"""ops/chebyshev of the torch port against the JAX package, float64 on the
CPU.  Both sides run the same recurrence / cos-arccos formula on the same
numpy inputs, so the bar is 1e-12 (float64 rounding only)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from qkan_implementation_tpu.ops import chebyshev as jax_cheb
from qkan_implementation_tpu.ops import qkan_layer as jax_layer
from qkan_implementation_tpu_torch.ops import chebyshev as torch_cheb
from qkan_implementation_tpu_torch.ops import qkan_layer as torch_layer

TOL = 1e-12


def _x(seed, shape, lo=-1.2, hi=1.2):
    return np.random.default_rng(seed).uniform(lo, hi, shape)


def _close(got: torch.Tensor, want):
    assert got.dtype == torch.float64
    np.testing.assert_allclose(
        got.numpy(), np.asarray(want), rtol=TOL, atol=TOL
    )


@pytest.mark.parametrize("degree", [0, 1, 2, 5, 9])
def test_chebyshev_t_and_transform_diagonal(degree):
    x = _x(degree, (7, 5))
    _close(
        torch_cheb.chebyshev_t(torch.from_numpy(x), degree),
        jax_cheb.chebyshev_t(jnp.asarray(x), degree),
    )
    _close(
        torch_cheb.transform_diagonal(torch.from_numpy(x[0]), degree),
        jax_cheb.transform_diagonal(jnp.asarray(x[0]), degree),
    )


@pytest.mark.parametrize("max_degree", [0, 1, 3, 7])
@pytest.mark.parametrize("clip", [True, False])
def test_chebyshev_basis(max_degree, clip):
    x = _x(10 + max_degree, (6, 4))
    got = torch_cheb.chebyshev_basis(torch.from_numpy(x), max_degree, clip)
    assert got.shape == x.shape + (max_degree + 1,)
    _close(got, jax_cheb.chebyshev_basis(jnp.asarray(x), max_degree, clip))


def test_cumulative_transform_layout():
    x = _x(3, (5, 3), -2.0, 2.0)  # unclipped by default: outside [-1, 1]
    got = torch_cheb.cumulative_transform(torch.from_numpy(x), 4)
    assert got.shape == (5, 3 * 5)
    _close(got, jax_cheb.cumulative_transform(jnp.asarray(x), 4))


def test_dilate_and_dilated_diag():
    x = _x(4, (6,), -1.0, 1.0)
    _close(
        torch_cheb.dilate(torch.from_numpy(x), 3),
        jax_cheb.dilate(jnp.asarray(x), 3),
    )
    _close(
        torch_cheb.dilated_chebyshev_diag(torch.from_numpy(x), 4, 3),
        jax_cheb.dilated_chebyshev_diag(jnp.asarray(x), 4, 3),
    )


def test_validation_contracts_match():
    assert torch_cheb.UNIT_EPS == jax_cheb.UNIT_EPS
    ok = torch.tensor([-1.0, 1.0 + 0.5 * torch_cheb.UNIT_EPS])
    assert torch_cheb.check_unit_interval(ok) is ok
    for bad in (torch.tensor([1.5]), np.array([-1.1])):
        with pytest.raises(ValueError, match="between -1 and 1"):
            torch_cheb.check_unit_interval(bad)
        with pytest.raises(ValueError, match="between -1 and 1"):
            jax_cheb.check_unit_interval(np.asarray(bad))
    w = torch.tensor([0.5, -1.0])
    assert torch_cheb.check_weight_magnitudes(w) is w
    with pytest.raises(ValueError, match="unitarity"):
        torch_cheb.check_weight_magnitudes(torch.tensor([2.0]))
    for fn in (torch_cheb.chebyshev_t, torch_cheb.chebyshev_basis):
        with pytest.raises(ValueError, match="non-negative"):
            fn(torch.zeros(2), -1)


@pytest.mark.parametrize("x0,want", [(1.0, 27.5), (-1.0, 7.5), (0.3, None)])
def test_clip_tie_passes_half_the_gradient_like_jax(x0, want):
    """d/dx sum(chebyshev_basis(x, 5, clip=True)): at x = +-1 the clip ties,
    and jnp.clip passes half the gradient (torch.clamp would pass all:
    55 and 15)."""
    xt = torch.tensor(x0, dtype=torch.float64, requires_grad=True)
    torch_cheb.chebyshev_basis(xt, 5, clip=True).sum().backward()
    jgrad = float(jax.grad(
        lambda v: jnp.sum(jax_cheb.chebyshev_basis(v, 5, clip=True))
    )(jnp.float64(x0)))
    if want is not None:
        assert jgrad == want
    np.testing.assert_allclose(float(xt.grad), jgrad, rtol=TOL, atol=TOL)


def test_batched_layer_dx_at_the_clip_bound_matches_jax():
    """dx of qkan_layer_forward_batched (N = K = 4, degree 3) with inputs
    on +-1 against jax.grad: the clip tie carries into the layer."""
    rng = np.random.default_rng(21)
    x = rng.uniform(-1, 1, (3, 4))
    x[0, 0], x[1, 2], x[2, 3] = 1.0, -1.0, 1.0
    w = rng.uniform(-1, 1, (4, 16))
    xt = torch.from_numpy(x).requires_grad_()
    torch_layer.qkan_layer_forward_batched(
        xt, torch.from_numpy(w), 4, 4
    ).sum().backward()
    want = jax.grad(lambda v: jnp.sum(jax_layer.qkan_layer_forward_batched(
        v, jnp.asarray(w), 4, 4
    )))(jnp.asarray(x))
    _close(xt.grad, want)
