"""Statevector kernels of the torch port (K6-K10, ``csrc/statevector.cu``)
against their plain torch versions, on the card.  Every test here needs a
CUDA card and skips without one.

This file imports torch and numpy only, so it runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_cuda_statevector.py -q

Bars: max|kernel - plain| <= 1e-6 max|plain| in float32 and 1e-13
max|plain| in float64.  Both sides do the same few flops per amplitude;
they differ by a fused multiply-add where the compiler contracts one and
by the last bit of sin/cos in K8 -- a few units in the last place.
Gradients (the K6 and K8 VJPs against autograd through the plain
versions) are held to the same bars against each leaf's max.
"""

import numpy as np
import pytest
import torch

from qkan_implementation_tpu_torch.sim import pallas_kernels as pk

pytestmark = pytest.mark.gpu

BAR = {torch.float32: 1e-6, torch.float64: 1e-13}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _held(got, want, dtype):
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype
    assert bool(torch.isfinite(got).all())
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= BAR[dtype] * scale, (err, scale)


def _state(rng, lead, q, dtype, device):
    psi = rng.normal(size=(*lead, 2**q))
    return torch.from_numpy(psi).to(device=device, dtype=dtype)


def _angles(rng, lead, m, shared, dtype, device, lo=0.0, hi=2 * np.pi):
    shape = (m,) if shared else (*lead, m)
    return torch.from_numpy(rng.uniform(lo, hi, shape)).to(device=device,
                                                            dtype=dtype)


CASES = [(q, lead, shared, dtype)
         for q in (1, 5, 11, 21)
         for lead in ((), (8,))
         for shared in (True, False)
         for dtype in (torch.float32, torch.float64)
         if not (shared is False and lead == ())]
# the shapes the quantum layer (17 qubits, one row of angles per sample)
# and the batched dense FABLE columns (11 qubits, shared angles) give them
CASES += [(q, lead, shared, dtype)
          for q, lead, shared in ((17, (256,), False), (17, (8,), False),
                                  (11, (4,), True))
          for dtype in (torch.float32, torch.float64)]


@pytest.mark.parametrize("q,lead,shared,dtype", CASES)
def test_ucry_kernels_match_plain(cuda, q, lead, shared, dtype):
    rng = np.random.default_rng(q)
    psi = _state(rng, lead, q, dtype, cuda)
    theta = _angles(rng, lead, 2 ** (q - 1), shared, dtype, cuda)
    c, s = torch.cos(theta / 2), torch.sin(theta / 2)
    want_cs = pk.ucry_msb_cs_reference(psi, c, s)
    _held(pk.ucry_msb_cs_pallas_pair(psi, c, s), want_cs, dtype)
    _held(pk.ucry_msb_cs_pallas(psi, c, s), want_cs, dtype)
    _held(pk.ucry_msb_pallas(psi, theta),
          pk.ucry_msb_reference(psi, theta), dtype)


@pytest.mark.parametrize("q,lead,shared,dtype", CASES)
def test_diag_kernel_matches_plain(cuda, q, lead, shared, dtype):
    rng = np.random.default_rng(100 + q)
    psi = _state(rng, lead, q, dtype, cuda)
    diag = _angles(rng, lead, 2**q, shared, dtype, cuda, -1.0, 1.0)
    _held(pk.diag_mult_pallas(psi, diag), pk.diag_mult_reference(psi, diag),
          dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("q,lead", [(5, ()), (21, ()), (11, (8,))])
def test_h_kernel_matches_plain_on_every_qubit(cuda, q, lead, dtype):
    rng = np.random.default_rng(200 + q)
    psi = _state(rng, lead, q, dtype, cuda)
    qubits = range(q) if q <= 11 else (0, 1, 9, 10, q - 2, q - 1)
    for qubit in qubits:
        _held(pk.h_gate_pallas(psi, qubit), pk.h_gate_reference(psi, qubit),
              dtype)


def _grads(fn, *leaves, tgt):
    leaves = [t.detach().clone().requires_grad_() for t in leaves]
    loss = torch.sum((fn(*leaves) - tgt) ** 2)
    return torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("lead,shared", [((), True), ((8,), True),
                                         ((8,), False)])
def test_ucry_vjps_match_autograd_through_plain(cuda, lead, shared, dtype):
    q = 11
    rng = np.random.default_rng(7)
    psi = _state(rng, lead, q, dtype, cuda)
    theta = _angles(rng, lead, 2 ** (q - 1), shared, dtype, cuda, -3.0, 3.0)
    tgt = _state(rng, lead, q, dtype, cuda)
    c, s = torch.cos(theta / 2), torch.sin(theta / 2)
    pairs = [
        (pk.ucry_msb_pallas, pk.ucry_msb_reference, (psi, theta)),
        (pk.ucry_msb_cs_pallas_pair, pk.ucry_msb_cs_reference, (psi, c, s)),
        (pk.ucry_msb_cs_pallas, pk.ucry_msb_cs_reference, (psi, c, s)),
    ]
    for kernel, plain, args in pairs:
        got = _grads(kernel, *args, tgt=tgt)
        want = _grads(plain, *args, tgt=tgt)
        for g, w in zip(got, want):
            assert g.shape == w.shape
            _held(g, w, dtype)


def test_counts_move_only_where_kernels_launch(cuda):
    psi = torch.randn(4, 2**6, device=cuda, dtype=torch.float64)
    th = torch.rand(2**5, device=cuda, dtype=torch.float64)
    owners = [pk.ucry_msb_pallas, pk.ucry_msb_cs_pallas_pair,
              pk.ucry_msb_cs_pallas, pk.diag_mult_pallas, pk.h_gate_pallas]
    for o in owners:
        o.launches = 0
        if hasattr(o, "bwd_launches"):
            o.bwd_launches = 0
    pk.ucry_msb_pallas(psi, th)
    pk.ucry_msb_cs_pallas_pair(psi, torch.cos(th), torch.sin(th))
    pk.ucry_msb_cs_pallas(psi, torch.cos(th), torch.sin(th))
    pk.diag_mult_pallas(psi, torch.ones(2**6, device=cuda,
                                        dtype=torch.float64))
    pk.h_gate_pallas(psi, 3)
    assert [o.launches for o in owners] == [1, 1, 1, 1, 1]
    # size 0: nothing launches, nothing counts
    empty = psi[:0]
    pk.ucry_msb_pallas(empty, th)
    pk.ucry_msb_cs_pallas_pair(empty, torch.cos(th), torch.sin(th))
    pk.diag_mult_pallas(empty, torch.ones(2**6, device=cuda,
                                          dtype=torch.float64))
    pk.h_gate_pallas(empty, 3)
    assert [o.launches for o in owners] == [1, 1, 1, 1, 1]
    # a backward counts once more, under bwd_launches
    leaf = psi.clone().requires_grad_()
    pk.ucry_msb_pallas(leaf, th).sum().backward()
    assert (pk.ucry_msb_pallas.launches, pk.ucry_msb_pallas.bwd_launches) == (2, 1)


def test_kernels_refuse_what_they_do_not_take(cuda):
    z = torch.zeros(2**4, dtype=torch.complex64, device=cuda)
    th = torch.zeros(2**3, device=cuda)
    with pytest.raises(ValueError):
        pk.ucry_msb_pallas(z, th)
    with pytest.raises(ValueError):
        pk.h_gate_pallas(z, 1)
    with pytest.raises(ValueError):  # not a power of two
        pk.diag_mult_pallas(torch.zeros(6, device=cuda),
                            torch.zeros(6, device=cuda))
    with pytest.raises(ValueError):  # angles on another device
        pk.ucry_msb_pallas(torch.zeros(2**4, device=cuda), th.cpu())
    with pytest.raises(RuntimeError):  # no backward on the card
        pk.h_gate_pallas(torch.zeros(2**4, device=cuda, requires_grad=True), 1)


def test_simulate_auto_on_the_card_matches_xla(cuda):
    from qkan_implementation_tpu_torch.encoding import fable
    from qkan_implementation_tpu_torch.sim import simulate

    rng = np.random.default_rng(3)
    a = rng.uniform(-1, 1, (32, 32))
    circ, alpha = fable(a)
    for dtype in (torch.float32, torch.float64):
        pk.ucry_msb_cs_pallas_pair.launches = 0
        got = simulate(circ, dtype=dtype, device=cuda)
        assert pk.ucry_msb_cs_pallas_pair.launches == 1
        want = simulate(circ, dtype=dtype, backend="xla", device=cuda)
        _held(got, want, dtype)
        col = got[:32].double().cpu().numpy() * alpha * 32
        np.testing.assert_allclose(col, a[:, 0],
                                   atol=1e-5 if dtype == torch.float32 else 1e-12)
