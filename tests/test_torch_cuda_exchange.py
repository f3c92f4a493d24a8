"""The fused exchange kernel of the torch port (K11, ``csrc/exchange.cu``)
against its plain torch version, on 8 mesh slots of one card.  Every test
here needs a CUDA card and skips without one.

This file imports torch and numpy only, so it runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_cuda_exchange.py -q

Bars: max|kernel - plain| <= 1e-6 max|plain| in float32 and 1e-13
max|plain| in float64, the bars of the other statevector kernels (the
same few flops an amplitude; a contracted multiply-add is the only
difference).  Gradients (the autograd Function on the card against the
same Function on CPU copies, which runs the plain versions) are held to
the same bars against each leaf's max.
"""

import numpy as np
import pytest
import torch

from qkan_implementation_tpu_torch.parallel import make_mesh
from qkan_implementation_tpu_torch.sim import Circuit, rdma, sharded_simulate
from qkan_implementation_tpu_torch.sim import simulate

pytestmark = pytest.mark.gpu

BAR = {torch.float32: 1e-6, torch.float64: 1e-13}
NDEV = 8


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


def _slots(rng, m, dtype, device, n=NDEV):
    return [torch.from_numpy(rng.normal(size=2 * m)).to(device=device,
                                                        dtype=dtype)
            for _ in range(n)]


def _plain(gate, blocks, cs, sn, dev_bit):
    m = blocks[0].shape[0] // 2
    out = []
    for d in range(len(blocks)):
        g = (d >> dev_bit) & 1
        kept = blocks[d][g * m:(g + 1) * m]
        received = blocks[d ^ (1 << dev_bit)][g * m:(g + 1) * m]
        out.append(rdma.ucry_exchange_reference(kept, received, cs[d], sn[d], g)
                   if gate == "ucry" else
                   rdma.h_exchange_reference(kept, received, g))
    return out


CASES = [(gate, dtype, dev_bit, m)
         for gate in ("ucry", "h")
         for dtype in (torch.float32, torch.float64)
         for dev_bit in (0, 1, 2)
         for m in (1, 2**10, 2**16)]


@pytest.mark.parametrize("gate,dtype,dev_bit,m", CASES)
def test_exchange_kernel_matches_plain(cuda, gate, dtype, dev_bit, m):
    rng = np.random.default_rng(m + dev_bit)
    blocks = _slots(rng, m, dtype, cuda)
    th = [torch.from_numpy(rng.uniform(0, 2 * np.pi, m)).to(cuda, dtype)
          for _ in range(NDEV)]
    cs, sn = [torch.cos(t / 2) for t in th], [torch.sin(t / 2) for t in th]

    def run():
        if gate == "ucry":
            return rdma.ucry_exchange_fused_rdma(blocks, cs, sn, dev_bit)
        return rdma.h_exchange_fused_rdma(blocks, dev_bit)

    got = run()
    for g, w in zip(got, _plain(gate, blocks, cs, sn, dev_bit)):
        _held(g, w, dtype)
    again = run()
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("gate", ["ucry", "h"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("dev_bit", [0, 2])
def test_exchange_backward_matches_plain(cuda, gate, dtype, dev_bit):
    m = 2**10
    rng = np.random.default_rng(7 + dev_bit)
    base = _slots(rng, m, dtype, "cpu")
    th = [torch.from_numpy(rng.uniform(-3, 3, m)).to(dtype)
          for _ in range(NDEV)]

    def grads(device):
        blocks = [b.to(device).requires_grad_() for b in base]
        cs = [torch.cos(t / 2).to(device).requires_grad_() for t in th]
        sn = [torch.sin(t / 2).to(device).requires_grad_() for t in th]
        if gate == "ucry":
            outs = rdma.ucry_exchange_fused_rdma(blocks, cs, sn, dev_bit)
            leaves = [*blocks, *cs, *sn]
        else:
            outs = rdma.h_exchange_fused_rdma(blocks, dev_bit)
            leaves = blocks
        return torch.autograd.grad(sum((o**3).sum() for o in outs), leaves)

    for got, want in zip(grads(cuda), grads("cpu")):
        _held(got, want.to(cuda), dtype)


def test_counters_and_checks(cuda):
    blocks = [torch.ones(8, device=cuda) for _ in range(NDEV)]
    c = [torch.ones(4, device=cuda)] * NDEV
    rdma.ucry_exchange_fused_rdma.launches = 0
    rdma.h_exchange_fused_rdma.launches = 0
    rdma.ucry_exchange_fused_rdma(blocks, c, c, 1)
    rdma.h_exchange_fused_rdma(blocks, 2)
    rdma.h_exchange_fused_rdma([b.cpu() for b in blocks], 2)  # plain: no count
    torch.cuda.synchronize()
    assert rdma.ucry_exchange_fused_rdma.launches == NDEV
    assert rdma.h_exchange_fused_rdma.launches == NDEV
    with pytest.raises(ValueError, match="float32 or float64"):
        rdma.h_exchange_fused_rdma([b.half() for b in blocks], 0)
    with pytest.raises(ValueError, match="on cpu"):
        rdma.ucry_exchange_fused_rdma(blocks, [t.cpu() for t in c], c, 0)


@pytest.mark.parametrize("impl", ["rdma", "collective", "all_to_all"])
def test_sharded_engine_on_one_card(cuda, impl):
    """A FABLE-like circuit on 8 slots of one card against the dense
    engine on the CPU; K11 launches only on 'rdma'."""
    q = 12
    rng = np.random.default_rng(12)
    circ = Circuit(q)
    for t in range(q - 4, q):
        circ.h(t)
    circ.ucry(rng.uniform(-2, 2, 2 ** (q - 1)), tuple(range(q - 2, -1, -1)),
              q - 1)
    circ.h(q - 1).cx(q - 2, 0)
    mesh = make_mesh(NDEV, devices=[cuda] * NDEV)
    rdma.ucry_exchange_fused_rdma.launches = 0
    rdma.h_exchange_fused_rdma.launches = 0
    got = sharded_simulate(circ, mesh, dtype=torch.float64, exchange_impl=impl)
    want = simulate(circ, dtype=torch.float64, device="cpu", backend="xla")
    _held(got.full().cpu(), want, torch.float64)
    fused = (rdma.ucry_exchange_fused_rdma.launches
             + rdma.h_exchange_fused_rdma.launches)
    assert (fused > 0) == (impl == "rdma")
