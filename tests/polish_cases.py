"""Cases of the one-hot polish on a block-diagonal anneal's state, and the
host route it is held to, shared by ``test_torch_anneal.py`` (CPU, the
plain version) and ``test_torch_cuda_anneal.py`` (the card's kernel).
Imports torch, numpy and the port only, so the card's tests run where JAX
is absent."""

import math

import numpy as np
import torch

from qkan_implementation_tpu_torch import anneal

# (bs, nb) of the degree QUBO of each digits-search layer (degree 5, the
# flagship's output widths 32, 16, 16, 10) and of market-search (degree 3,
# 79 features)
CELL_SHAPES = [(6, 32), (6, 16), (6, 10), (4, 79)]


def polish_case(bs, nb, reads, seed, degree_qubo, dtype=torch.float32,
                device="cpu"):
    """A block-diagonal QUBO and a random annealed state [bs, reads, nb]
    in ``dtype`` on ``device``: the degree QUBO of ``nb`` functions, or
    random dense blocks with the least bias of every other block repeated
    at a later bit (a tie np.argmin breaks to the first)."""
    rng = np.random.default_rng(seed)
    if degree_qubo:
        scores = np.sort(rng.uniform(0.01, 0.1, bs))[::-1].copy()
        model = anneal.degree_selection_qubo(scores, nb, 0.001,
                                             objective="penalized_mse")
    else:
        a = rng.normal(size=(nb, bs, bs))
        blocks = (a + a.transpose(0, 2, 1)) / 2
        blocks[:, np.arange(bs), np.arange(bs)] = 0.0
        h = rng.normal(size=(nb, bs))
        for b in range(0, nb, 2):
            h[b, bs - 1] = h[b].min()
        J = np.zeros((nb * bs, nb * bs))
        for b in range(nb):
            J[b * bs:(b + 1) * bs, b * bs:(b + 1) * bs] = blocks[b]
        model = anneal.QuboModel(h=h.ravel(), J=J, offset=0.25)
    s = torch.as_tensor(rng.uniform(size=(bs, reads, nb)) < 0.5,
                        dtype=dtype, device=device)
    return model, s


def host_polish_route(model, s, bs):
    """What ``solve_qubo`` does on the host with the state ``s``: every
    read copied out, ``polish_one_hot_blocks``, ``QuboModel.energy``,
    ``np.argmin``.  Returns (polished reads, best read, its energy)."""
    samples = s.permute(1, 2, 0).reshape(s.shape[1], -1).cpu().double()
    polished = anneal.polish_one_hot_blocks(model, samples.numpy(), bs)
    energies = model.energy(polished)
    best = int(np.argmin(energies))
    return polished, polished[best], float(energies[best])


def exact_energy(model, x) -> float:
    """E(x), offset included, correctly rounded (``math.fsum`` of its
    terms)."""
    on = np.flatnonzero(x)
    return math.fsum([*model.h[on], *(0.5 * model.J[np.ix_(on, on)]).ravel(),
                      model.offset])


def assert_energy(model, x, got, host):
    """The energy ``got`` of the sample ``x``: within 1e-15 of the exact
    E(x), and within 1e-12 of the host route's ``host``, each relative to
    the larger of |E| and |offset|.  The degree QUBO's energy is a sum of
    blocks' energies near -10 that cancels against the offset (+10 a
    block), and numpy's sum over 79 blocks reads up to 1e-12 of E off the
    exact value, so a bar on |E| alone would read numpy's rounding."""
    scale = max(abs(host), abs(model.offset))
    assert abs(got - exact_energy(model, x)) <= 1e-15 * scale
    assert abs(got - host) <= 1e-12 * scale
