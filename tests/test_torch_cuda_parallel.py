"""The torch port's multi-device paths on 8 slots of one CUDA card, held
to the same code on one slot of the card.  Every test here needs a card
and skips without one.

This file imports torch and numpy only, so it runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_cuda_parallel.py -q

Bars, the CPU files' (``tests/test_torch_parallel_{tp,pp}.py``,
``tests/test_torch_mesh_train.py``), all in float64 with TF32 off:
``kan_apply_tp`` / ``kan_apply_pp`` within 1e-10 of ``kan_apply``; a tp
or pp SGD step's loss within 1e-12 and its parameters within 1e-10 of
the same step by autograd on one slot; ``train(mesh=)`` losses rtol 1e-12
and parameters atol 1e-12 of the single-slot ``train``;
``optimize(mesh=)`` degrees equal and coefficients / forwards within 1e-7
of max|.|; the mesh samplers at the brute-force optimum with R' rows.
"""

import numpy as np
import pytest
import torch

from qkan_implementation_tpu_torch.anneal import (
    QuboModel,
    parallel_tempering_mesh_ladder,
    parallel_tempering_sharded,
    simulated_annealing_sharded,
)
from qkan_implementation_tpu_torch.models import FixedKAN, FixedKANConfig
from qkan_implementation_tpu_torch.models.fixed_kan import kan_apply
from qkan_implementation_tpu_torch.parallel import (
    Mesh,
    Shards,
    gather_shards,
    kan_apply_pp,
    kan_apply_tp,
    make_pp_train_step,
    make_tp_train_step,
    place_pipeline_params,
    shard_params,
)

pytestmark = pytest.mark.gpu
D = 3
SLOTS = 8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def x64():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


def meshes(dev):
    return {"tp8": Mesh([dev] * SLOTS, ("tp",)),
            "dp_tp": Mesh([dev] * SLOTS, ("dp", "tp"), (2, 4)),
            "pp4": Mesh([dev] * 4, ("pp",)),
            "dp_pp": Mesh([dev] * SLOTS, ("dp", "pp"), (2, 4)),
            "dp": Mesh([dev] * SLOTS, ("dp",))}


def params(seed, in_dim, outs, t_dim, dev):
    rng = np.random.default_rng(seed)
    out, cur = [], in_dim
    for o in outs:
        out.append({
            "degrees": torch.as_tensor(rng.integers(0, D + 1, o),
                                       device=dev),
            "coefficients": torch.as_tensor(
                rng.normal(size=(o, cur, D + 1, t_dim)) * 0.3, device=dev),
            "horizontal_weights": torch.as_tensor(rng.normal(size=o) + 1.0,
                                                  device=dev),
        })
        cur = t_dim
    return out


def data(seed, b, in_dim, t_dim, dev):
    rng = np.random.default_rng(seed)
    return (torch.as_tensor(rng.uniform(-2, 2, (b, in_dim)), device=dev),
            torch.as_tensor(rng.normal(size=(b, t_dim)), device=dev))


def sgd_reference(p, x, y, lr):
    """One SGD step by autograd through kan_apply on one slot."""
    leaves = [{k: v.clone().requires_grad_() for k, v in lp.items()
               if k != "degrees"} for lp in p]
    full = [dict(lv, degrees=lp["degrees"]) for lv, lp in zip(leaves, p)]
    loss = torch.mean((kan_apply(full, x, D) - y) ** 2)
    flat = [v for lv in leaves for v in lv.values()]
    grads = iter(torch.autograd.grad(loss, flat))
    return [{k: (v - lr * next(grads)).detach() for k, v in lv.items()}
            for lv in leaves], float(loss.detach())


def assert_close(got, want, bar):
    err = float((got - want).abs().max())
    assert err <= bar, err


@pytest.mark.parametrize("case", [("dp_tp", 8, (6, 5), 4),
                                  ("dp_tp", 6, (5, 7), 4),
                                  ("tp8", 784, (32, 16), 16)])
def test_tp_forward_and_step_equal_one_slot(cuda, case):
    mesh_name, in_dim, outs, t_dim = case
    mesh = meshes(cuda)[mesh_name]
    p = params(0, in_dim, outs, t_dim, cuda)
    x, y = data(1, 64, in_dim, t_dim, cuda)
    want = kan_apply(p, x, D)
    for layout in (p, shard_params(p, in_dim, mesh)):
        assert_close(kan_apply_tp(layout, x, D, mesh), want, 1e-10)
    sharded = shard_params(p, in_dim, mesh)
    if in_dim % mesh.shape["tp"] == 0:
        c = sharded[0]["coefficients"]
        assert isinstance(c, Shards) and all(
            s.device.type == "cuda" and s.untyped_storage().nbytes()
            * mesh.shape["tp"] == p[0]["coefficients"].numel() * 8
            for s in c.parts)
    degrees = [lp["degrees"] for lp in sharded]
    train = [{k: v for k, v in lp.items() if k != "degrees"}
             for lp in sharded]
    new, loss = make_tp_train_step(mesh, D, learning_rate=0.05)(
        train, degrees, x, y)
    ref, ref_loss = sgd_reference(p, x, y, 0.05)
    assert abs(float(loss) - ref_loss) <= 1e-12
    for got, w in zip(gather_shards(new), ref):
        for k in w:
            assert_close(got[k], w[k], 1e-10)


@pytest.mark.parametrize("mesh_name", ["pp4", "dp_pp"])
def test_pp_forward_and_step_equal_one_slot(cuda, mesh_name):
    mesh = meshes(cuda)[mesh_name]
    p = params(2, 7, (6, 5, 3, 4, 5), 4, cuda)
    x, y = data(3, 16, 7, 4, cuda)
    lead, stacked = place_pipeline_params(p, mesh)
    assert_close(kan_apply_pp((lead, stacked), x, D, mesh, microbatches=2),
                 kan_apply(p, x, D), 1e-10)
    step = make_pp_train_step(mesh, D, learning_rate=0.05, microbatches=2)
    (new_lead, new_stacked), loss = step(
        {k: v for k, v in lead.items() if k != "degrees"}, lead["degrees"],
        {k: v for k, v in stacked.items() if k != "degrees"},
        stacked["degrees"], x, y)
    ref, ref_loss = sgd_reference(p, x, y, 0.05)
    assert abs(float(loss) - ref_loss) <= 1e-12
    for k in new_lead:
        assert_close(new_lead[k], ref[0][k], 1e-10)
    full = gather_shards(new_stacked)
    for s, w in enumerate(ref[1:]):
        o = w["coefficients"].shape[0]
        for k in w:
            assert_close(full[k][s, 0][:o], w[k], 1e-10)


def train_pair(dev, mesh, loss, **kw):
    rng = np.random.default_rng(6)
    x = rng.uniform(-2, 2, (128, 8))
    y = np.tanh(x @ rng.normal(0, 0.5, (8, 2)))
    y = y if loss == "mse" else (y[:, 0] > 0).astype(np.int64)
    cfg = FixedKANConfig(network_shape=[8, 5, 2], max_degree=D,
                         degree_objective="penalized_mse",
                         complexity_weight=1e-3)
    out = {}
    for name, extra in (("single", {}), ("mesh", {"mesh": mesh, **kw})):
        kan = FixedKAN(cfg, device=dev)
        kan.optimize(x, np.tanh(x @ np.ones((8, 2)) / 8), solver="exact")
        losses = kan.train(x, y, epochs=2, batch_size=32,
                           learning_rate=2e-3, loss=loss, grad_clip=1.0,
                           seed=7, **extra)
        out[name] = (np.asarray(losses), kan.params)
    return out


@pytest.mark.parametrize("loss", ["mse", "cross_entropy"])
@pytest.mark.parametrize("mesh_name", ["dp", "dp_tp"])
def test_train_mesh_equals_one_slot(cuda, mesh_name, loss):
    runs = train_pair(cuda, meshes(cuda)[mesh_name], loss)
    np.testing.assert_allclose(runs["mesh"][0], runs["single"][0],
                               rtol=1e-12)
    for a, b in zip(runs["mesh"][1], runs["single"][1]):
        for k in ("coefficients", "horizontal_weights"):
            assert_close(a[k], b[k], 1e-12)
        assert a["coefficients"].device.type == "cuda"


def test_optimize_mesh_equals_one_slot(cuda):
    rng = np.random.default_rng(11)
    x = rng.uniform(-2, 2, (512, 6))
    y = np.stack([np.sin(x.sum(1)), (x**2).mean(1)], 1)
    cfg = FixedKANConfig(network_shape=[6, 4, 2], max_degree=4,
                         lstsq_method="normal",
                         degree_objective="penalized_mse",
                         complexity_weight=1e-3, consistent_tanh=True)
    kans = {}
    for name, kw in (("single", {}), ("dp", {"mesh": meshes(cuda)["dp"]})):
        kans[name] = FixedKAN(cfg, device=cuda)
        kans[name].optimize(x, y, num_reads=64, num_sweeps=100, seed=3, **kw)
    assert [s["slots"] for s in kans["dp"].last_search_stats] == [8, 8]
    for a, b in zip(kans["dp"].params, kans["single"].params):
        assert torch.equal(a["degrees"], b["degrees"])
        scale = float(b["coefficients"].abs().max())
        assert_close(a["coefficients"], b["coefficients"], 1e-7 * scale)
    out, ref = kans["dp"](x), kans["single"](x)
    assert_close(out, ref, 1e-7 * float(ref.abs().max()))


def dense(seed, n=12):
    rng = np.random.default_rng(seed)
    J = rng.normal(0, 1, (n, n))
    J = J + J.T
    np.fill_diagonal(J, 0.0)
    return QuboModel(h=rng.normal(0, 1, n), J=J, offset=0.25)


def ground(model):
    n = model.num_variables
    states = ((np.arange(2**n)[:, None] >> np.arange(n)) & 1).astype(float)
    return float(np.min(model.energy(states)))


def test_mesh_samplers_reach_ground_on_card_slots(cuda):
    mesh = Mesh([cuda] * SLOTS, ("d",))
    model = dense(5)
    truth = ground(model)
    runs = {
        "sa": simulated_annealing_sharded(model, mesh, num_reads=20,
                                          num_sweeps=100, seed=0),
        "pt": parallel_tempering_sharded(model, mesh, num_chains=9,
                                         num_replicas=4, num_sweeps=100,
                                         seed=0),
        "ladder": parallel_tempering_mesh_ladder(
            model, mesh, num_chains=4, num_replicas=16, num_sweeps=100,
            seed=0),
    }
    rows = {"sa": 24, "pt": 16 * 4, "ladder": 4 * 16}
    for name, (samples, energies) in runs.items():
        assert samples.shape == (rows[name], 12), name
        np.testing.assert_allclose(energies, model.energy(samples),
                                   atol=1e-3)
        best = float(np.min(model.energy(samples)))
        assert best <= truth + 1e-9 * max(1.0, abs(truth)), (name, best)
