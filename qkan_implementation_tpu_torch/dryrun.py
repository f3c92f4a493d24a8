"""Entry points: a single-card forward check and a multi-slot dry run.

Counterpart of the repository root's ``__graft_entry__.py`` for the JAX
package.  ``entry()`` returns a forward step on a small FixedKAN and its
example arguments.  ``dryrun_multichip(n)`` builds meshes of ``n`` slots
and runs every multi-device path of the port on tiny shapes: a
data-parallel FixedKAN step, ``FixedKAN.optimize`` / ``train`` with
``mesh=``, a tensor-parallel and a pipeline-parallel step, the sharded
statevector (with its per-slot memory balance and a FABLE diagonal read
back through the packed extraction, over both exchange routes) and the
sharded annealers.  Slots are the CUDA cards by default; ``devices=``
names them, as ``parallel.make_mesh`` takes them (``["cuda:0"] * 8`` is 8
slots of one card, ``["cpu"] * 8`` a rehearsal on the host).

    python -m qkan_implementation_tpu_torch.dryrun [N]
"""

from __future__ import annotations

import sys
from functools import partial

import numpy as np
import torch


def _build_kan_params(seed=0, shape=(8, 8, 4), max_degree=3, target_dim=4,
                      device="cpu"):
    """Deterministic FixedKAN params (float32) without the optimizer."""
    rng = np.random.default_rng(seed)
    params = []
    in_dim = shape[0]
    for out_dim in shape[1:]:
        params.append({
            "degrees": torch.as_tensor(
                rng.integers(0, max_degree + 1, out_dim), device=device),
            "coefficients": torch.as_tensor(
                rng.normal(size=(out_dim, in_dim, max_degree + 1,
                                 target_dim)) * 0.1,
                dtype=torch.float32, device=device),
            "horizontal_weights": torch.ones(out_dim, dtype=torch.float32,
                                             device=device),
        })
        in_dim = target_dim  # layers map to the shared target width
    return params


def entry(device="cuda"):
    """(fn, example_args): ``fn(*example_args)`` is the forward of a small
    FixedKAN on ``device``."""
    from qkan_implementation_tpu_torch.models.fixed_kan import kan_apply
    from qkan_implementation_tpu_torch.utils.platform import resolve_device

    device = resolve_device(device)
    max_degree = 3
    params = _build_kan_params(max_degree=max_degree, device=device)
    x = torch.as_tensor(np.random.default_rng(1).uniform(-1, 1, (16, 8)),
                        dtype=torch.float32, device=device)
    return partial(kan_apply, max_degree=max_degree), (params, x)


def _slots(n_devices: int, devices) -> list:
    """The first n of ``devices`` (the CUDA cards by default), n clamped to
    what there is, as the JAX dry run clamps to the visible devices."""
    from qkan_implementation_tpu_torch.parallel import device_count

    if devices is None:
        devices = [torch.device("cuda", i) for i in range(device_count())]
        if not devices:
            raise RuntimeError("no CUDA card: name the slots with devices=")
    devices = [torch.device(d) for d in devices]
    return devices[:max(1, min(n_devices, len(devices)))]


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """Every multi-device path over ``n_devices`` slots on tiny shapes;
    prints one ``dryrun_multichip ok: ...`` line and returns its numbers.
    Raises on any miss."""
    from qkan_implementation_tpu_torch.anneal import (
        degree_selection_qubo,
        parallel_tempering_mesh_ladder,
        polish_one_hot_blocks,
        simulated_annealing_sharded,
    )
    from qkan_implementation_tpu_torch.encoding import fable
    from qkan_implementation_tpu_torch.models import FixedKAN, FixedKANConfig
    from qkan_implementation_tpu_torch.parallel import (
        Mesh,
        make_pp_train_step,
        make_tp_train_step,
        shard_params,
        stack_pipeline_params,
    )
    from qkan_implementation_tpu_torch.sim import Circuit
    from qkan_implementation_tpu_torch.sim.sharded import (
        shard_memory_report,
        sharded_simulate,
    )

    devs = _slots(n_devices, devices)
    n = len(devs)
    dev0 = devs[0]
    max_degree = 3

    # ---- 1. data-parallel FixedKAN step: the batch over 'dp', one master
    # copy of the params on slot 0, autograd summing the slots' gradients
    rng = np.random.default_rng(2)
    batch = 4 * n
    x = torch.as_tensor(rng.uniform(-1, 1, (batch, 8)), dtype=torch.float32,
                        device=dev0)
    y = torch.as_tensor(rng.normal(size=(batch, 4)), dtype=torch.float32,
                        device=dev0)

    def split(params):
        return ([lp["degrees"] for lp in params],
                [{k: v for k, v in lp.items() if k != "degrees"}
                 for lp in params])

    degrees, train = split(_build_kan_params(device=dev0))
    dp_mesh = Mesh(devs, ("dp", "tp"), (n, 1))
    train, loss = make_tp_train_step(dp_mesh, max_degree,
                                     learning_rate=0.01)(train, degrees, x, y)

    # ---- 1b. the user-facing dp search and trainer ---------------------
    mesh = Mesh(devs, ("dp",))
    kan = FixedKAN(FixedKANConfig(network_shape=[8, 4, 4], max_degree=3),
                   device=dev0)
    kan.optimize(x, y, mesh=mesh, num_reads=4 * n, num_sweeps=30)
    dp_losses = kan.train(x, y, epochs=1, batch_size=2 * n,
                          learning_rate=1e-3, loss="mse", mesh=mesh)
    assert np.isfinite(dp_losses).all(), dp_losses

    # ---- 1c. tensor-parallel x data-parallel step -----------------------
    n_tp = 2 if n % 2 == 0 else 1
    tp_mesh = Mesh(devs, ("dp", "tp"), (n // n_tp, n_tp))
    tp_degrees, tp_train = split(shard_params(
        _build_kan_params(seed=5, device=dev0), 8, tp_mesh, dp_axis="dp"))
    tp_train, tp_loss = make_tp_train_step(
        tp_mesh, max_degree, learning_rate=1e-2)(tp_train, tp_degrees, x, y)
    assert np.isfinite(float(tp_loss)), tp_loss

    # ---- 1d. pipeline-parallel step: one layer a stage, the [8 -> 4]
    # head before the pipeline -------------------------------------------
    pp_mesh = Mesh(devs, ("pp",))
    lead, stacked = stack_pipeline_params(_build_kan_params(
        seed=7, shape=(8,) + (4,) * (n + 1), max_degree=max_degree,
        device=dev0), n)
    (_, _), pp_loss = make_pp_train_step(
        pp_mesh, max_degree, learning_rate=1e-2, microbatches=2,
        dp_axis=None,
    )({k: v for k, v in lead.items() if k != "degrees"}, lead["degrees"],
      {k: v for k, v in stacked.items() if k != "degrees"},
      stacked["degrees"], x, y)
    assert np.isfinite(float(pp_loss)), pp_loss

    # ---- 2. sharded statevector on the largest power-of-two subset -----
    n_sv = 1 << (n.bit_length() - 1)
    sv_mesh = Mesh(devs[:n_sv], ("d",))
    k = n_sv.bit_length() - 1
    q = max(6, k + 3)
    circ = Circuit(q)
    for t in range(q):
        circ.h(t)
    circ.cx(q - 1, 0)
    circ.ucry(np.random.default_rng(3).uniform(-np.pi, np.pi, 4),
              controls=(q - 1, 0), target=q - 2)
    psi = sharded_simulate(circ, sv_mesh)
    norm = float(torch.sum(torch.abs(psi.full()) ** 2))
    # every slot holds exactly 1/n_sv of the amplitudes: a replicated or
    # gathered state would void the sharded engine's footprint
    mem = shard_memory_report(psi)
    assert mem["devices"] == n_sv and mem["balanced"], mem
    assert mem["max_bytes_per_device"] * n_sv == mem["logical_bytes"], mem

    # ---- 2b/2c. a FABLE diagonal read back in one run (packed
    # extraction), over the collective exchange and the fused one --------
    n_enc = (10 + k + 1) // 2
    size = 2**n_enc
    diag = np.random.default_rng(4).uniform(-1, 1, size)
    fcirc, alpha = fable(np.diag(diag))
    psi0 = torch.zeros(2**fcirc.num_qubits, dtype=torch.float32,
                       device=dev0)
    psi0[:size] = 1.0 / np.sqrt(size)
    block_err = 0.0
    for impl in ("collective", "rdma") if n_sv >= 2 else ("collective",):
        psi_f = sharded_simulate(
            fcirc, sv_mesh, psi0=psi0, dtype=torch.float32,
            exchange_chunks=2 if impl == "collective" else 1,
            exchange_impl=impl,
        )
        top = (psi_f[:size].double().cpu().numpy()
               * alpha * size * np.sqrt(size))
        err = float(np.max(np.abs(top - diag)))
        assert err <= 5e-3, (impl, err)
        block_err = max(block_err, err)

    # ---- 3. mesh-sharded annealing: split chains and a split ladder on an
    # equal sweep budget, both through the exact one-hot polish ----------
    model = degree_selection_qubo(np.array([0.9, 0.4, 0.35]),
                                  num_functions=2, complexity_weight=0.1)
    num_reads = 8 * n
    samples, _ = simulated_annealing_sharded(
        model, Mesh(devs, ("d",)), num_reads=num_reads, num_sweeps=64,
        seed=0)
    pt_samples, _ = parallel_tempering_mesh_ladder(
        model, sv_mesh, num_chains=max(1, num_reads // (2 * n_sv)),
        num_replicas=2 * n_sv, num_sweeps=64, seed=0)
    best_sa = float(np.min(model.energy(
        polish_one_hot_blocks(model, samples, 3))))
    best_pt = float(np.min(model.energy(
        polish_one_hot_blocks(model, pt_samples, 3))))
    assert np.isfinite(best_pt) and abs(best_pt - best_sa) <= 1e-4, (
        f"tempering parity broken after exact one-hot polish: "
        f"pt {best_pt} vs sa {best_sa} on an equal sweep budget"
    )

    out = {"devices": n, "loss": float(loss), "tp_loss": float(tp_loss),
           "pp_loss": float(pp_loss), "norm": norm,
           "block_err": block_err, "best_E": best_sa, "pt_best_E": best_pt,
           "dp_losses": list(dp_losses)}
    print(
        f"dryrun_multichip ok: {n} devices, loss={out['loss']:.4f}, "
        f"tp_loss={out['tp_loss']:.4f}, pp_loss={out['pp_loss']:.4f}, "
        f"|psi|^2={norm:.6f}, ucry_block_err={block_err:.2e}, "
        f"best_E={best_sa:.4f}, pt_best_E={best_pt:.4f}",
        flush=True,
    )
    return out


if __name__ == "__main__":
    fn, args = entry()
    print("entry ok:", tuple(fn(*args).shape))
    from qkan_implementation_tpu_torch.parallel import device_count

    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1
                     else device_count())
