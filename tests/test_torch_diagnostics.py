"""The torch port's diagnostics and helpers against the JAX package, on
the CPU: ``utils/checkpoint.py``, ``utils/profiling.py``,
``FixedKAN.analyze_network`` / ``visualize_analysis``,
``analysis/{model_analysis,sparsity}.py``, the circuit half of
``native_bindings.py`` and ``dryrun.py`` (the counterpart of the
repository root's ``__graft_entry__.py``).

Bars: npz files cross between the packages and load equal; a per-slot
tree round-trips through ``save_pytree`` / ``load_pytree`` bit for bit
onto its slots; ``analyze_network`` within 1e-12 of max|.| of the JAX
package's (float64) and its combined output within 1e-12 of
``kan_apply``; model and sparsity statistics equal the JAX package's on
the same files; ``statevector_native`` within 1e-12 of the port's
``sim.simulate`` (the JAX test's bar); circuit depth and the optimizer's
gates equal the JAX binding's on the same circuits.  The profiling
helpers have no JAX-comparable output (they read clocks): they are held
to their contracts (a stage's seconds accumulate, the report's shape,
the trace file and its annotations, positive timings).
"""

import json
import sys
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qkan_implementation_tpu import native_bindings as jnb
from qkan_implementation_tpu.analysis import model_analysis as jma
from qkan_implementation_tpu.analysis import sparsity as jsp
from qkan_implementation_tpu.encoding import fable as jfable
from qkan_implementation_tpu.models import fixed_kan as jfk
from qkan_implementation_tpu.sim import Circuit as JCircuit
from qkan_implementation_tpu.sim.circuit import Gate as JGate
from qkan_implementation_tpu.utils import checkpoint as jckpt
from qkan_implementation_tpu.utils import profiling as jprof
from qkan_implementation_tpu_torch import native_bindings as nb
from qkan_implementation_tpu_torch.analysis import (
    SparsityMetrics,
    analyze_models,
    compute_model_stats,
    compute_sparsity,
    extract_degrees_from_checkpoint,
    print_sparsity_analysis,
)
from qkan_implementation_tpu_torch.dryrun import dryrun_multichip, entry
from qkan_implementation_tpu_torch.encoding import fable
from qkan_implementation_tpu_torch.models import fixed_kan as tfk
from qkan_implementation_tpu_torch.parallel import (
    Mesh,
    Shards,
    gather_shards,
    place_pipeline_params,
    shard_params,
)
from qkan_implementation_tpu_torch.sim import Circuit, simulate
from qkan_implementation_tpu_torch.utils import checkpoint, profiling
from qkan_implementation_tpu_torch.utils.convert import params_from_numpy

BAR = 1e-12


@pytest.fixture(autouse=True)
def x64():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


def np_params(seed, in_dim, outs, target_dim, max_degree=3):
    rng = np.random.default_rng(seed)
    params, cur = [], in_dim
    for out in outs:
        params.append({
            "degrees": rng.integers(0, max_degree + 1, out).astype(np.int32),
            "coefficients": rng.normal(
                size=(out, cur, max_degree + 1, target_dim)) * 0.3,
            "horizontal_weights": rng.normal(size=out) + 1.0,
        })
        cur = target_dim
    return params


def models(seed, shape, max_degree=3):
    """The same parameters in a JAX and a port FixedKAN."""
    p = np_params(seed, shape[0], shape[1:], shape[-1], max_degree)
    jk = jfk.FixedKAN(jfk.FixedKANConfig(list(shape), max_degree))
    jk.params = [{k: jnp.asarray(v) for k, v in lp.items()} for lp in p]
    tk = tfk.FixedKAN(tfk.FixedKANConfig(list(shape), max_degree),
                      device="cpu")
    tk.params = params_from_numpy(p, "cpu")
    return jk, tk


# -- utils/checkpoint.py ---------------------------------------------------


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_npz_crosses_packages(tmp_path, writer):
    tree = {"a": np.arange(5), "b": np.ones((2, 2)) * 0.25,
            "c": np.asarray([1.5], dtype=np.float32)}
    path = str(tmp_path / "t")  # no suffix: np.savez adds .npz
    if writer == "jax":
        jckpt.save_npz(path, {**tree, "b": jnp.asarray(tree["b"])})
    else:
        checkpoint.save_npz(path, {**tree, "b": torch.as_tensor(tree["b"])})
    for loaded in (jckpt.load_npz(path), checkpoint.load_npz(path),
                   checkpoint.load_npz(path + ".npz")):
        assert set(loaded) == set(tree)
        for k, v in tree.items():
            np.testing.assert_array_equal(loaded[k], v)
            assert loaded[k].dtype == v.dtype


def test_pytree_round_trips_per_slot_layouts(tmp_path):
    tp_mesh = Mesh(["cpu"] * 8, ("dp", "tp"), (2, 4))
    tp_params = shard_params(params_from_numpy(
        np_params(0, 8, (6, 5), 4), "cpu"), 8, tp_mesh)
    pp_params = place_pipeline_params(params_from_numpy(
        np_params(1, 7, (6, 5, 3, 4, 6), 4), "cpu"), Mesh(["cpu"] * 4,
                                                          ("pp",)))
    tree = {"tp": tp_params, "pp": pp_params, "step": 3, "name": "run",
            "scale": torch.tensor(2.5)}
    path = tmp_path / "ckpt.pt"
    checkpoint.save_pytree(str(path), tree)
    for target in (tree, None):
        back = checkpoint.load_pytree(str(path), target=target)
        assert back["step"] == 3 and back["name"] == "run"
        assert isinstance(back["pp"], tuple)
        c = back["tp"][0]["coefficients"]
        assert isinstance(c, Shards) and c.dim == 1 and len(c.parts) == 4
        assert [p.device for p in c.parts] == list(
            tp_mesh.axis_devices("tp"))
        got, want = gather_shards(back), gather_shards(tree)
        for lg, lw in zip(got["tp"], want["tp"]):
            for k in lw:
                assert torch.equal(lg[k], lw[k]) and lg[k].dtype == lw[k].dtype
        for sg, sw in zip(got["pp"], want["pp"]):
            for k in sw:
                assert torch.equal(sg[k], sw[k])
        assert torch.equal(back["scale"], tree["scale"])


# -- utils/profiling.py -----------------------------------------------------


def test_stage_timer_report_matches_jax_shape():
    port, jax_timer = profiling.StageTimer(), jprof.StageTimer()
    for timer in (port, jax_timer):
        for name in ("weights", "circuit", "weights"):
            with timer.stage(name):
                torch.ones(64).sum()
    assert list(port.durations) == ["weights", "circuit"]
    assert port.total == pytest.approx(sum(port.durations.values()))
    # the same report with the same durations
    jax_timer.durations = dict(port.durations)
    assert port.report(memory_bytes=3 << 20) == jax_timer.report(
        memory_bytes=3 << 20)
    assert port.report().splitlines()[0] == "Breakdown of computation:"


def test_device_trace_writes_chrome_trace_with_stages(tmp_path):
    timer = profiling.StageTimer()
    with profiling.device_trace(str(tmp_path / "trace")) as prof:
        with timer.stage("annotated_stage"):
            torch.ones(256, 256) @ torch.ones(256, 256)
    names = {e.key for e in prof.key_averages()}
    assert "annotated_stage" in names
    files = list((tmp_path / "trace").glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "annotated_stage" for e in events)


def test_slope_and_median_timers():
    x = torch.ones(1000)
    s = profiling.timeit_chained(lambda c: c * 1.0000001, x, iters=5)
    assert 0.0 < s < 1.0
    calls = []
    t = profiling.timeit_jit(lambda a: calls.append(1) or a + 1, x,
                             iters=7, warmup=3)
    assert 0.0 < t < 1.0 and len(calls) == 10


# -- FixedKAN.analyze_network / visualize_analysis ---------------------------


@pytest.mark.parametrize("shape", [(1, 3, 1), (2, 4, 2), (5, 4, 3, 3)])
def test_analyze_network_equals_jax(shape):
    jk, tk = models(4, shape)
    x = np.random.default_rng(5).uniform(-2, 2, (40, shape[0]))
    want = jk.analyze_network(jnp.asarray(x))
    got = tk.analyze_network(x)
    assert set(got) == set(want)
    for key, lw in want.items():
        lg = got[key]
        assert lg["degrees"] == lw["degrees"]
        assert lg["input_dim"] == lw["input_dim"]
        for k in ("neuron_outputs", "combined_output"):
            w = np.asarray(lw[k])
            assert lg[k].device.type == "cpu"
            np.testing.assert_allclose(lg[k].numpy(), w, rtol=0,
                                       atol=BAR * np.abs(w).max())
    out = tfk.kan_apply(tk.params, torch.from_numpy(x), 3)
    last = got[f"layer_{len(shape) - 2}"]["combined_output"]
    np.testing.assert_allclose(last.numpy(), out.numpy(), rtol=0,
                               atol=BAR * out.abs().max().item())


@pytest.mark.parametrize("in_dim", [1, 2, 3])
def test_visualize_analysis_draws(tmp_path, in_dim):
    jk, tk = models(6, (in_dim, 3, 1))
    x = np.random.default_rng(7).uniform(-1, 1, (30, in_dim))
    analysis = tk.analyze_network(x)
    path = tmp_path / "a.png"
    fig = tk.visualize_analysis(analysis, x, y_data=x[:, :1],
                                save_path=str(path))
    assert path.exists() and len(fig.axes) >= 2 * 2


def test_visualize_analysis_without_matplotlib(monkeypatch):
    _, tk = models(6, (1, 3, 1))
    x = np.linspace(-1, 1, 10)[:, None]
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="needs matplotlib"):
        tk.visualize_analysis(tk.analyze_network(x), x)


# -- analysis/model_analysis.py ---------------------------------------------


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_model_analysis_reads_either_checkpoint(tmp_path, writer):
    jk, tk = models(8, (3, 4, 2))
    path = str(tmp_path / "m.npz")
    (jk if writer == "jax" else tk).save_model(path)
    results = str(tmp_path / "r.json")
    with open(results, "w") as f:
        json.dump({"metrics": {"test_accuracy": 0.9}}, f)
    want = jma.extract_degrees_from_checkpoint(path)
    got = extract_degrees_from_checkpoint(path, device="cpu")
    assert got["config"] == want["config"]
    for lg, lw in zip(got["layers"], want["layers"]):
        for k in lw:
            np.testing.assert_array_equal(lg[k], lw[k])
    assert compute_model_stats(got) == jma.compute_model_stats(want)
    stats, fig = analyze_models([path], [results], make_plots=True,
                                device="cpu")
    assert stats[0]["results"]["metrics"]["test_accuracy"] == 0.9
    assert stats[0]["degree_histogram"] == jma.analyze_models(
        [path])[0]["degree_histogram"]
    assert fig is not None


# -- analysis/sparsity.py ------------------------------------------------------


def test_sparsity_equals_jax(tmp_path, capsys):
    import pandas as pd

    path = str(tmp_path / "sp.parquet")
    n = 300
    rng = np.random.default_rng(0)
    f0 = rng.normal(size=n)
    f0[:50] = np.nan  # a 50-long null cluster at the start
    f1 = rng.normal(size=n)
    f1[rng.uniform(size=n) < 0.1] = np.nan
    f2 = np.arange(n, dtype=float)
    f2[85:115] = np.nan  # a run across the 100-row chunk boundary
    pd.DataFrame({"date_id": np.repeat(np.arange(10), 30),
                  "feature_00": f0, "feature_01": f1, "feature_02": f2,
                  "other": np.ones(n)}).to_parquet(path)
    for chunk in (100, 1000):
        got = compute_sparsity(path, chunk_size=chunk)
        want = jsp.compute_sparsity(path, chunk_size=chunk)
        assert isinstance(got, SparsityMetrics)
        assert got.__dict__ == want.__dict__
        assert (85, 115) in got.zero_clusters
    print_sparsity_analysis(got)
    port_out = capsys.readouterr().out
    jsp.print_sparsity_analysis(want)
    assert port_out == capsys.readouterr().out


# -- the native circuit helpers (tests/test_native.py:77-255) ----------------

pytestmark_native = pytest.mark.skipif(
    not nb.native_available(), reason="no C++ toolchain")


def both(build):
    """The same circuit in the port's and the JAX package's gate IR."""
    return build(Circuit), build(JCircuit)


def gate_list(circ):
    return [(g.name, tuple(g.qubits),
             tuple(float(p) for p in np.asarray(g.params).reshape(-1)))
            for g in circ.gates]


@pytestmark_native
def test_optimize_circuit_equals_jax():
    def build(C):
        circ = C(3)
        circ.h(0).h(0)              # cancels
        circ.ry(0.3, 1).ry(0.4, 1)  # merges to ry(0.7)
        circ.cx(0, 1).x(2).cx(0, 1)  # cancels across the commuting x(2)
        circ.swap(1, 2).swap(2, 1)  # cancels
        circ.ry(0.5, 0).ry(-0.5, 0)  # merges to zero -> dropped
        circ.rz(0.2, 2)
        circ.h(1).x(1).h(1)         # x(1) blocks the h-h cancellation
        circ.ucry([0.1, 0.2], controls=(0,), target=1)  # opaque barrier
        circ.h(1)
        return circ

    mine, theirs = both(build)
    got, want = nb.optimize_circuit(mine), jnb.optimize_circuit(theirs)
    assert gate_list(got)[:3] == gate_list(want)[:3]
    assert [g[:2] for g in gate_list(got)] == [g[:2]
                                               for g in gate_list(want)]
    for a, b in zip(gate_list(got), gate_list(want)):
        np.testing.assert_allclose(a[2], b[2], rtol=0, atol=1e-15)
    np.testing.assert_allclose(
        simulate(got, device="cpu").numpy(),
        simulate(mine, device="cpu").numpy(), atol=1e-12)
    # FABLE's elementary circuit is already peephole-minimal; an appended
    # H-H pair is removed
    circ, _ = fable(np.random.default_rng(5).uniform(-1, 1, (4, 4)),
                    fused=False)
    assert len(nb.optimize_circuit(circ).gates) == len(circ.gates)
    circ.h(0).h(0)
    assert len(nb.optimize_circuit(circ).gates) == len(circ.gates) - 2


@pytestmark_native
def test_circuit_depth_equals_jax():
    def build(C):
        rng = np.random.default_rng(2)
        circ = C(5)
        for _ in range(40):
            k = int(rng.integers(0, 3))
            if k == 0:
                circ.h(int(rng.integers(0, 5)))
            elif k == 1:
                a, b = rng.choice(5, size=2, replace=False)
                circ.cx(int(a), int(b))
            else:
                circ.ry(float(rng.uniform(-1, 1)), int(rng.integers(0, 5)))
        return circ

    mine, theirs = both(build)
    assert nb.circuit_depth_native(mine) == jnb.circuit_depth_native(theirs)
    assert nb.circuit_depth_native(mine) == mine.depth()
    # 3+-qubit gates fall back to Circuit.depth(): pinned by hand
    c2 = Circuit(5)
    c2.h(0)
    c2.ucry(np.zeros(4), controls=(1, 2), target=3)
    c2.h(3)
    assert nb.circuit_depth_native(c2) == 2


@pytestmark_native
def test_statevector_native_equals_sim_all_gates():
    rng = np.random.default_rng(0)
    q = 8
    c = Circuit(q)
    for t in range(q):
        c.h(t)
    c.x(2)
    c.z(3)
    for t in range(q):
        c.ry(float(rng.uniform(-3, 3)), t)
    c.rz(0.7, 1)
    c.cx(0, 4)
    c.cz(2, 5)
    c.swap(1, 6)
    c.cry(1.1, 3, 7)
    c.ucry(rng.uniform(-3, 3, 2 ** (q - 1)), tuple(range(q - 2, -1, -1)),
           q - 1)
    c.diagonal(np.exp(1j * rng.uniform(-3, 3, 8)), (5, 3, 1))
    ref = simulate(c, device="cpu").numpy().astype(np.complex128)
    out = nb.statevector_native(c)
    np.testing.assert_allclose(out, ref, atol=BAR)
    assert abs(np.vdot(out, out).real - 1.0) < BAR
    # the encoding equals the JAX binding's of the same gates
    jc = JCircuit(q)
    jc.gates.extend(JGate(g.name, g.qubits, g.params) for g in c.gates)
    for a, b in zip(nb.sv_encode_circuit(c), jnb.sv_encode_circuit(jc)):
        np.testing.assert_array_equal(a, b)


@pytestmark_native
def test_statevector_native_fable_reuse_and_psi0():
    rng = np.random.default_rng(3)
    a = rng.uniform(-1, 1, (8, 8))
    circ, _ = fable(a)
    ref = simulate(circ, device="cpu").numpy()
    enc = nb.sv_encode_circuit(circ)
    np.testing.assert_allclose(nb.statevector_native(circ, encoded=enc),
                               ref, atol=BAR)
    dim = 2**circ.num_qubits
    psi0 = rng.normal(size=dim) + 1j * rng.normal(size=dim)
    psi0 /= np.linalg.norm(psi0)
    ref2 = simulate(circ, psi0=torch.from_numpy(psi0), device="cpu").numpy()
    for p in (psi0, torch.from_numpy(psi0)):
        np.testing.assert_allclose(
            nb.statevector_native(circ, psi0=p, encoded=enc), ref2,
            atol=BAR)
    # the JAX package's FABLE circuit of the same matrix, through its own
    # binding
    jcirc, _ = jfable(a)
    np.testing.assert_allclose(jnb.statevector_native(jcirc),
                               nb.statevector_native(circ), atol=BAR)


@pytestmark_native
def test_statevector_native_rejects_unitary_gate():
    c = Circuit(2)
    c.unitary(np.eye(4), (1, 0))
    with pytest.raises(ValueError, match="unitary"):
        nb.sv_encode_circuit(c)


# -- dryrun.py (__graft_entry__.py) --------------------------------------------


def test_entry_equals_jax_entry():
    import __graft_entry__ as graft

    jfn, jargs = graft.entry()
    fn, args = entry("cpu")
    want = np.asarray(jfn(*jargs))
    got = fn(*args)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_dryrun_multichip_on_cpu_slots(capsys):
    out = dryrun_multichip(8, devices=["cpu"] * 8)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("dryrun_multichip ok: 8 devices,")
    assert out["norm"] == pytest.approx(1.0, abs=1e-5)
    assert out["best_E"] == out["pt_best_E"]
    # n clamps to the slots there are, as the JAX dry run clamps
    assert dryrun_multichip(20, devices=["cpu"] * 3)["devices"] == 3
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert dryrun_multichip(1, devices=["cpu"])["devices"] == 1
