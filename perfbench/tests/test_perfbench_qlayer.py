"""The QKAN layer's training cell on the CPU: its counts against hand
counts at the cell's shape, its readers on hand-made traces (None where
their spans or kernels are missing, as on a program without them), its
inputs from the seed, and its check at a small size: a sound run is
correct and each planted fault (``perfbench.faults_qlayer``) is not.
The look for a card is skipped: the program runs its plain versions on
the CPU."""

from types import SimpleNamespace

import pytest
import torch

from perfbench import counts_qlayer, harness
from perfbench.faults_qlayer import FAULTS
from perfbench.run import run_cell
from perfbench.tests.conftest import ROOT

CELL = "qkan-layer-16x16-d7"
HERE = ROOT / "perfbench"
MS = 1_000_000  # ns
B = 4_194_304  # the cell's batch


def _cell(rows=8192, batch=2048):
    """The cell with its rows cut to a size a CPU test run holds; the
    widths stay as published."""
    cell = harness.load_cell(harness.load_json(ROOT / "BENCHMARK.json"),
                             CELL, ROOT)
    cell.traffic.update(rows=rows, batch_size=batch)
    return cell


def test_counts_at_the_cells_shape():
    cfg = _cell().config
    n, d, k = cfg["N"], cfg["max_degree"], cfg["K"]
    assert (n, d, k) == (16, 7, 16)
    bytes_moved, flops = counts_qlayer.fused_step_counts(B, n, d, k)
    # x and y [B, 16] read, w2 [128, 16] read, dW [128, 16] and the loss
    # written, 4 bytes each
    assert bytes_moved == 4 * (B * 16 + B * 16 + 2048 + 2048 + 1)
    # 2*B*16*7*16 for the forward's degrees 1..7 and as many for dW
    assert flops == 2 * 2 * B * 16 * 7 * 16 == 30_064_771_072
    # 3 x 3.006e10 / 495e12 = 182.2 us over 536.9 MB / 3.35 TB/s = 160.3 us
    assert counts_qlayer.fused_step_bound_s(B, n, d, k) == pytest.approx(
        30_064_771_072 / 165e12, rel=1e-12)
    assert counts_qlayer.step_model_flops(B, n, d, k) == 2 * 2 * B * 16 * 8 * 16


K5 = "void (anonymous namespace)::fused_step_kernel_tc<float, 2, 1>"
PS = "(anonymous namespace)::partial_sum_kernel(float const*)"
LOSS = "(anonymous namespace)::fused_step_loss_kernel(float const*)"
ADAM_K = "void at::native::vectorized_elementwise_kernel<4>"
# two steps of 2 ms, each with 0.5 ms of Adam; in each, K5 1.3 ms, the
# pass and the loss sum 10 us each and 2 Adam kernels of 5 us; launch
# calls: 3 a step inside the steps' spans, one outside
STEPS = [(0, 2 * MS), (2 * MS, 4 * MS)]
ADAM = [(int(1.5 * MS), 2 * MS), (int(3.5 * MS), 4 * MS)]
DEVICE = []
for s0, _ in STEPS:
    DEVICE += [(K5, s0, s0 + 1_300_000, "kernel"),
               (PS, s0 + 1_300_000, s0 + 1_310_000, "kernel"),
               (LOSS, s0 + 1_310_000, s0 + 1_320_000, "kernel"),
               (ADAM_K, s0 + 1_600_000, s0 + 1_605_000, "kernel"),
               (ADAM_K, s0 + 1_700_000, s0 + 1_705_000, "kernel")]
LAUNCHES = [100_000, 200_000, 300_000, 2_100_000, 2_200_000, 2_300_000,
            5 * MS]
ANNOTATIONS = {"qkan.qlayer.step": STEPS, "qkan.qlayer.adam": ADAM}


def _ctx(annotations=ANNOTATIONS, device=DEVICE, window_s=0.005):
    trace = harness.Trace(window_s=window_s, device=list(device),
                          launches=list(LAUNCHES),
                          annotations=dict(annotations))
    return SimpleNamespace(cell=_cell(), trace=trace, unit={"steps": 2},
                           window={"batch": B, "step_s": 1.5e-3}, spans=[])


def _read(name, ctx):
    return harness.metric_reader(name, HERE)(ctx)


def test_roofline_reader():
    bound = counts_qlayer.fused_step_bound_s(B, 16, 7, 16)
    want = 100.0 * bound * 2 / (2 * 1.32e-3)
    assert _read("qlayer.fused_step_roofline", _ctx()) == pytest.approx(
        want, rel=1e-9)


def test_mfu_reader():
    flops = counts_qlayer.step_model_flops(B, 16, 7, 16)
    assert _read("qlayer.step_mfu_pct", _ctx()) == pytest.approx(
        100.0 * flops / (1.5e-3 * 165e12), rel=1e-12)


def test_launches_and_adam_share_readers():
    assert _read("qlayer.launches_per_step", _ctx()) == 3.0
    assert _read("qlayer.adam_share_pct", _ctx()) == pytest.approx(25.0)


def test_idle_reader():
    # busy: 2 x (1.32 + 0.005 + 0.005) ms of a 5-ms window
    assert _read("device_idle_pct.qlayer", _ctx()) == pytest.approx(
        100.0 * (1 - 2.66e-3 / 5e-3), rel=1e-9)


@pytest.mark.parametrize("name", ["qlayer.fused_step_roofline",
                                  "qlayer.launches_per_step",
                                  "qlayer.adam_share_pct"])
def test_readers_without_the_programs_spans_are_none(name):
    outside = {"perfbench.unit": [(0, 5 * MS)]}
    assert _read(name, _ctx(annotations=outside)) is None


def test_roofline_without_its_kernels_is_none():
    other = [e for e in DEVICE if e[0] == ADAM_K]
    assert _read("qlayer.fused_step_roofline", _ctx(device=other)) is None
    assert _read("device_idle_pct.qlayer", _ctx(device=[])) is None


def test_cell_lists_its_metrics():
    names = {m["name"] for m in _cell().per_layer}
    assert names == {"qlayer.fused_step_roofline", "qlayer.step_mfu_pct",
                     "qlayer.launches_per_step", "qlayer.adam_share_pct",
                     "device_idle_pct.qlayer"}
    assert {m["name"] for m in _cell().end_to_end} == {"train_rows_per_s",
                                                       "setup_s"}


def test_inputs_come_from_the_seed():
    cell = _cell(rows=4096, batch=1024)
    make = harness.driver_for(cell).make_data
    a = make(cell, 2**31 + 5, torch.device("cpu"))
    b = make(cell, 2**31 + 5, torch.device("cpu"))
    c = make(cell, 2**31 + 6, torch.device("cpu"))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["x"], c["x"])
    assert a["x"].shape == (4096, 16) and a["y"].shape == (4096, 16)
    assert a["start"].shape == (8, 256)
    assert float(a["x"].abs().max()) <= 1.0
    assert all(t.dtype == torch.float32 for t in a.values())


def _run(seed=2**31 + 101):
    cell = _cell()
    return run_cell(cell, harness.driver_for(cell), seed, 0.3, False,
                    torch.device("cpu"))


def test_sound_run_is_correct():
    res = _run()
    assert res["correct"], res["checks"]
    assert set(res["checks"]) == {"loss_gap", "grad_gap", "change_gap"}
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"train_rows_per_s", "setup_s"}


@pytest.mark.parametrize("fault", sorted(FAULTS[CELL]))
def test_fault_is_caught(monkeypatch, fault):
    FAULTS[CELL][fault](monkeypatch.setattr)
    res = _run()
    assert not res["correct"], res["checks"]
