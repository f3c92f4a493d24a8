"""The readers of the program's own spans, on hand-made traces: each gives
its expected value, and None where its spans are missing (a program
that does not emit them, as before the spans existed)."""

from types import SimpleNamespace

import pytest

from perfbench import harness
from perfbench.tests.conftest import ROOT
from qkan_implementation_tpu_torch.anneal import sa
from qkan_implementation_tpu_torch.utils import profiling

HERE = ROOT / "perfbench"
MS = 1_000_000  # ns

# two steps of 10 ms, each with 4 ms of Adam; launches at 1, 2 and 3 ms
# into the first Adam span, 1 ms into the second, and one outside
TRAIN = {
    "qkan.train.step": [(0, 10 * MS), (10 * MS, 20 * MS)],
    "qkan.train.adam": [(5 * MS, 9 * MS), (15 * MS, 19 * MS)],
}
TRAIN_LAUNCHES = [6 * MS, 7 * MS, 8 * MS, 16 * MS, 12 * MS]
# two solve_qubo calls of 100 ms; 60 ms of sweeps and 30 of polish each
SEARCH = {
    "qkan.anneal.solve_qubo": [(0, 100 * MS), (200 * MS, 300 * MS)],
    "qkan.anneal.sweeps": [(0, 60 * MS), (200 * MS, 260 * MS)],
    "qkan.anneal.polish": [(60 * MS, 90 * MS), (260 * MS, 290 * MS)],
    "qkan.dopt.predict": [(100 * MS, 150 * MS)],
    "qkan.metrics": [(150 * MS, 160 * MS), (160 * MS, 170 * MS)],
}

# metric -> (annotations, expected value, program counters calls/sweeps)
CASES = {
    "train.adam_share_pct": (TRAIN, 40.0, None),
    "train.adam_launches_per_step": (TRAIN, 2.0, None),
    "anneal_polish_share_pct.search": (SEARCH, 30.0, None),
    # 120 ms over 2 calls x 1000 sweeps: 60 us a sweep
    "anneal_sweep_us.search": (SEARCH, 60.0, (8, 8000)),
    # 70 ms of 0.5 s
    "predict_share_pct.search": (SEARCH, 14.0, None),
}


def _ctx(annotations):
    trace = harness.Trace(window_s=0.5, annotations=annotations,
                          launches=list(TRAIN_LAUNCHES))
    return SimpleNamespace(trace=trace, unit={}, window={}, spans=[])


@pytest.fixture
def counters(monkeypatch):
    def set_counts(calls, sweeps):
        monkeypatch.setattr(sa.solve_qubo, "calls", calls, raising=False)
        monkeypatch.setattr(sa.solve_qubo, "sweeps", sweeps, raising=False)
    return set_counts


@pytest.mark.parametrize("name", sorted(CASES))
def test_reader_value(name, counters):
    annotations, want, counts = CASES[name]
    if counts:
        counters(*counts)
    got = harness.metric_reader(name, HERE)(_ctx(annotations))
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", sorted(CASES))
def test_reader_without_its_spans_is_none(name, counters):
    counters(8, 8000)
    # the benchmark's own spans alone, as a program without spans leaves
    outside = {"perfbench.solve_qubo": [(0, 100 * MS)],
               "perfbench.search": [(0, 500 * MS)]}
    assert harness.metric_reader(name, HERE)(_ctx(outside)) is None


def test_sweep_reader_without_the_counters_is_none(counters):
    counters(0, 0)
    read = harness.metric_reader("anneal_sweep_us.search", HERE)
    assert read(_ctx(SEARCH)) is None


@pytest.mark.parametrize("name", sorted(CASES))
def test_reader_names_are_program_spans(name):
    mod = harness.load_module(HERE / "metrics" / f"{name}.py",
                              "span_names_" + name.replace(".", "_"))
    used = {v for v in vars(mod).values()
            if isinstance(v, str) and v.startswith("qkan.")}
    assert used and used <= set(profiling.SPANS)
