"""The reader of ``anneal_kernel_sweep_pct.search`` on counters set by hand:
the share of the asked-for sweeps that ran in the block-diagonal sweep
kernel, and None where no sweep was asked for or the program has no
kernel counter (as before the kernel existed)."""

from types import SimpleNamespace

import pytest

from perfbench import harness
from perfbench.tests.conftest import ROOT
from qkan_implementation_tpu_torch.anneal import sa

HERE = ROOT / "perfbench"


def _ctx():
    trace = harness.Trace(window_s=0.5, annotations={}, launches=[])
    return SimpleNamespace(trace=trace, unit={}, window={}, spans=[])


@pytest.fixture
def kernel_counters(monkeypatch):
    """Set ``solve_qubo.sweeps`` and ``simulated_annealing.kernel_sweeps``
    by hand; a kernel count of None takes the counter away, as in a
    program without the kernel."""
    def set_counts(sweeps, kernel_sweeps):
        monkeypatch.setattr(sa.solve_qubo, "sweeps", sweeps, raising=False)
        if kernel_sweeps is None:
            monkeypatch.delattr(sa.simulated_annealing, "kernel_sweeps",
                                raising=False)
        else:
            monkeypatch.setattr(sa.simulated_annealing, "kernel_sweeps",
                                kernel_sweeps, raising=False)
    return set_counts


@pytest.mark.parametrize("sweeps,kernel_sweeps,want", [
    (8000, 8000, 100.0),  # every sweep in the kernel
    (8000, 2000, 25.0),
    (8000, 0, 0.0),  # every sweep on the CPU's torch ops
    (0, 0, None),  # no sweep asked for
    (8000, None, None),  # a program without the kernel's counter
])
def test_kernel_sweep_share_reads_the_counters(kernel_counters, sweeps,
                                               kernel_sweeps, want):
    kernel_counters(sweeps, kernel_sweeps)
    read = harness.metric_reader("anneal_kernel_sweep_pct.search", HERE)
    got = read(_ctx())
    if want is None:
        assert got is None
    else:
        assert got == pytest.approx(want, rel=1e-12)
