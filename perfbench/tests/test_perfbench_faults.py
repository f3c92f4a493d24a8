"""Each cell's check on the CPU at a small size: a sound run is correct,
and a run whose timed path is broken underneath (``perfbench.faults``)
is not, once for each fault the cell can have.  The look for a card is
skipped: the program runs its plain versions on the CPU."""

import pytest
import torch

from perfbench import harness
from perfbench.faults import FAULTS
from perfbench.run import run_cell
from perfbench.tests.conftest import small_cell

SECONDS = {"digits-train": 0.3, "digits-search": 0.1, "market-search": 0.3}


def _run(name):
    cell = small_cell(name)
    return run_cell(cell, harness.driver_for(cell), 2**31 + 101,
                    SECONDS[name], False, torch.device("cpu"))


@pytest.mark.parametrize("name", sorted(SECONDS))
def test_sound_run_is_correct(name):
    res = _run(name)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("name,fault", [
    (name, fault) for name, faults in FAULTS.items() for fault in faults])
def test_fault_is_caught(monkeypatch, name, fault):
    FAULTS[name][fault](monkeypatch.setattr)
    res = _run(name)
    assert not res["correct"], res["checks"]
