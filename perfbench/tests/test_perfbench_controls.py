"""Each cell's control fails its check on the card: the plain reference,
computed in the next lower precision than the configuration states
(TF32 products for the float32 digits cells, float32 for the float64
market cell), put in the program's place.  Each cell runs at its own
size, which a run on the card holds in seconds and at which its limits
were set: at a cut size digits-train's first timed epoch starts nearer
the random start, where sound runs read up to 3e-5.  ``readings.py``
reads the same over many seeds."""

import math

import pytest

from perfbench import harness
from perfbench.tests.conftest import ROOT

pytestmark = pytest.mark.gpu

CELLS = ["digits-train", "market-search", "digits-search"]


def _fails(cell, numbers) -> bool:
    return any(not math.isfinite(v) or v > cell.limits[k]
               for k, v in numbers.items())


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [3, 2**31 + 7, 123456789])
def test_control_fails_and_program_passes(cuda, name, seed):
    cell = harness.load_cell(harness.load_json(ROOT / "BENCHMARK.json"),
                             name, ROOT)
    driver = harness.driver_for(cell)
    state = driver.setup(cell, seed, cuda, harness.Spans(), False)
    driver.window(state, 1.0)
    driver.release(state)
    assert not _fails(cell, driver.check(state))
    assert _fails(cell, driver.check(state, control=True))
