"""CPU tests of the benchmark harness, run with
``python -m pytest perfbench/tests``.  Tests marked ``gpu`` need a CUDA
card and skip without one."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import harness  # noqa: E402

# each cell cut to a size a CPU test run holds; widths stay as published
SMALL = {
    "digits-train": {"traffic": {"rows": 640}},
    "digits-search": {"traffic": {"rows": 6000, "num_reads": 20,
                                  "num_sweeps": 20}},
    "market-search": {"config": {"n_rows": 20000}, "traffic": {"num_reads": 20}},
}


def small_cell(name: str, root: Path = ROOT):
    """The cell ``name`` with its sizes cut as ``SMALL`` says."""
    cell = harness.load_cell(
        harness.load_json(root / "BENCHMARK.json"), name, root)
    over = SMALL[name]
    cell.traffic.update(over.get("traffic", {}))
    cell.config.update(over.get("config", {}))
    return cell


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
