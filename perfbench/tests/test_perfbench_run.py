"""The command's contract on the CPU: no card, no result; a cell made of
new files only is found; a run reports what the contract asks."""

import json
import shutil
import subprocess
import sys

import pytest
import torch

from perfbench import harness
from perfbench.run import run_cell
from perfbench.tests.conftest import ROOT, small_cell


def test_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "digits-train",
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "no CUDA card" in out.stderr


def test_every_cell_names_files_that_exist():
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    for w in bench["workloads"]:
        cell = harness.load_cell(bench, w["name"], ROOT)
        assert callable(harness.driver_for(cell).check)
        for m in cell.per_layer:
            assert callable(harness.metric_reader(m["name"], cell.here))
        assert cell.limits and cell.end_to_end and cell.per_layer


def test_a_cell_of_new_files_is_found(tmp_path):
    """A new configuration, traffic mix, limits and per-layer metric,
    added as files beside the others, run without an edit to any file
    that was there (BENCHMARK.json only gains entries)."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    here = tmp_path / "perfbench"
    cfg = harness.load_json(here / "configs" / "digits-784-32-16-16-10.json")
    cfg["max_degree"] = 3
    (here / "configs" / "digits-d3.json").write_text(json.dumps(cfg))
    mix = harness.load_json(here / "traffic" / "epoch-b64.json")
    mix.update(batch_size=128, rows=512)
    (here / "traffic" / "epoch-b128.json").write_text(json.dumps(mix))
    (here / "limits" / "digits-d3-train.json").write_text(
        (here / "limits" / "digits-train.json").read_text())
    (here / "metrics" / "train.epochs.py").write_text(
        "def read(ctx):\n    return float(ctx.window['attempted'])\n")
    bench["configs"].append({"name": "digits-d3", "source": "x",
                             "file": "perfbench/configs/digits-d3.json",
                             "reduced": ["max_degree"], "why": "x"})
    bench["workloads"].append({"name": "digits-d3-train",
                               "config": "digits-d3", "traffic": "epoch-b128",
                               "chips": 1, "why": "x"})
    bench["end_to_end"][0]["workloads"].append("digits-d3-train")
    bench["per_layer"].append({
        "name": "train.epochs", "unit": "epochs", "better": "higher",
        "source": "host_clock", "layer": "x", "moves": "train_rows_per_s",
        "workloads": ["digits-d3-train"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = harness.load_cell(bench, "digits-d3-train", tmp_path)
    assert cell.config["max_degree"] == 3
    assert cell.traffic["batch_size"] == 128
    assert [m["name"] for m in cell.per_layer] == ["train.epochs"]
    res = run_cell(cell, harness.driver_for(cell), 21, 0.2, False,
                   torch.device("cpu"))
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"train_rows_per_s", "setup_s"}
    ctx = type("Ctx", (), {"window": {"attempted": 2}})()
    assert harness.metric_reader("train.epochs", cell.here)(ctx) == 2.0


@pytest.mark.parametrize("name", ["digits-train", "market-search"])
def test_a_small_run_reports_the_contracts_keys(name):
    cell = small_cell(name)
    res = run_cell(cell, harness.driver_for(cell), 2**31 + 17, 0.5, False,
                   torch.device("cpu"))
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert {m["name"] for m in cell.end_to_end} == set(res["metrics"])
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert list(res)[-1] == "checks"
    assert set(res["checks"]) == set(cell.limits)
