"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell, its configuration, traffic mix, limits and metrics are found
by name from BENCHMARK.json at the root of the checkout.  The run builds
its inputs from the seed, warms up (set-up), measures for ``--seconds``,
then checks what the timed path produced against the plain reference.
With ``--trace 1`` it also profiles one unit of the cell's work and
reports the per-layer metrics instead of the end-to-end ones.

The last line of standard output is one JSON object: correct, attempted,
failed, metrics, device, breakdown (traced runs) and checks (each number
compared, with its limit).  The run fails without printing a result when
no CUDA card is there (or fewer than the cell asks for), or when a JAX
module was loaded.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import harness  # noqa: E402

harness.one_host_thread()


def _cache_dirs(root: Path) -> None:
    """Kernel caches at fixed paths inside the checkout."""
    cache = root / "perfbench" / "_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")


class Context:
    """What the per-layer metric readers see: the cell, the window's
    results, the host spans that ran inside it, the traced unit's results
    and its trace."""

    def __init__(self, cell, window, spans, unit, trace):
        self.cell = cell
        self.window = window
        self.spans = spans
        self.unit = unit
        self.trace = trace


def run_cell(cell, driver, seed: int, seconds: float, trace: bool,
             device, spans=None) -> dict:
    """One run of ``cell``: set-up, window, optional traced unit, then
    the check.  Returns the result object (without the device block)."""
    import torch

    spans = spans or harness.Spans()
    state = driver.setup(cell, seed, device, spans, trace)
    setup_s = harness.process_age_s()
    w0 = time.perf_counter()
    window = driver.window(state, seconds)
    w1 = time.perf_counter()
    in_window = [s for s in spans.items if w0 <= s[1] and s[2] <= w1]
    unit, tr = None, None
    if trace:
        spans.annotate = True
        unit, tr = harness.profiled(lambda: driver.unit(state))
        spans.annotate = False
    on_card = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    driver.release(state)
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    numbers = driver.check(state)
    checks = {k: {"value": v, "limit": cell.limits[k]}
              for k, v in numbers.items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    if trace:
        ctx = Context(cell, window, in_window, unit, tr)
        metrics = {}
        for m in cell.per_layer:
            value = harness.metric_reader(m["name"], cell.here)(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = dict(window["metrics"], setup_s=setup_s)
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    out = {
        "correct": correct,
        "attempted": window["attempted"],
        "failed": window["failed"],
        "metrics": metrics,
        "peak": peak,
    }
    if trace:
        out["trace"] = tr
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = harness.load_json(ROOT / "BENCHMARK.json")
    cell = harness.load_cell(bench, args.workload, ROOT)
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("perfbench: no CUDA card is available; the benchmark measures "
              "the card and never runs on the CPU", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    _cache_dirs(ROOT)
    driver = harness.driver_for(cell)
    res = run_cell(cell, driver, args.seed % 2**63, args.seconds,
                   bool(args.trace), torch.device("cuda", 0))

    found = harness.forbidden_loaded()
    if found:
        print("perfbench: JAX modules were loaded: " + ", ".join(found),
              file=sys.stderr)
        return 3
    device = {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": cell.chips,
        "memory_peak_bytes": res["peak"],
    }
    line = {k: res[k] for k in ("correct", "attempted", "failed", "metrics")}
    line["device"] = device
    if args.trace:
        tr = res["trace"]
        device["busy_s"] = tr.busy_s() / cell.chips
        device["window_s"] = tr.window_s
        line["breakdown"] = {"device_ops": tr.top_device_ops(),
                             "idle_gaps": tr.idle_gaps()}
    line["checks"] = res["checks"]
    for k, c in res["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
