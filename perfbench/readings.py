"""Readings from which a cell's limits are set: the numbers its check
compares, for the program and for the control, over many seeds in one
process.

    python3 perfbench/readings.py --workload <name> --seconds <s> \
        --seeds <n> [<n> ...] [--fault <name>]

For each seed: set-up, a window of ``--seconds`` at the cell's own load,
then the check of the program's outputs and the check with the control
(the plain reference in the next lower precision) in the program's
place.  One JSON line a seed.  With ``--fault`` the fault of that name
(``perfbench.faults``) is planted in the program first, and only the
program's numbers are read.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import harness  # noqa: E402

harness.one_host_thread()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault")
    args = ap.parse_args(argv)
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("readings: no CUDA card", file=sys.stderr)
        return 2
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    cell = harness.load_cell(bench, args.workload, ROOT)
    driver = harness.driver_for(cell)
    device = torch.device("cuda", 0)
    if args.fault:
        from perfbench.faults import FAULTS

        FAULTS[args.workload][args.fault](setattr)
    for seed in args.seeds:
        t0 = time.perf_counter()
        state = driver.setup(cell, seed, device, harness.Spans(), False)
        setup = time.perf_counter() - t0
        w = driver.window(state, args.seconds)
        driver.release(state)
        gc.collect()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        program = driver.check(state)
        t2 = time.perf_counter()
        try:
            control = (None if args.fault
                       else driver.check(state, control=True))
        except RuntimeError as err:  # a control that fails to compute
            control = {"error": str(err)[:200]}
        print(json.dumps({
            "seed": seed, "setup_s": setup, "attempted": w["attempted"],
            "metrics": w["metrics"], "check_s": t2 - t1,
            "fault": args.fault, "program": program, "control": control}),
            flush=True)
        del state
        gc.collect()
        torch.cuda.empty_cache()
    found = harness.forbidden_loaded()
    if found:
        print("readings: JAX modules were loaded: " + ", ".join(found),
              file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
