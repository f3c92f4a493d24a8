"""The parts of a run that every cell shares: finding a cell's files by
name, host spans, the profiler's trace reduced to what the per-layer
metrics read, and the check that no JAX module was loaded.

Nothing here imports the program: the drivers under ``drivers/`` do.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent

# one process with one host thread for numpy's and torch's pools: idle
# pool threads that spin after a parallel region take cores from the
# thread that launches the work, and the cells are host-bound
THREAD_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")


def one_host_thread() -> None:
    """Set the thread pools to one thread; call before numpy or torch is
    imported."""
    for var in THREAD_VARS:
        os.environ[var] = "1"


# top-level module names that may not be loaded: JAX and the JAX package
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "qkan_implementation_tpu")


def forbidden_loaded(modules=None) -> list[str]:
    """Names in ``modules`` (default ``sys.modules``) whose top-level
    name, the part before the first dot, is a forbidden one."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN_MODULES)


def process_age_s() -> float:
    """Seconds since this process started, from /proc."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start_ticks = int(fields[19])  # starttime, field 22 of stat
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """One entry of BENCHMARK.json's workloads, with its files loaded."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    here: Path = HERE  # the benchmark's folder the cell was found in


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(bench: dict, name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``bench``: its configuration's file, its
    traffic mix ``traffic/<traffic>.json``, its limits
    ``limits/<name>.json`` and the metrics that apply to it."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; have {sorted(cells)}")
    w = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    here = root / "perfbench"
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=load_json(root / cfg_entry["file"]),
        traffic=load_json(here / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(here / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
        here=here,
    )


def load_module(path: Path, name: str):
    """Import a file of the benchmark by its path."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver_for(cell: Cell):
    """``drivers/<driver>.py``, the driver the traffic mix names."""
    name = cell.traffic["driver"]
    return load_module(cell.here / "drivers" / f"{name}.py",
                       f"perfbench_driver_{name}")


def metric_reader(name: str, here: Path):
    """``metrics/<name>.py``'s ``read``."""
    return load_module(here / "metrics" / f"{name}.py",
                       "perfbench_metric_" + name.replace(".", "_")).read


class Spans:
    """Host spans (name, start, end) in perf_counter seconds, kept in
    memory; while the profiler runs each is also an annotation in its
    trace."""

    def __init__(self):
        self.items: list[tuple[str, float, float]] = []
        self.annotate = False

    @contextmanager
    def __call__(self, name: str):
        if self.annotate:
            import torch
            with torch.profiler.record_function(name):
                t0 = time.perf_counter()
                yield
                self.items.append((name, t0, time.perf_counter()))
        else:
            t0 = time.perf_counter()
            yield
            self.items.append((name, t0, time.perf_counter()))


@dataclass
class Trace:
    """A profiled window reduced to intervals (ns, the profiler's clock).

    ``device``: (name, start, end, kind) of every kernel, copy and set
    on the card (kind: 'kernel', 'gpu_memcpy' or 'gpu_memset'); ``launches``: start of each kernel launch call on the host;
    ``annotations``: name -> [(start, end)] of the spans that ran inside
    the window; ``host_ops``: (name, start, end) of the host's operators.
    """

    window_s: float
    device: list = field(default_factory=list)
    launches: list = field(default_factory=list)
    annotations: dict = field(default_factory=dict)
    host_ops: list = field(default_factory=list)

    def kernels(self) -> list:
        return [e for e in self.device if e[3] == "kernel"]

    def busy_s(self) -> float:
        """Seconds in which something ran on the card: the union of the
        device intervals."""
        total, end = 0, None
        for _, a, b, _ in sorted(self.device, key=lambda e: e[1]):
            if end is None or a > end:
                total += b - a
                end = b
            elif b > end:
                total += b - end
                end = b
        return total / 1e9

    def launches_within(self, name: str) -> int:
        spans = self.annotations.get(name, [])
        return sum(1 for t in self.launches
                   if any(a <= t <= b for a, b in spans))

    def top_device_ops(self, k: int = 10) -> list:
        by = {}
        for n, a, b, _ in self.device:
            by[n] = by.get(n, 0) + (b - a)
        return [[n, v / 1e9] for n, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> list:
        """The longest gaps between device work, each named by the
        innermost benchmark span, else host operator, running at its
        middle."""
        ev = sorted(self.device, key=lambda e: e[1])
        gaps, end = [], None
        for _, a, b, _ in ev:
            if end is not None and a > end:
                gaps.append((a - end, end, a))
            end = b if end is None else max(end, b)
        gaps.sort(reverse=True)
        spans = [(n, a, b) for n, iv in self.annotations.items()
                 for a, b in iv]
        out = []
        for length, a, b in gaps[:k]:
            mid = (a + b) / 2
            inner = [s for s in spans if s[1] <= mid <= s[2]]
            ops = [o for o in self.host_ops if o[1] <= mid <= o[2]]
            pick = min(inner, key=lambda s: s[2] - s[1]) if inner else (
                min(ops, key=lambda s: s[2] - s[1]) if ops else None)
            label = pick[0] if pick else "host python"
            out.append([label, length / 1e9])
        return out


_LAUNCH_NAMES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                 "cudaLaunchCooperativeKernel", "cuLaunchKernelEx")


def reduce_trace(prof, window_s: float) -> Trace:
    """The profiler's events reduced to a ``Trace``.  Events on the card
    that are not annotations are its work (copies and sets by their
    names); on the host, launch calls, annotations and operators."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    tr = Trace(window_s=window_s)
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        a = e.start_ns()
        b = a + e.duration_ns()
        if e.is_user_annotation():
            if e.device_type() != cuda:
                tr.annotations.setdefault(name, []).append((a, b))
        elif e.device_type() == cuda:
            kind = ("gpu_memcpy" if name.startswith("Memcpy") else
                    "gpu_memset" if name.startswith("Memset") else "kernel")
            tr.device.append((name, a, b, kind))
        elif name.startswith(_LAUNCH_NAMES):
            tr.launches.append(a)
        elif not name.startswith(("cuda", "Activity Buffer")):
            # the profiler's own buffer requests are not the program's
            tr.host_ops.append((name, a, b))
    return tr


def profiled(fn):
    """Run ``fn`` under torch.profiler (host and card) and return
    (fn's result, the window's ``Trace``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    return out, reduce_trace(prof, window_s)
