"""Profiling: stage timers and ``torch.profiler`` integration.

Counterpart of ``qkan_implementation_tpu.utils.profiling``.  The
reference instruments with ad-hoc ``time.time()`` prints -- per-stage
breakdowns with percentages and memory footprint (``LCUStep.py:126-161``);
``StageTimer`` keeps that report shape and annotates each stage through
``span`` so it shows on a profiler timeline.

Spans: ``span(name)`` marks a layer boundary of the main path (the
trainer, the structure search, the annealer, the market trial, the QKAN
layer's trainer) on the profiler's own clock, the one its kernels and
operators are stamped on.
While a ``torch.profiler`` runs it is a ``record_function``; otherwise
it is one shared ``nullcontext``, so an untraced call pays one check and
allocates nothing.  ``device_trace`` writes the spans out beside the
kernels.  Every name the program emits is in ``SPANS``.

Clocks: a stage and ``timeit_jit`` read the host clock around work that
ends in a device synchronise (a torch caller has no ``block_until_ready``
on a stage's results); ``timeit_chained`` times its chains with CUDA
events on the card and ``time.perf_counter`` on the CPU.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch


# the program's spans, outermost first within each path
TRAIN = "qkan.train"  # FixedKAN.train after its argument checks
TRAIN_EPOCH = "qkan.train.epoch"
TRAIN_STEP = "qkan.train.step"
TRAIN_FORWARD = "qkan.train.forward"  # row gather, kan_apply, loss
TRAIN_BACKWARD = "qkan.train.backward"  # torch.autograd.grad
TRAIN_ADAM = "qkan.train.adam"  # every AdamGroup.step, clipping included
TRAIN_EPOCH_END = "qkan.train.epoch_end"  # losses to the host, last_good
OPTIMIZE = "qkan.optimize"  # FixedKAN.optimize
OPTIMIZE_LAYER = "qkan.optimize.layer"
OPTIMIZE_SWEEP = "qkan.optimize.sweep"  # every degree's fit and score
OPTIMIZE_QUBO = "qkan.optimize.qubo"  # degree_selection_qubo
OPTIMIZE_ASSEMBLE = "qkan.optimize.assemble"  # C, the next layer's input
ANNEAL_SOLVE = "qkan.anneal.solve_qubo"
ANNEAL_SWEEPS = "qkan.anneal.sweeps"  # the sweeps and the wait for them
ANNEAL_POLISH = "qkan.anneal.polish"  # one-hot polish, energies after it
DOPT_FIT = "qkan.dopt.fit"  # DegreeOptimizer.fit
DOPT_GRAM = "qkan.dopt.gram"  # Gram statistics, their copy to the host
DOPT_SCORE = "qkan.dopt.score"  # the host solves of every degree
DOPT_QUBO = "qkan.dopt.qubo"
DOPT_PREDICT = "qkan.dopt.predict"
METRICS = "qkan.metrics"  # utils.metrics.compute_metrics
QLAYER_TRAIN = "qkan.qlayer.train"  # models/qkan_layer.qkan_layer_train
QLAYER_EPOCH = "qkan.qlayer.epoch"
QLAYER_STEP = "qkan.qlayer.step"
QLAYER_FUSED_STEP = "qkan.qlayer.fused_step"  # fold, K5, unfold
QLAYER_ADAM = "qkan.qlayer.adam"  # AdamGroup.step
QLAYER_EPOCH_END = "qkan.qlayer.epoch_end"  # the epoch's losses to the host

SPANS = (
    TRAIN, TRAIN_EPOCH, TRAIN_STEP, TRAIN_FORWARD, TRAIN_BACKWARD,
    TRAIN_ADAM, TRAIN_EPOCH_END,
    OPTIMIZE, OPTIMIZE_LAYER, OPTIMIZE_SWEEP, OPTIMIZE_QUBO,
    OPTIMIZE_ASSEMBLE,
    ANNEAL_SOLVE, ANNEAL_SWEEPS, ANNEAL_POLISH,
    DOPT_FIT, DOPT_GRAM, DOPT_SCORE, DOPT_QUBO, DOPT_PREDICT,
    METRICS,
    QLAYER_TRAIN, QLAYER_EPOCH, QLAYER_STEP, QLAYER_FUSED_STEP, QLAYER_ADAM,
    QLAYER_EPOCH_END,
)

# nullcontext keeps no state, so one object serves every untraced span,
# nested or not
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager marking ``name`` on the running profiler's
    timeline: ``torch.profiler.record_function(name)`` while a profiler
    is active, else one shared no-op context (no allocation, no
    ``record_function``)."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


def _sync() -> None:
    """Wait for the current CUDA device, if this process has used one."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class StageTimer:
    """Accumulate named stage durations; render the reference-style report.

    >>> timer = StageTimer()
    >>> with timer.stage("weights"): ...
    >>> with timer.stage("circuit"): ...
    >>> print(timer.report(memory_bytes=expected.nbytes))

    A stage synchronises the CUDA device on exit when CUDA is initialised,
    so its seconds include the device work it launched.
    """

    def __init__(self, annotate_trace: bool = True):
        self.durations: Dict[str, float] = {}
        self.annotate_trace = annotate_trace

    @contextlib.contextmanager
    def stage(self, name: str):
        ctx = span(name) if self.annotate_trace else _OFF
        start = time.perf_counter()
        with ctx:
            yield
            _sync()
        self.durations[name] = self.durations.get(name, 0.0) + (
            time.perf_counter() - start
        )

    @property
    def total(self) -> float:
        return sum(self.durations.values())

    def report(self, memory_bytes: Optional[int] = None) -> str:
        """Stage breakdown with percentages (the LCUStep.py:152-161 shape)."""
        lines = ["Breakdown of computation:"]
        total = self.total or 1e-30
        for name, dur in self.durations.items():
            lines.append(f"{name}: {dur:.4f}s ({dur / total * 100:.1f}%)")
        lines.append(f"Total: {total:.4f}s")
        if memory_bytes is not None:
            lines.append(f"Memory footprint: {memory_bytes / 1024 / 1024:.2f} MB")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a ``torch.profiler`` trace (CPU, and CUDA where there is a
    card) around a block and write it into ``log_dir`` as a Chrome trace
    (``trace_<pid>_<ns>.json``; open it in Perfetto or chrome://tracing).
    Yields the profiler, whose ``key_averages()`` reads the same events.
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
        _sync()
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def timeit_chained(fn, x, iters: int = 50, consts: tuple = ()) -> float:
    """Steady-state seconds/call of a shape-preserving ``x -> x`` function:
    slope timing over two chain lengths.

    Each chain feeds every call the previous result, so the steps are
    data-dependent; the (long - short) difference cancels the fixed cost
    of starting a chain and reading its result.  ``consts``: further
    arguments of every call.  A chain on a CUDA tensor is timed by CUDA
    events, on a CPU tensor by ``time.perf_counter``.
    """
    cuda = isinstance(x, torch.Tensor) and x.is_cuda

    def chain(n):
        c = x
        for _ in range(n):
            c = fn(c, *consts)
        return c

    def timed(n) -> float:
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            chain(n)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
        t0 = time.perf_counter()
        chain(n)
        return time.perf_counter() - t0

    short_n, long_n = iters, iters * 6
    timed(short_n)  # warm
    timed(long_n)
    t_short = min(timed(short_n) for _ in range(2))
    t_long = min(timed(long_n) for _ in range(2))
    slope = (t_long - t_short) / (long_n - short_n)
    # Noise floor: when the two chain timings are within measurement noise
    # the slope can be ~0 or negative, and callers would report absurd
    # rates.  Fall back to the long chain's average per-step time -- an
    # UPPER bound on the true per-step cost.
    floor = t_long / long_n / 50.0
    if slope < floor:
        return t_long / long_n
    return slope


def timeit_jit(fn, *args, iters: int = 50, warmup: int = 2) -> float:
    """Steady-state seconds/call of ``fn(*args)``: the median over
    ``iters`` calls, each timed on the host clock between two device
    synchronises, after ``warmup`` calls."""
    for _ in range(warmup):
        fn(*args)
    times = []
    for _ in range(iters):
        _sync()
        t0 = time.perf_counter()
        fn(*args)
        _sync()
        times.append(time.perf_counter() - t0)
    times.sort()
    mid = len(times) // 2
    return times[mid] if len(times) % 2 else 0.5 * (times[mid - 1]
                                                    + times[mid])
