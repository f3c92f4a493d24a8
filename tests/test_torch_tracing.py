"""The port's spans (``utils.profiling.span``) on the CPU, at tiny shapes.

Under ``torch.profiler`` each path emits its ``qkan.*`` spans, nested as
the layers nest, on the clock its operators are stamped on; with no
profiler a span is one shared no-op and no ``record_function`` is
entered.  The paths: ``FixedKAN.train`` (one epoch of three steps,
backend 'xla'), a two-layer ``FixedKAN.optimize`` with the annealer, and
a market trial (``DegreeOptimizer.fit`` on enough rows for the Gram
route, ``predict``, ``compute_metrics``).
"""

import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from qkan_implementation_tpu_torch.anneal import sa
from qkan_implementation_tpu_torch.models import fixed_kan as fk
from qkan_implementation_tpu_torch.optim.degree_optimizer import (
    DegreeOptimizer,
)
from qkan_implementation_tpu_torch.utils import profiling as P
from qkan_implementation_tpu_torch.utils.metrics import compute_metrics

SWEEPS = 5
STEPS, LEAVES = 3, 4  # 48 rows at batch 16; [6, 4, 3]: 2 layers x 2 leaves
MARKET_ROWS = 70_000  # 8 features x 4 degrees x rows > 2e6: the Gram route


def _kan():
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.uniform(-1, 1, (48, 6)))
    y = torch.as_tensor(rng.integers(0, 3, 48))
    kan = fk.FixedKAN(fk.FixedKANConfig(network_shape=[6, 4, 3],
                                        max_degree=3), device="cpu")
    return kan, x, y


def run_train():
    kan, x, y = _kan()
    kan.optimize(x, torch.nn.functional.one_hot(y, 3).double(),
                 solver="exact")
    return lambda: kan.train(x, y, epochs=1, batch_size=16, backend="xla")


def run_optimize():
    kan, x, y = _kan()
    y1h = torch.nn.functional.one_hot(y, 3).double()
    return lambda: kan.optimize(x, y1h, num_reads=4, num_sweeps=SWEEPS,
                                seed=1, solver="anneal")


def run_market():
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (MARKET_ROWS, 8))
    y = x[:, 0] ** 2 + 0.1 * rng.normal(size=MARKET_ROWS)
    w = rng.uniform(0.5, 1.5, MARKET_ROWS)

    def trial():
        opt = DegreeOptimizer(network_shape=[8, 1], max_degree=3,
                              device="cpu")
        opt.fit(x, y, weights=w, num_reads=4, num_sweeps=SWEEPS, seed=0)
        compute_metrics(y, opt.predict(x), w)

    return trial


# path -> (set-up returning the call, spans it emits with their counts,
# (inner, outer) pairs where each inner span lies inside an outer one,
# solve_qubo calls it makes)
CASES = {
    "train": (run_train, {
        P.TRAIN: 1, P.TRAIN_EPOCH: 1, P.TRAIN_STEP: STEPS,
        P.TRAIN_FORWARD: STEPS, P.TRAIN_BACKWARD: STEPS,
        P.TRAIN_ADAM: STEPS, P.TRAIN_EPOCH_END: 1,
    }, [(P.TRAIN_EPOCH, P.TRAIN), (P.TRAIN_STEP, P.TRAIN_EPOCH),
        (P.TRAIN_FORWARD, P.TRAIN_STEP), (P.TRAIN_BACKWARD, P.TRAIN_STEP),
        (P.TRAIN_ADAM, P.TRAIN_STEP), (P.TRAIN_EPOCH_END, P.TRAIN_EPOCH)],
        0),
    "optimize": (run_optimize, {
        P.OPTIMIZE: 1, P.OPTIMIZE_LAYER: 2, P.OPTIMIZE_SWEEP: 2,
        P.OPTIMIZE_QUBO: 2, P.OPTIMIZE_ASSEMBLE: 2, P.ANNEAL_SOLVE: 2,
        P.ANNEAL_SWEEPS: 2, P.ANNEAL_POLISH: 2,
    }, [(P.OPTIMIZE_LAYER, P.OPTIMIZE), (P.OPTIMIZE_SWEEP, P.OPTIMIZE_LAYER),
        (P.OPTIMIZE_QUBO, P.OPTIMIZE_LAYER),
        (P.ANNEAL_SOLVE, P.OPTIMIZE_LAYER),
        (P.OPTIMIZE_ASSEMBLE, P.OPTIMIZE_LAYER),
        (P.ANNEAL_SWEEPS, P.ANNEAL_SOLVE), (P.ANNEAL_POLISH, P.ANNEAL_SOLVE)],
        2),
    "market": (run_market, {
        P.DOPT_FIT: 1, P.DOPT_GRAM: 1, P.DOPT_SCORE: 1, P.DOPT_QUBO: 1,
        P.ANNEAL_SOLVE: 1, P.ANNEAL_SWEEPS: 1, P.ANNEAL_POLISH: 1,
        P.DOPT_PREDICT: 1, P.METRICS: 1,
    }, [(P.DOPT_GRAM, P.DOPT_FIT), (P.DOPT_SCORE, P.DOPT_FIT),
        (P.DOPT_QUBO, P.DOPT_FIT), (P.ANNEAL_SOLVE, P.DOPT_FIT),
        (P.ANNEAL_SWEEPS, P.ANNEAL_SOLVE), (P.ANNEAL_POLISH, P.ANNEAL_SOLVE)],
        1),
}


def profiled(call):
    """Run ``call`` under the CPU profiler; return (annotations: name ->
    [(start, end)], operators: [(name, start, end)]), in the profiler's
    ns, as ``perfbench.harness.reduce_trace`` reads them."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call()
    spans, ops = {}, []
    for e in prof.profiler.kineto_results.events():
        a, b = e.start_ns(), e.start_ns() + e.duration_ns()
        if e.is_user_annotation():
            spans.setdefault(e.name(), []).append((a, b))
        else:
            ops.append((e.name(), a, b))
    return spans, ops


def _inside(iv, outer) -> bool:
    return any(a <= iv[0] and iv[1] <= b for a, b in outer)


@pytest.mark.parametrize("path", sorted(CASES))
def test_spans_nest_and_count(path):
    setup, counts, nesting, solves = CASES[path]
    call = setup()
    calls0, sweeps0 = sa.solve_qubo.calls, sa.solve_qubo.sweeps
    spans, _ = profiled(call)
    qkan = {k: len(v) for k, v in spans.items() if k.startswith("qkan.")}
    assert qkan == counts
    for inner, outer in nesting:
        assert all(_inside(iv, spans[outer]) for iv in spans[inner]), (
            inner, outer)
    assert sa.solve_qubo.calls - calls0 == solves
    assert sa.solve_qubo.sweeps - sweeps0 == solves * SWEEPS


# path -> (span, an operator only that layer runs, its count in the call)
CLOCK = {
    "train": (P.TRAIN_ADAM, "aten::sqrt", STEPS * LEAVES),
    "optimize": (P.ANNEAL_SWEEPS, "aten::addcmul_", 2 * SWEEPS * 4),
    "market": (P.DOPT_GRAM, "aten::matmul", 4 * -(-MARKET_ROWS // 65536)),
}


@pytest.mark.parametrize("path", sorted(CLOCK))
def test_span_holds_the_operators_it_launched(path):
    """The operators a layer launched fall inside its span's interval:
    span and operators share the profiler's clock."""
    name, op, count = CLOCK[path]
    spans, ops = profiled(CASES[path][0]())
    inside = [o for o in ops if o[0] == op and _inside(o[1:], spans[name])]
    assert len(inside) == count


class _Entered(AssertionError):
    pass


def _refuse(*a, **k):
    raise _Entered("record_function entered without a profiler")


def run_stage_timer():
    timer = P.StageTimer()

    def call():
        with timer.stage("stage"):
            torch.ones(4).sum()

    return call


@pytest.mark.parametrize("path", sorted(CASES) + ["stage_timer"])
def test_no_record_function_without_profiler(path, monkeypatch):
    setup = run_stage_timer if path == "stage_timer" else CASES[path][0]
    call = setup()
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _refuse)
    assert not torch.autograd._profiler_enabled()
    call()


def test_span_is_one_shared_noop_without_profiler():
    assert not torch.autograd._profiler_enabled()
    first = P.span(P.TRAIN)
    assert isinstance(first, contextlib.nullcontext)
    assert all(P.span(n) is first for n in P.SPANS)
    with first, first:  # nested, as spans nest
        pass


def test_span_names_are_qkan_constants():
    assert len(set(P.SPANS)) == len(P.SPANS)
    assert all(n.startswith("qkan.") for n in P.SPANS)
