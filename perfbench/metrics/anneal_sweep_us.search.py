"""Microseconds of one annealing sweep: the time inside the program's
``qkan.anneal.sweeps`` spans in the profiled search (the sweeps and the
read that waits for them) over that search's sweeps, its
``qkan.anneal.solve_qubo`` spans times the sweeps a call asks for on
average (the program's counters ``solve_qubo.sweeps`` over
``solve_qubo.calls``)."""

SWEEPS, SOLVE = "qkan.anneal.sweeps", "qkan.anneal.solve_qubo"


def _sweeps_per_call():
    from qkan_implementation_tpu_torch.anneal.sa import solve_qubo

    calls = getattr(solve_qubo, "calls", 0)
    if not calls:
        return None
    return solve_qubo.sweeps / calls


def read(ctx):
    spans = ctx.trace.annotations
    if not spans.get(SWEEPS) or not spans.get(SOLVE):
        return None
    per_call = _sweeps_per_call()
    if not per_call:
        return None
    spent_ns = sum(b - a for a, b in spans[SWEEPS])
    return spent_ns / 1e3 / (len(spans[SOLVE]) * per_call)
