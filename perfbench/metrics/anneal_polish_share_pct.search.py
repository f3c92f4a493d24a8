"""The one-hot polish's share of the annealer: the time inside the
program's ``qkan.anneal.polish`` spans (``polish_one_hot_blocks`` and
the energies after it) over the time inside its
``qkan.anneal.solve_qubo`` spans, in the profiled search."""

POLISH, SOLVE = "qkan.anneal.polish", "qkan.anneal.solve_qubo"


def read(ctx):
    spans = ctx.trace.annotations
    if not spans.get(POLISH) or not spans.get(SOLVE):
        return None
    polish = sum(b - a for a, b in spans[POLISH])
    solve = sum(b - a for a, b in spans[SOLVE])
    return 100.0 * polish / solve
