"""The annealer's share of the searches of the measured window: the
program's own degree-selection seconds (``last_search_stats``) where it
reports them, else the host spans around its ``solve_qubo`` calls, over
the window's time."""


def read(ctx):
    w = ctx.window
    if "select_s" in w:
        spent = w["select_s"]
    else:
        spent = sum(b - a for n, a, b in ctx.spans
                    if n == "perfbench.solve_qubo")
    if spent <= 0:
        return None
    return 100.0 * spent / w["elapsed_s"]
