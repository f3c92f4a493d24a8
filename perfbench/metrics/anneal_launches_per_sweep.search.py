"""Kernel launches of the annealer per sweep: the launch calls made inside
the spans around the program's ``solve_qubo`` in the profiled search, over
the sweeps those calls asked for."""


def read(ctx):
    sweeps = ctx.unit.get("sweeps", 0)
    launches = ctx.trace.launches_within("perfbench.solve_qubo")
    if not sweeps or not launches:
        return None
    return launches / sweeps
