"""Share of the annealer's sweeps that ran in the block-diagonal sweep
kernel (``csrc/anneal_blocked.cu``), in percent: the program's counter
``simulated_annealing.kernel_sweeps`` (the sweeps of each kernel launch)
over ``solve_qubo.sweeps`` (the sweeps its calls asked for), both counted
since the process started.  A program without the kernel's counter reads
nothing."""


def read(ctx):
    from qkan_implementation_tpu_torch.anneal.sa import (
        simulated_annealing,
        solve_qubo,
    )

    asked = getattr(solve_qubo, "sweeps", 0)
    ran = getattr(simulated_annealing, "kernel_sweeps", None)
    if not asked or ran is None:
        return None
    return 100.0 * ran / asked
