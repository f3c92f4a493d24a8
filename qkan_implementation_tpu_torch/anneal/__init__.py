"""QUBO construction + batched simulated annealing on torch.

Counterpart of ``qkan_implementation_tpu.anneal``, with its export list:
the QUBO builders are numpy copies, the annealers run on the card (or on
the CPU when asked), and the mesh samplers on the slots of a
``parallel.Mesh`` axis.
"""

from qkan_implementation_tpu_torch.anneal.qubo import (
    QuboModel,
    degree_selection_qubo,
    qubo_energy,
    decode_degrees,
)
from qkan_implementation_tpu_torch.anneal.sa import (
    greedy_descent,
    parallel_tempering,
    parallel_tempering_mesh_ladder,
    parallel_tempering_sharded,
    simulated_annealing,
    simulated_annealing_sharded,
    default_beta_range,
    default_tempering_beta_range,
    polish_one_hot_blocks,
    solve_qubo,
)
from qkan_implementation_tpu_torch.anneal.expr import (
    Array,
    Binary,
    Constraint,
    QuboExpr,
)

__all__ = [
    "QuboModel",
    "degree_selection_qubo",
    "qubo_energy",
    "decode_degrees",
    "greedy_descent",
    "parallel_tempering",
    "parallel_tempering_mesh_ladder",
    "parallel_tempering_sharded",
    "simulated_annealing",
    "simulated_annealing_sharded",
    "default_beta_range",
    "default_tempering_beta_range",
    "polish_one_hot_blocks",
    "solve_qubo",
    "Array",
    "Binary",
    "Constraint",
    "QuboExpr",
]
