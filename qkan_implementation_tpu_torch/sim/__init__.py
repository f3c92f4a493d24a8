"""Statevector / unitary circuit engine, on torch.

Counterpart of ``qkan_implementation_tpu.sim``: circuits as data (a gate
IR), simulation as torch ops over flat (optionally batched) statevectors,
the unitary as a batch of identity columns, and hand-written CUDA kernels
for the streaming gates (``sim.pallas_kernels``), and the mesh-sharded
statevector (``sim.sharded``) with its fused exchange kernel
(``sim.rdma``).
"""

from qkan_implementation_tpu_torch.sim.circuit import Circuit, Gate
from qkan_implementation_tpu_torch.sim.statevector import (
    simulate,
    unitary,
    apply_gate,
    zero_state,
)
from qkan_implementation_tpu_torch.sim.measure import (
    probabilities,
    sample_counts,
    expectation_diagonal,
    marginal_probabilities,
)
from qkan_implementation_tpu_torch.sim.sharded import sharded_simulate


__all__ = [
    "Circuit",
    "Gate",
    "simulate",
    "unitary",
    "apply_gate",
    "zero_state",
    "probabilities",
    "sample_counts",
    "expectation_diagonal",
    "marginal_probabilities",
    "sharded_simulate",
]
