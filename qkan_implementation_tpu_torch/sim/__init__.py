"""Statevector / unitary circuit engine, on torch.

Counterpart of ``qkan_implementation_tpu.sim``: circuits as data (a gate
IR), simulation as torch ops over flat (optionally batched) statevectors,
the unitary as a batch of identity columns, and hand-written CUDA kernels
for the streaming gates (``sim.pallas_kernels``).  The mesh-sharded
statevector is not ported yet (``sharded_simulate`` raises).
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


def sharded_simulate(*args, **kwargs):
    """The JAX package's mesh-sharded statevector engine (``sim.sharded``):
    not ported yet, ROADMAP.md Queue 1 item 10 (the multi-device slice)."""
    raise NotImplementedError(
        "sharded_simulate is not ported to the torch package yet "
        "(ROADMAP.md Queue 1 item 10, the multi-device slice)"
    )


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
