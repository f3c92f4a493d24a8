"""QKAN on PyTorch: the FixedKAN serving and training paths and the
quantum runtime, for CUDA (Hopper, sm_90a).

A second package beside ``qkan_implementation_tpu`` (the JAX reference),
with the same module tree, so every module here has one named
counterpart there.  It imports torch and numpy only.

- ``ops``      -- Chebyshev transforms, the QKAN step pipeline
                  (``qkan_layer``), the quantum-mode layer computed through
                  the simulator (``quantum``), and the fused layer in both
                  schedules, forward and backward as hand-written CUDA
                  kernels (``csrc/``) with plain torch versions for CPU
                  tensors.
- ``encoding`` -- FABLE block encodings as gate-IR circuits (numpy).
- ``sim``      -- the statevector engine: gate IR, simulation, register
                  and ladder fusion, measurement, and the streaming gate
                  kernels (``sim.pallas_kernels``, ``csrc/statevector.cu``);
                  the mesh-sharded engine (``sim.sharded``) with its fused
                  exchange kernel (``sim.rdma``, ``csrc/exchange.cu``).
- ``parallel`` -- a mesh of device slots and the collectives over them
                  (single-controller, as the JAX package's ``shard_map``).
- ``models``   -- FixedKAN config, forward (``'xla'`` fold and the
                  ``'fused'`` / ``'fused_dw'`` kernel backends), gradient
                  training and npz checkpoints in the JAX package's
                  format; the QSVT neuron.
- ``serving``  -- bucketed batched predictor and a stdlib HTTP server.
- ``utils``    -- device selection and parameter conversion to and from
                  numpy.

Structure search and tensor- and pipeline-parallel FixedKAN are not
ported yet (ROADMAP.md, queue 1).
"""

__version__ = "0.1.0"
