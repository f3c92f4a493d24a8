"""QKAN on PyTorch: the FixedKAN serving and training paths for CUDA
(Hopper, sm_90a).

A second package beside ``qkan_implementation_tpu`` (the JAX reference),
with the same module tree, so every module here has one named
counterpart there.  It imports torch and numpy only.

- ``ops``      -- Chebyshev transforms and the fused layer in both
                  schedules, forward and backward as hand-written CUDA
                  kernels (``csrc/``) with plain torch versions for CPU
                  tensors.
- ``models``   -- FixedKAN config, forward (``'xla'`` fold and the
                  ``'fused'`` / ``'fused_dw'`` kernel backends), gradient
                  training and npz checkpoints in the JAX package's
                  format.
- ``serving``  -- bucketed batched predictor and a stdlib HTTP server.
- ``utils``    -- device selection and parameter conversion to and from
                  numpy.

Structure search, the quantum runtime and the multi-device code are not
ported yet (ROADMAP.md, queues 1 and 2).
"""

__version__ = "0.1.0"
