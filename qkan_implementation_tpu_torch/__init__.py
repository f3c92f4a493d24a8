"""QKAN on PyTorch: the FixedKAN serving path for CUDA (Hopper, sm_90a).

A second package beside ``qkan_implementation_tpu`` (the JAX reference),
with the same module tree, so every module here has one named
counterpart there.  It imports torch and numpy only.

- ``ops``      -- Chebyshev transforms and the degree-wise fused layer
                  forward, a hand-written CUDA kernel (``csrc/``) with a
                  plain torch version for CPU tensors.
- ``models``   -- FixedKAN config, forward (``'xla'`` fold and
                  ``'fused_dw'`` kernel backends) and npz checkpoints in
                  the JAX package's format.
- ``serving``  -- bucketed batched predictor and a stdlib HTTP server.
- ``utils``    -- device selection and parameter conversion to and from
                  numpy.

Structure search, training, the quantum runtime and the multi-device code
are not ported yet (ROADMAP.md, queues 1 and 2).
"""

__version__ = "0.1.0"
