"""QKAN on PyTorch: FixedKAN structure search, training and serving, the
flagship digits experiment and the quantum runtime, for CUDA (Hopper,
sm_90a).

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
                  (single-controller, as the JAX package's ``shard_map``),
                  tensor- and pipeline-parallel FixedKAN (``tp``, ``pp``).
- ``anneal``   -- the degree-selection QUBO and symbolic QUBO
                  expressions (numpy), and the batched annealers on
                  torch, on one device or split over a mesh axis.
- ``models``   -- FixedKAN config, structure search (``optimize``: the
                  Gram / QR / SVD degree sweeps and the annealer), forward
                  (``'xla'`` fold with its int8 serving recipes and the
                  ``'fused'`` / ``'fused_dw'`` kernel backends), gradient
                  training (``mesh=`` for dp and tp), network analysis
                  and npz checkpoints in the JAX package's format; the MLP
                  baseline; the QSVT neuron.
- ``serving``  -- bucketed batched predictor and a stdlib HTTP server.
- ``data``, ``experiments``, ``analysis`` -- the market columns and
                  their pipeline, the digits corpus and its loaders; the
                  config-driven market harness (``run_experiment``: the
                  degree optimizer, the MLP baseline and FixedKAN) and the
                  flagship digits experiment (``run_mnist_experiment``);
                  saved-model statistics, the digits sampling diagnostics
                  and dataset sparsity metrics.
- ``optim``    -- ``DegreeOptimizer``: the per-edge degree search of one
                  QKAN layer (Gram statistics on the card, the QUBO, the
                  annealer) and its prediction.
- ``native_bindings`` -- the C++ annealer and circuit helpers
                  (``native/``) through ctypes.
- ``utils``    -- device selection, parameter conversion to and from
                  numpy, metrics, JSONL run records, checkpoints and
                  profiling.
- ``dryrun``   -- ``entry()`` and ``dryrun_multichip(n)``, the
                  counterparts of the repository root's
                  ``__graft_entry__.py``.

Every public name of the JAX package has its counterpart here, apart from
the TPU tile constants (``TILE_B``, ``TILE``, ``LANES``, ``SUBLANES``,
``BLOCK_ROWS``, ``CHUNK_ROWS``, ``INTERPRET_MAX_BLOCK``) and the two XLA
settings of ``utils.platform`` (its docstring says why).
"""

__version__ = "0.1.0"
