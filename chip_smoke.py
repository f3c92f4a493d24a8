"""Smoke run of the torch port's FixedKAN serving and training paths, its
quantum runtime, the fused train step and QKANLayer training on it, the
batched QKAN layer over M3, the mesh-sharded statevector, structure
search with the flagship digits experiment from raw data, int8 serving,
the market-data harness, and the multi-device paths with the diagnostics,
on one CUDA card.

    python3 chip_smoke.py

Phases, each reported on its own lines:

1. device: resolve ``cuda`` (raises without a card), print the card's
   name and power limit, turn TF32 off for matmuls and cuDNN;
2. build: compile the package's CUDA kernels from ``csrc/`` with nvcc
   (one process per source, started together) and report ptxas's
   registers and spills;
3. kernel vs plain: the degree-wise forward kernel (K1) against its plain
   torch version on the card, at the flagship layer shapes; then (3b) K1
   ('high' and 'bf16') and the v1 forward K3 on a bf16 x at every (in, T)
   of LAYER_SHAPES and B 64 and 4096, twice with the same bits, with the
   route (tensor cores or CUDA cores) and feature splits of each;
4. times: K1 and plain, median of CUDA-event-timed calls at B=4096;
5. the serving slice: a flagship-width [784,32,16,16,10] checkpoint with
   random weights is loaded, put behind ``BatchedPredictor`` and the HTTP
   server, and every answer is held against the FP32 ``'xla'`` backend on
   the card; K1's launch count must equal 4 layers x forwards;
6. backward kernels vs plain: the degree-wise (K2) and v1 (K4) backward
   kernels and the v1 forward (K3) against their plain versions at
   B in {1, 37, 64, 4096}, in in {784, 10}, every precision, tanh on and
   off, f32 and bf16 x, with bf16 controls, and the dW pass over each real
   workspace equal bit for bit to its plain version in its own order
   (``fused_bwd_fixed_order_reference``), each K2/K4 line with its route
   (tensor cores or CUDA cores) and feature chunk (``fused_bwd_plan``);
   (6d) K2 and K4 ('high', f32 x) at every (in, T) of LAYER_SHAPES and B
   64 and 4096 against their plain versions, twice with the same bits,
   with their route and chunk, and the first 37 rows' dx bit-equal at B
   37, 64 and 4096; (6c) widths past one launch
   (K1-K5 at x[256, 64], dp1 34, T 96; K12-K14 at D+1 8 / N 64 / K 128
   and at D+1 40) against their plain versions, twice with the same bits;
   then (6b) every fused-layer kernel's event ms, device µs, plain ms and
   bound (FP32, and 3xTF32 where it runs on the tensor cores: the
   forwards by ``fused_fwd_plan``, the backwards by ``fused_bwd_plan``,
   with the route and chunk printed) at every
   (in, T) of LAYER_SHAPES and B 64 and 4096, and the dW pass at layer
   0, B = 4096 (26 partials) and 64 (2), held bit for bit to that plain
   version twice, then timed: event ms, device µs, plain ms and bound
   beside ``torch.sum(part, dim=0)``'s event ms and device µs;
7. the training slice, at the flagship width from one random start on
   synthetic data (4096 rows, labels from a linear teacher), with
   backend 'fused_dw', 'fused' and 'xla' (FP32):
   a. the gradients of the loss at the start, on 64 and on 4096 rows,
      through each fused backend against 'xla': 1e-4 of each leaf's max;
   b. a 4-step run (2 epochs of 2 batches of 64): per-epoch losses within
      rtol 1e-4 of 'xla', final coefficients within 1e-4 of max|coef|;
   c. the 128-step run (2 epochs at batch 64, the 'recommended' train
      preset): the loss must fall, each fused kernel must launch 4 x 128
      times forward and backward, and each trained model serves one
      4096-row request that matches its FP32 fold.  This run is chaotic:
      FP32 rounding alone moves it by far more than 1e-4 within 16 steps,
      so the 1e-4 bars of the JAX package's trajectory test are held in
      a and b.  Here each fused run is held to the FP32 floor measured in
      the same call, 'xla' in float64 against 'xla' in float32: its
      per-epoch loss gap and its max-scaled coefficient gap to 'xla' must
      each stay within FLOOR_FACTOR times the floor's, and the per-step
      gaps are printed beside the floor's.

8. device time: ``torch.profiler`` over each kernel at the flagship
   checkpoint's shapes (the kernel's own time, without the wrapper's host time that
   the CUDA-event times of phases 4 and 6 carry) and over 10 train steps
   per backend at batch 64 (device busy share, time by kernel).
9. statevector kernels vs plain: K6 (through ``ucry_msb_cs_pallas_pair``
   and ``ucry_msb_cs_pallas``, K7's entry), K8, K9 and K10 against their
   plain torch versions on the card at q in {5, 11, 21}, batch 1 and 8,
   shared and per-row angles, float32 and float64, and at the shapes the
   main paths of phase 10 give them: 17 qubits at batch 256 and 8 with
   per-row angles (the quantum layer, 10a-c) and 11 qubits at batch 4
   with shared angles (the dense FABLE columns, 10d); K10 on every qubit
   of an 11-qubit state; the K6 and K8 VJPs against autograd through the
   plain versions.  Bars 1e-6 max|plain| (f32), 1e-13 max|plain| (f64).
10. the quantum slice at full width:
   a. ``qkan_layer_forward_quantum_batched`` at N = K = 16, degree 7
      (17-qubit packed circuits), B = 256, f32 and f64, against the
      classical ``qkan_layer_forward_batched`` on the card: 1e-4 (f32)
      and 1e-8 (f64) absolute; K8 launches once a forward;
   b. the weights' gradient of the mean-squared loss at B = 8 against the
      classical gradient, f64: 1e-6 absolute;
   c. the training run of ``examples/quantum_training_demo.py``: 60 Adam
      steps at lr 0.05, weights clipped to [-1, 1], B = 8, f32; the loss
      must fall below a tenth of its start, and K8 must launch 60 times;
   d. block encoding at scale, as ``examples/block_encoding_at_scale.py``:
      ``fable_runtime_params`` of a random 2^13 diagonal, one column
      through ``simulate_fable_runtime`` (27 qubits, a 512 MB f32 state,
      K6), within 5e-4 max(1, alpha); and ``simulate(fable(a))`` on a dense
      random 32 x 32 matrix, its first columns against a / (alpha 32);
   e. ``simulate_fable_pallas`` on a dense random 1024 x 1024 matrix (21
      qubits; K8 once, K10 on each of the 20 H gates), column 0 within
      5e-4 max(1, alpha) and the whole state within 1e-5 of the unfused
      ``simulate(backend='xla')``;
   f. ``diag_mult_pallas`` on that 21-qubit state (K9).
11. statevector kernel times at 21 qubits (an 8 MB f32 state: it sits in
   the 50 MB L2) and 27 qubits (512 MB: HBM), f32, and K8 where 63 of its
   64 main-path launches run (17 qubits, per-row angles, B 256 and 8):
   CUDA-event ms, device
   µs from ``torch.profiler`` and the plain version's ms, from one case
   table per size, each kernel first held to its plain version on the
   same state (the phase 9 bars; 27 qubits is the block encoding's K6
   shape); the bound is the bytes over 3.35 TB/s (K6 12, K8 10, K9 12,
   K10 8 bytes an amplitude).  K9's one PyTorch call is ``torch.mul``,
   K10's is ``torch.matmul`` of the 2x2 Hadamard with the
   [outer, 2, inner] view, each called in turns with the kernel: event
   ms, host µs a call (from the call to its return, on an idle card) and
   device µs beside the kernel's; no single PyTorch call computes a
   multiplexed rotation, so ``library_ms`` is null for K6/K7 and K8.
   Then one call of each quantum path (the layer forward at B = 256, a
   train step at B = 8, the 27-qubit block encoding, the 21-qubit
   gate-by-gate simulation) under ``torch.profiler``: device busy share
   and time by kernel.
12. the fused single-layer train step (K5, ``kan_train_step_fused``):
   a. K5 against its plain version on the card, twice on the same inputs
      (the same bits both times): the headline shape (x [262144, 16],
      dp1 8, T 16, no tanh, 'sumsq'; f32 and bf16 x: the tensor-core
      kernel), the flagship layer 0 (B 1, 64 and 4096, in 784, dp1 6, T
      10, tanh, 'mse' and 'sumsq': the CUDA-core kernel, by the rule of
      ``fused_step_tensor_cores``), layer 0 at T 32 (B 64 and 4096,
      'mse'), a ragged narrow case (B 37, in 10:
      tensor cores), a bf16 x at layer 0 and dp1 = 1.  dW within the
      BARS, the loss within rtol 1e-4;
   b. the headline QKAN-layer step at full width (N = K = 16, degree 7,
      B = 262144): the weights [8, 256] folded by ``weights_to_m3`` into
      w2 [128, 16], whose output must match ``qkan_layer_forward_batched``
      within 1e-5 max; the step's loss and dW against float64 autograd of
      sum((basis(x) @ w2)^2) (loss rtol 1e-4, dW 1e-4 max|dW|); then 20
      steps w2 <- w2 - 1e-7 dW with x rotating between the batch and its
      reverse (benchmarks/fused_retune_probe.py's chain), the final w2
      within 1e-4 max|w2| of the same steps with the float64 dW, and K5
      and the dW pass launched 20 times each;
   c. K5's event ms, device µs and plain ms beside its bound on the units
      it uses (``step_bound``: 3xTF32 on the tensor cores, or FP32) and
      the FP32 bound, and one step
      done by the K3 + K4 pair (``kan_layer_fused`` and its backward,
      ``sum(out**2)`` by torch) and one done as torch ops (autograd
      through ``qkan_layer_forward_batched``), at the headline shape and
      at layer 0 with B = 4096 and 'mse', T 10 and 32 (there the
      torch-ops step is autograd through ``kan_layer_fused_reference``);
      and the device
      time of each of the three by kernel, from ``torch.profiler`` over
      10 calls, K5's split into the step kernel, the dW pass and the loss
      sum; the dW pass over the headline step's workspace (256 partials,
      K5's own layout) as in phase 6;
   d. QKANLayer training at the benchmark cell qkan-layer-16x16-d7's
      shape (2^24 rows x uniform in [-1, 1)^16, y normal, batches of
      2^22, weights [8, 256] uniform in [-1, 1)): K5 at x [4194304, 16],
      dp1 8, T 16, 'mse', no tanh (264 persistent row blocks of 15,936
      rows, the last one ragged) against its plain version on the same
      inputs, twice with the same bits (dW within the BARS, the loss
      within rtol 1e-4); then one epoch of ``qkan_layer_train`` with the
      counts at 0: 4 steps, K5 and the dW pass launched 4 times each,
      the first step's loss and gradient the bits of the kernel's call
      above mapped through the trainer's unfold, every loss finite.
13. the batched QKAN layer over M3 (``experimental.pallas_layer``: K12
   forward, K13 backward with dx, K14 weight-only backward, the dM pass;
   K12, K13 and K14 on the tensor cores where ``m3_tc_plan`` takes the
   call, f32 x: ``csrc/qkan_layer_m3_tc.cu``; a bf16 x and the rest on
   the CUDA-core kernels, ``csrc/qkan_layer_m3.cu``):
   a. each kernel against its plain version on the card, twice on the
      same inputs (the same bits both times), with the route each call
      takes: the headline shape (f32 and
      bf16 x), N 16 / K 128 / B 4096, the JAX tests' shapes (B 64 N 4 K 3
      deg 5, B 48 deg 6, B 100 N 3 K 2 deg 3), B 1 with dp1 1 and 2, a bf16
      x and x in [-2, 2] (no clip) at B 4096; phase 6's BARS; K13's dM
      partials equal to K14's bit for bit where both run on the tensor
      cores in the same block layout; K12's first 37 rows of out and
      K13's of dx bit-equal at B 37, 4096 and 262144 (the headline; 37
      and 4096 at N16 K128) (``tools/m3_vs_old.py --parent-csrc`` holds
      the f32 K12 / K14 and the bf16-x K12 / K13 / K14 to an earlier
      commit's bits);
   b. bench.py's headline chain in torch: N = K = 16, degree 7,
      B = 262144, w <- w - 1e-7 grad_w sum(qkan_layer_forward_batched_fused
      (x_i, w)^2) for 20 steps on the rotating pool; the start's loss and
      gradient and the final w against float64 autograd over the unclipped
      basis (1e-4), K12, K14 and the dM pass 20 times each, K13 never;
      then one fwd+bwd in x and w (K12, K13 and the dM pass once), dx and
      grad_w against float64 autograd;
   c. each kernel's event ms, device µs, plain ms and bound (on its
      route's units, the FP32 bound beside it; the route read from the
      profiler's kernel names and held to ``m3_tc_plan``) at the
      headline and at N 16 / K 128 / B 4096, and one step (from the
      weights, from an M3 leaf, and 13b's in both arguments, which runs
      K13) with its device time by kernel,
      beside phase 12c's K5 step, the K3 + K4 pair and torch ops; the dM
      pass at both shapes (256 and 16 partials) as in phase 6; one
      wrapper call of each producer with its pass, one library call each
      (K14 + dM, K13 + dM, K2 + dW, K5 + dW), held to the bits of the
      producer followed by the pass alone, its event ms beside theirs and
      its device µs by kernel.
14. the mesh-sharded statevector (``sim.sharded``) and the fused exchange
   K11 (``sim.rdma``, ``csrc/exchange.cu``) on a mesh of 8 slots on the
   one card (``make_mesh(8, devices=[cuda] * 8)``):
   a. K11 against its plain version, both gates, f32 and f64, every
      dev_bit in {0, 1, 2}, half blocks M in {1, 2^10, 2^20, 2^23}:
      forward, twice (the same bits), and the backward of sum(out^3)
      through its autograd Function against autograd through the plain
      version, at phase 9's bars;
   b. ``qkan_layer_forward_quantum_sharded`` at phase 10a's width (N = K
      = 16, degree 7: 17 qubits, q_local 14), each exchange_impl, f32
      and f64, forward and the gradient in x and w against the
      single-card ``qkan_layer_forward_quantum`` within 1e-4 / 1e-8
      absolute; K11 launches 24 on 'rdma' and none on the other routes;
      ``count_exchanges`` beside the run's exchange count (equal on the
      collective routes);
   c. the 2^13 diagonal of phase 10d through
      ``quantum_extract_diag_packed_sharded`` (27 qubits, 64 MB a slot),
      'rdma' and 'collective', within 5e-4 max(1, alpha) of the
      single-card ``quantum_extract_diag_packed``; the error against the
      diagonal itself, the gap between the routes, ``shard_memory_report``
      and each route's host ms, event ms and device µs by kernel;
   d. K11's event ms, device µs (8 launches) and plain ms at the 27-qubit
      shape beside its bound and the collective path for the same
      exchange and gate (``pairwise_exchange`` + K6 or K10).
15. structure search and the flagship experiment (``anneal/``,
   ``FixedKAN.optimize``, ``experiments.run_mnist_experiment``):
   a. the annealers on the card against exact answers: ``solve_qubo`` on
      the degree QUBO at 32 functions x 6 degrees, both objectives, 1000
      reads and 1000 sweeps, equal to the blockwise argmin (host ms,
      device ms and launches, counted by ``torch.profiler`` over the
      whole call); SA on the dense (delayed) and the
      block-diagonal (blocked) kernel, parallel tempering and the C++
      annealer through the port's binding at n = 12 and 16, the best
      energy equal to ``brute_force_native``'s within 1e-9 max(1, |E|);
      the delayed sweep's ms a sweep at n = 64 and 256; then S1, the
      block-diagonal sweep kernel (``anneal.sa.blocked_sweeps``,
      ``csrc/anneal_blocked.cu``), on one chunk of an anneal's sweeps at
      the search cells' shapes (block size 6 with 32, 16 and 10 blocks;
      4 with 79; 1000 reads, float32): its state and fields equal to the
      plain version's (``_blocked_sweeps``) on the same inputs bit for
      bit, one launch, spins flipped; its ms, the plain version's and the
      bound at 32 and 79 blocks; then S2, the one-hot polish, energies and
      pick on the card (``anneal.sa.polish_blocked``, the same source), on
      the degree QUBO's annealed state at the same shapes: every read's
      polished bits and the best sample equal to the host route's
      (``polish_one_hot_blocks``, ``QuboModel.energy``, ``np.argmin``),
      its energy within 1e-12 of numpy's and 1e-15 of the exact sum, of
      max(|E|, offset); one card call; its device µs, event ms, the host
      ms of the card's polish (S2 and the best read's copy) and of the
      numpy route, and the bytes bound;
   b. ``optimize`` of the recommended [784,32,16,16,10] config on 10k
      digits-784 rows, solver 'anneal' and 'exact': the degrees equal, the
      design matrix, its factor and the anneal state on the card, every
      sweep of the anneal run in S1, each
      layer's route, scores, solve and anneal ms; the scores within 1e-3
      of the same code on the CPU in float32 on the same layer inputs,
      and of it in float64 where float64 takes the same route (layer 0's
      float32 QR route and its ridge floor are not float64's Gram: that
      gap is logged);
   c. ``run_mnist_experiment`` with the recipe of
      ``benchmarks/mnist_shape_evidence.py`` (15 epochs on 'fused_dw'):
      test accuracy >= 0.85, K1 and K2 launched 4 a step;
   d. the saved npz served on 'fused_dw' through ``BatchedPredictor``:
      logits within phase 5's bar of the 'xla' fold in float64 (the gap
      to the FP32 fold is logged beside the FP32 fold's own), and the
      argmax accuracy equal to c's.
16. the int8 serving recipes (``ops.qkan_layer``, no kernel of ours:
   the products are ``torch._int_mm``):
   a. the card's int8 product equal to the exact float64 product of the
      same operands at the padding edges and the flagship's [B, 4704] @
      [4704, 32] and [B, 96] @ [96, 10], B in {1, 37, 4096}, each through
      one ``torch._int_mm`` call;
   b. 15c's model served through ``FixedKAN(compute_dtype=...)`` and
      ``BatchedPredictor`` for 'int8x2', 'int8x2w', 'int8' and the FP32
      fold: 'int8x2' test accuracy within 0.01 of the float model's;
      every recipe's within 0.01 of the same recipe on the host CPU, and
      each of its products replayed on the card equal to the CPU's bit
      for bit; 'int8' warns at fan-in 4704; the errors against the
      float64 fold in the JAX suite's order (int8x2 < int8x2w < int8);
      predict p50 at 1, 64 and 4096 rows;
17. the market harness (``data.pipeline``, ``optim.DegreeOptimizer``,
   ``models.mlp``, ``experiments.run_experiment``):
   a. ``benchmarks/market_bench.py``'s degree search at its record's size
      (hard profile, 250,000 rows x 79 features, seed 0, max_degree 3,
      1000 reads): the Gram statistics on the card, the 79 degrees JAX's
      (all 0), the val MSE a degree within 1e-6 of the JAX package's in
      float64, the best within 1e-6 of the record and its comp-R^2 within
      1e-7; seconds a stage and the anneal's launches; every sweep of
      the search in S1;
   b. ``run_experiment`` on ``config.yaml``'s models at its 100,000 rows
      plus a fixed_kan [79, 8, 1], cut in depth only (1 trial, 3 MLP
      epochs, 2 fixed_kan epochs; logged): finite results, the qkan
      result equal to a direct fit, the MLP's val MSE falling, the CSV
      and the JSONL written; one float64 MLP epoch on 8192 rows on the
      card within 1e-8 of the same epoch on the host CPU; the MLP's ms a
      step and device busy share.
18. the multi-device paths, single-controller over slots of the card
   (``parallel.Mesh``; no kernel of their own), on 15c's trained
   flagship and its 10,000 rows, each held to the same work on one slot:
   a. ``kan_apply_tp`` at 4096 rows on a 1-D tp mesh of 8 slots (layer 0
      sharded, 98 features a slot) and on (dp 4, tp 2) (every layer
      sharded, the psum-scatters chained): float64 within 1e-10 of
      max|y| of ``kan_apply``, float32 within 10x the FP32 fold's own gap
      to float64 of the FP32 fold (the trained layer 0's sums cancel, as
      in 15d; phase 5's 1e-4 is logged); each tp slot's layer-0 shard
      holds 1/n_tp of the layer's bytes; host ms a forward;
   b. 20 ``make_tp_train_step`` steps at batch 64 on (dp 4, tp 2) in
      float64, each step's loss within 1e-12 max(1, |loss|) and its
      parameters within 1e-10 max(1, max|p|) of the same SGD step on one
      slot from the same parameters (the free-running drift is logged);
      ms a step;
   c. ``FixedKAN.train(mesh=)`` on dp8 and (dp 2, tp 4), one epoch at
      batch 64 on 4096 rows (the recommended preset): float64 losses and
      coefficients within 1e-9 of max|.| of the one-slot run; float32
      within 10x the one-slot float32-vs-float64 gap (phase 7's rule; the
      JAX test's bars are logged); ``backend='fused_dw'`` with a mesh
      raises; ms a step beside phase 7's; the (dp 2, tp 4) busy share;
   d. the three mesh samplers on a 32 x 6 block QUBO (sweeps cut to 40)
      at its exact optimum with R' rows; ``optimize(mesh=)`` of the
      flagship in float32 ('exact', and 'anneal' at 10 sweeps): the
      one-slot search's degrees, coefficients within rtol 5e-2 / atol
      2e-2 and forwards within 5e-3 (the JAX test's bars), the route and
      the slots of each layer's sweep, s a layer;
   e. ``kan_apply_pp`` and two ``make_pp_train_step`` steps (the lead
      layer and 3 one-layer stages, 4 microbatches of 16 rows) on 3 slots
      and on (dp 2, pp 3) in float64, at 18b's bars; ms a step;
   f. ``analyze_network`` (its output within 1e-10 of ``kan_apply`` in
      float64), ``extract_degrees_from_checkpoint`` on 15c's npz,
      ``compute_sparsity`` of a ``generate_market_parquet`` file against
      the columns' own null count, a ``save_pytree`` / ``load_pytree``
      round trip of 18b's per-slot parameters bit for bit,
      ``statevector_native`` (host C++) within 1e-12 of ``sim.simulate``
      on the card for a 17-qubit FABLE circuit (a main path: the kernels
      it launches are named), and ``dryrun_multichip(8)`` on 8 slots.

The counts of kernel launches are set to 0 just before each main path
(the serving slice, each training run, each trained model's request,
each path of phase 10, the headline step, the M3 chain and its
both-arguments step, each path of 14b and 14c, 15b's structure search,
the flagship experiment and its served model, each int8 recipe's
serving, 17a's degree search, the market harness and 18f's FABLE
simulation) and read just after;
launches made to compare
kernels with their plain versions are not counted.  The last line is
``{"ok": true, "device": {...}}``; the line before it is the kernels'
JSON record, and the lines before that the multi-device phase's, the
market harness's, int8 serving's and structure search's (JSON), the sharded paths', the one-call
backwards', the M3 layer's and the headline step's times (JSON), the
quantum slice's and the train step's.  Any
failed check raises and the script exits non-zero without those lines.

Bounds (``bound_ms``): the larger of the bytes the function must move
(each input read once, each output written once) over 3.35 TB/s and its
FP32 operations over 67 TFLOP/s (H100 SXM data sheet, at 700 W); a
kernel on the tensor cores (K1-K4 where their plans send a shape there,
K5's tensor-core step, K12-K14 by ``m3_tc_plan``) counts its flops as
three TF32 passes over 495 TFLOP/s, with the FP32 bound beside it.
Operations count the contractions' multiply-adds, 2 per FMA, and one per
add of the partial sums; the elementwise recurrences are left out (under
10% of the FMAs at dp1 = 6).  No single PyTorch call computes tanh ->
Chebyshev -> contraction, its gradient or the train step, so
``library_ms`` is null for those (K12-K14 too); for the partial-sum
passes (one kernel, ``csrc/partial_sum.cu``) it is ``torch.sum`` over the
row blocks.
"""

from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.request
import warnings
from dataclasses import asdict
from pathlib import Path

import numpy as np
import torch

from qkan_implementation_tpu_torch.analysis import (
    compute_model_stats,
    compute_sparsity,
    extract_degrees_from_checkpoint,
)
from qkan_implementation_tpu_torch.anneal import (
    QuboModel,
    degree_selection_qubo,
    parallel_tempering,
    parallel_tempering_mesh_ladder,
    parallel_tempering_sharded,
    simulated_annealing,
    simulated_annealing_sharded,
    solve_qubo,
)
from qkan_implementation_tpu_torch.anneal import sa as anneal_sa
from qkan_implementation_tpu_torch.data import load_digits_784, to_one_hot
from qkan_implementation_tpu_torch.data.pipeline import (
    DataPipeline,
    generate_market_parquet,
    market_columns,
)
from qkan_implementation_tpu_torch.experiments import (
    run_experiment,
    run_mnist_experiment,
)
from qkan_implementation_tpu_torch.experiments import main as harness_main
from qkan_implementation_tpu_torch.experiments.config import (
    DataConfig,
    get_default_features,
    load_config,
)
from qkan_implementation_tpu_torch.models import FixedKAN, FixedKANConfig
from qkan_implementation_tpu_torch.models import fixed_kan as fk_mod
from qkan_implementation_tpu_torch.models.qkan_layer import (
    QKANLayerTrainer,
    qkan_layer_train,
)
from qkan_implementation_tpu_torch.models.mlp import (
    MLPConfig,
    init_mlp,
    train_mlp,
)
from qkan_implementation_tpu_torch.optim import degree_optimizer as dopt
from qkan_implementation_tpu_torch.optim.degree_optimizer import (
    DegreeOptimizer,
)
from qkan_implementation_tpu_torch.utils.metrics import compute_metrics
from qkan_implementation_tpu_torch.models.fixed_kan import (
    kan_apply,
    kan_layer_apply,
)
from qkan_implementation_tpu_torch.native_bindings import (
    anneal_native,
    brute_force_native,
    statevector_native,
)
from qkan_implementation_tpu_torch.dryrun import dryrun_multichip
from qkan_implementation_tpu_torch.experimental import pallas_layer as pl3
from qkan_implementation_tpu_torch.ops import fused_layer as fl
from qkan_implementation_tpu_torch.experimental.pallas_layer import (
    qkan_layer_forward_batched_fused,
    qkan_layer_fused,
    qkan_layer_fused_bwd_reference,
    qkan_layer_fused_reference,
    weights_to_m3,
)
from qkan_implementation_tpu_torch.ops import _cuda_build
from qkan_implementation_tpu_torch.ops.chebyshev import chebyshev_basis
from qkan_implementation_tpu_torch.ops.fused_layer import (
    _bwd_pass,
    _fused_bwd,
    _fused_dw_bwd,
    _step_pass,
    fixed_order_sum_reference,
    fused_bwd_fixed_order_reference,
    fused_bwd_partial_sum,
    fused_bwd_partial_sum_reference,
    fused_bwd_workspace_partials,
    kan_layer_fused,
    kan_layer_fused_bwd_reference,
    kan_layer_fused_dw,
    kan_layer_fused_dw_bwd_reference,
    kan_layer_fused_dw_reference,
    kan_layer_fused_reference,
    kan_train_step_fused,
    kan_train_step_fused_reference,
    partial_sum_segments,
)
from qkan_implementation_tpu_torch.encoding import fable, fable_runtime_params
from qkan_implementation_tpu_torch.ops.qkan_layer import (
    int8_matmul,
    qkan_layer_forward_batched,
)
from qkan_implementation_tpu_torch.ops.quantum import (
    qkan_layer_forward_quantum_batched,
)
from qkan_implementation_tpu_torch.parallel import (
    Mesh,
    gather_shards,
    kan_apply_pp,
    kan_apply_tp,
    make_mesh,
    make_pp_train_step,
    make_tp_train_step,
    place_pipeline_params,
    shard_params,
)
from qkan_implementation_tpu_torch.parallel import tp as tp_mod
from qkan_implementation_tpu_torch.parallel.mesh import tree_tensors
from qkan_implementation_tpu_torch.serving import BatchedPredictor, serve
from qkan_implementation_tpu_torch.sim import pallas_kernels as pk
from qkan_implementation_tpu_torch.sim import rdma
from qkan_implementation_tpu_torch.sim import simulate
from qkan_implementation_tpu_torch.sim.fusion import simulate_fable_runtime
from qkan_implementation_tpu_torch.sim.sharded import (
    count_exchanges,
    shard_memory_report,
    sharded_simulate,
)
from qkan_implementation_tpu_torch.utils.checkpoint import (
    load_pytree,
    save_pytree,
)
from qkan_implementation_tpu_torch.utils.platform import resolve_device

SEED = 0
SHAPE = [784, 32, 16, 16, 10]
MAX_DEGREE = 5
DP1 = MAX_DEGREE + 1
T = SHAPE[-1]
# kernel vs plain bars: max|kernel - plain| <= rel * max|plain| + abs.
# 'high': FP32 on both sides, only the summation order differs.  'bf16':
# both round T_d and W_d to bf16 at the same points, so only the order of
# the f32 sums differs too (the card measured <= 1.2e-6 absolute).  The
# bar leaves room for a tanh one f32 ulp apart that flips a bf16 rounding.
# Control: on the same bf16 x, the 'bf16' output must differ from the
# 'high' output by more than the bar, so a kernel that ignores the mode's
# rounding fails.
BARS = {"high": (1e-4, 1e-5), "default": (1e-4, 1e-5),
        "bf16": (1e-4, 1e-5)}
SLICE_RTOL = 1e-4
# the fused training runs against 'xla' (FP32): the bars of the JAX
# package's test_train_fused_f32_tracks_xla_trajectory
TRAIN_RTOL = 1e-4
# the 128-step runs against 'xla' (FP32), as multiples of the same gap
# between 'xla' in float32 and in float64 from the same start: the card
# read fused/floor ratios of 0.55-0.68 (losses) and 0.84-1.02
# (coefficients)
FLOOR_FACTOR = 10.0
TRAIN_BATCH, TRAIN_EPOCHS, TRAIN_ROWS = 64, 2, 4096
SHORT_ROWS = 2 * TRAIN_BATCH  # phase 7b: 2 epochs of 2 steps
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12  # the tensor cores, dense
# (in, T) of the fused-layer kernels' checked and timed shapes (phases 3b,
# 6b, 8), each at B 64 and 4096: the flagship checkpoint's own layers (a
# FixedKAN layer maps [B, in] to [B, target_dim]: 784 -> 10, then 10 ->
# 10), and the four layers of a [784, 32, 16, 16, 10] whose layers map to
# the next width
LAYER_SHAPES = [(784, 10), (10, 10), (784, 32), (32, 16), (16, 16), (16, 10)]
LAYER_BATCHES = (64, 4096)
# widths past one launch (phase 6c): x[256, 64] at dp1 34, T 96 for K1-K5;
# the M3 layer at D+1 8 / N 64 / K 128 and at D+1 40 (N 16, K 16)
WIDE_LAYER = (256, 64, 34, 96)
WIDE_M3 = [(512, 64, 128, 8), (512, 16, 16, 40)]

# (name in the kernels line, counter owner, counter attribute)
COUNTERS = [
    ("fused_dw_fwd", kan_layer_fused_dw, "launches"),
    ("fused_dw_bwd", kan_layer_fused_dw, "bwd_launches"),
    ("fused_fwd", kan_layer_fused, "launches"),
    ("fused_bwd", kan_layer_fused, "bwd_launches"),
    ("fused_bwd_partial_sum", fused_bwd_partial_sum, "launches"),
    ("fused_step", kan_train_step_fused, "launches"),
    ("ucry_cs_pair", pk.ucry_msb_cs_pallas_pair, "launches"),
    ("ucry_cs_pair_bwd", pk.ucry_msb_cs_pallas_pair, "bwd_launches"),
    ("ucry_cs", pk.ucry_msb_cs_pallas, "launches"),
    ("ucry_cs_bwd", pk.ucry_msb_cs_pallas, "bwd_launches"),
    ("ucry", pk.ucry_msb_pallas, "launches"),
    ("ucry_bwd", pk.ucry_msb_pallas, "bwd_launches"),
    ("diag_mult", pk.diag_mult_pallas, "launches"),
    ("h_pair", pk.h_gate_pallas, "launches"),
    ("m3_fwd", qkan_layer_fused, "launches"),
    ("m3_bwd", qkan_layer_fused, "bwd_launches"),
    ("m3_bwd_dw", qkan_layer_fused, "bwd_dw_launches"),
    ("m3_dm_sum", pl3.m3_dm_partial_sum, "launches"),
    ("exchange_ucry", rdma.ucry_exchange_fused_rdma, "launches"),
    ("exchange_h", rdma.h_exchange_fused_rdma, "launches"),
    ("anneal_blocked", anneal_sa.blocked_sweeps, "launches"),
    ("anneal_polish", anneal_sa.polish_one_hot_blocks, "card_calls"),
]


def reset_counts() -> None:
    for _, owner, attr in COUNTERS:
        setattr(owner, attr, 0)


def read_counts() -> dict:
    return {name: getattr(owner, attr) for name, owner, attr in COUNTERS}


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def paired_ms(a, b, reps: int = 30, warm: int = 5) -> tuple[float, float]:
    """Median CUDA-event ms of ``a`` and of ``b``, called in turns (a, b,
    b, a, ...), so drifts of the card or the host fall on both alike."""
    for _ in range(warm):
        a(), b()
    torch.cuda.synchronize()
    times = ([], [])
    for i in range(reps):
        for side in ((0, 1) if i % 2 == 0 else (1, 0)):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            (a, b)[side]()
            end.record()
            end.synchronize()
            times[side].append(start.elapsed_time(end))
    return float(np.median(times[0])), float(np.median(times[1]))


def paired_host_us(a, b, reps: int = 30) -> tuple[float, float]:
    """Median host µs of ``a`` and of ``b`` from the call to its return, on
    an idle card (synchronised before each), called in turns: what a
    host-bound loop pays a call."""
    torch.cuda.synchronize()
    times = ([], [])
    for i in range(reps):
        for side in ((0, 1) if i % 2 == 0 else (1, 0)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (a, b)[side]()
            times[side].append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return float(np.median(times[0])), float(np.median(times[1]))


def median_ms(fn, reps: int = 50, warm: int = 5) -> float:
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def layer_inputs(rng, b, n, tanh, precision, device, t_dim=T, dp1=DP1):
    lo, hi = (-2.0, 2.0) if tanh else (-0.95, 0.95)
    x = torch.from_numpy(rng.uniform(lo, hi, (b, n)).astype(np.float32))
    w2 = torch.from_numpy(
        rng.normal(0, 1 / np.sqrt(dp1 * n), (dp1 * n, t_dim))
        .astype(np.float32)
    )
    if precision == "bf16":
        x = x.to(torch.bfloat16)
    return x.to(device), w2.to(device)


def check_kernel(device) -> float:
    """Phase 3: worst |kernel - plain| per case; returns the worst 'high'
    error (the mode the main path runs)."""
    rng = np.random.default_rng(SEED)
    worst_high = 0.0
    for n in (784, 10):
        for b in (1, 37, 4096):
            for precision in ("high", "bf16"):
                for tanh in (True, False):
                    x, w2 = layer_inputs(rng, b, n, tanh, precision, device)
                    got = kan_layer_fused_dw(x, w2, DP1, tanh, precision)
                    want = kan_layer_fused_dw_reference(
                        x, w2, DP1, tanh, precision
                    )
                    torch.cuda.synchronize()
                    assert got.shape == (b, T) and got.dtype == torch.float32
                    assert bool(torch.isfinite(got).all()), "non-finite"
                    err = float((got - want).abs().max())
                    scale = float(want.abs().max())
                    rel, absl = BARS[precision]
                    bar = rel * scale + absl
                    log("kernel", shape=f"x[{b},{n}]@w2[{DP1 * n},{T}]",
                        precision=precision, tanh=tanh,
                        max_abs_err=f"{err:.3e}", bar=f"{bar:.3e}")
                    if not err <= bar:
                        raise AssertionError(
                            f"kernel disagrees with plain: {err} > {bar}"
                        )
                    if precision == "bf16":
                        high = kan_layer_fused_dw(x, w2, DP1, tanh, "high")
                        gap = float((got - high).abs().max())
                        log("kernel", control="bf16_vs_high_same_x",
                            gap=f"{gap:.3e}", must_exceed=f"{bar:.3e}")
                        if not gap > bar:
                            raise AssertionError(
                                f"'bf16' output within {gap} of 'high': "
                                "the kernel did not round to bf16"
                            )
                    if precision == "high":
                        worst_high = max(worst_high, err)
    return worst_high


def check_forward_shapes(device) -> float:
    """Phase 3b: K1 ('high' f32 x, 'bf16') and K3 (a bf16 x: all of w2
    rounded) against their plain versions at every (in, T) of
    LAYER_SHAPES and B in LAYER_BATCHES, twice with the same bits, the
    route and feature splits of each (``fused_fwd_plan``) logged; returns
    the worst 'high' error."""
    rng = np.random.default_rng(SEED + 19)
    worst = 0.0
    for n, t_dim in LAYER_SHAPES:
        for b in LAYER_BATCHES:
            x, w2 = layer_inputs(rng, b, n, True, "high", device, t_dim)
            xb = x.to(torch.bfloat16)
            tc, splits, _ = fl.fused_fwd_plan(b, n, DP1, t_dim)
            where = dict(shape=f"x[{b},{n}]@w2[{DP1 * n},{t_dim}]",
                         tensor_cores=tc, splits=splits)
            for name, call, ref, precision in (
                    ("fused_dw_fwd", lambda: kan_layer_fused_dw(x, w2, DP1),
                     lambda: kan_layer_fused_dw_reference(x, w2, DP1),
                     "high"),
                    ("fused_dw_fwd", lambda: kan_layer_fused_dw(
                        x, w2, DP1, True, "bf16"),
                     lambda: kan_layer_fused_dw_reference(
                         x, w2, DP1, True, "bf16"), "bf16"),
                    ("fused_fwd", lambda: kan_layer_fused(xb, w2, DP1),
                     lambda: kan_layer_fused_reference(xb, w2, DP1),
                     "high")):
                got, again = call(), call()
                torch.cuda.synchronize()
                if not torch.equal(got, again):
                    raise AssertionError(f"{name} {where}: two runs differ")
                err, _ = held(name, got, ref(), precision, **where,
                              x="bf16" if name == "fused_fwd" else "f32")
                if name == "fused_dw_fwd" and precision == "high":
                    worst = max(worst, err)
    return worst


def time_kernel(device, card: str) -> dict:
    """Phase 4: kernel and plain times at B=4096 for both layer shapes."""
    rng = np.random.default_rng(SEED + 1)
    times = {}
    for n in (784, 10):
        for precision in ("high", "bf16"):
            x, w2 = layer_inputs(rng, 4096, n, True, precision, device)
            args = (x, w2, DP1, True, precision)
            k_ms = median_ms(lambda: kan_layer_fused_dw(*args))
            p_ms = median_ms(lambda: kan_layer_fused_dw_reference(*args))
            times[(n, precision)] = (k_ms, p_ms)
            log("time", shape=f"x[4096,{n}]@w2[{DP1 * n},{T}]",
                precision=precision, kernel_ms=f"{k_ms:.4f}",
                plain_ms=f"{p_ms:.4f}", card=f"'{card}'")
    return times


def write_checkpoint(path: Path) -> None:
    """Flagship-width checkpoint in the JAX package's npz format, written
    with numpy: random degrees in 0..D, coefficients scaled so every
    layer's output stays O(1), horizontal weights near 1."""
    rng = np.random.default_rng(SEED + 2)
    cfg = FixedKANConfig.preset(
        "recommended", SHAPE, MAX_DEGREE, layer_backend="fused_dw"
    )
    arrays = {"config_json": np.frombuffer(
        json.dumps(asdict(cfg)).encode(), dtype=np.uint8
    )}
    in_dim = SHAPE[0]
    for i, out_dim in enumerate(SHAPE[1:]):
        sigma = 1.0 / np.sqrt(out_dim * in_dim * DP1 / 4)
        arrays[f"layer{i}/degrees"] = rng.integers(
            0, MAX_DEGREE + 1, out_dim
        ).astype(np.int32)
        arrays[f"layer{i}/coefficients"] = rng.normal(
            0, sigma, (out_dim, in_dim, DP1, T)
        ).astype(np.float32)
        arrays[f"layer{i}/horizontal_weights"] = rng.normal(
            1.0, 0.05, out_dim
        ).astype(np.float32)
        in_dim = T  # every layer maps to the target width
    np.savez(path, **arrays)


def post(url: str, body: bytes):
    req = urllib.request.Request(
        url, data=body, headers={"Content-Type": "application/json"}
    )
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def fwd_passes(rows: int) -> int:
    """Launches of the fixed-order pass that one flagship forward of
    ``rows`` rows makes: one a layer whose forward splits its features
    (``fused_fwd_plan``; the checkpoint's layers map 784 -> T, then T ->
    T)."""
    ins = [SHAPE[0]] + [T] * (len(SHAPE) - 2)
    return sum(fl.fused_fwd_plan(rows, n, DP1, T)[1] > 1 for n in ins)


def run_slice(device, workdir: Path) -> tuple[dict, dict]:
    """Phase 5: checkpoint -> FixedKAN -> BatchedPredictor -> HTTP."""
    path = workdir / "flagship_random.npz"
    write_checkpoint(path)
    model = FixedKAN.load_model(path, device=device)
    cfg = model.config

    def reference(x: np.ndarray, on) -> np.ndarray:
        """The same model through the FP32 'xla' backend ('high')."""
        params = [{k: v.to(on) for k, v in lp.items()} for lp in model.params]
        with torch.inference_mode():
            out = kan_apply(
                params, torch.from_numpy(x).to(on), cfg.max_degree,
                backend="xla", matmul_precision="high",
            )
        return out.cpu().numpy()

    def check(name: str, got: np.ndarray, x: np.ndarray) -> float:
        want = reference(x, device)
        if got.shape != want.shape or not np.all(np.isfinite(got)):
            raise AssertionError(f"{name}: bad output {got.shape}")
        rel = float(np.abs(got - want).max() / np.abs(want).max())
        log("slice", check=name, rows=x.shape[0], rel_err=f"{rel:.3e}",
            bar=SLICE_RTOL)
        if not rel <= SLICE_RTOL:
            raise AssertionError(f"{name}: {rel} > {SLICE_RTOL}")
        return rel

    rng = np.random.default_rng(SEED + 3)
    xs = {n: rng.random((n, SHAPE[0])).astype(np.float32)
          for n in (1, 64, 256, 4096)}
    # float64 on the host: a reference on another device and dtype
    cpu64 = reference(xs[64].astype(np.float64), "cpu")

    predictor = BatchedPredictor(model, max_batch=4096)
    steady = 50
    reset_counts()
    forwards = 0
    predictor.warmup()
    forwards += len(predictor.buckets)
    passes = sum(fwd_passes(b) for b in predictor.buckets)
    server, thread = serve(predictor, port=0, background=True)
    try:
        host, port = server.server_address
        base = f"http://{host}:{port}"
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        if health.get("status") != "ok":
            raise AssertionError(f"/healthz: {health}")
        answers = {}
        for n in (1, 64, 256):
            code, body = post(
                base + "/predict", json.dumps({"inputs": xs[n].tolist()}).encode()
            )
            forwards += 1
            passes += fwd_passes(predictor._bucket_for(n))
            if code != 200:
                raise AssertionError(f"/predict {n} rows: HTTP {code} {body}")
            answers[n] = np.asarray(body["outputs"], dtype=np.float32)
        code, _ = post(base + "/predict", b'{"inputs": [[1.0, 2.0]]}')
        if code != 400:
            raise AssertionError(f"malformed body: HTTP {code}, expected 400")
        answers[4096] = predictor.predict(xs[4096])
        forwards += 1
        for _ in range(steady):
            last = predictor.predict(xs[4096])
        forwards += steady
        passes += (1 + steady) * fwd_passes(4096)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    counts = read_counts()
    expected = dict.fromkeys(counts, 0)
    expected["fused_dw_fwd"] = (len(SHAPE) - 1) * forwards
    expected["fused_bwd_partial_sum"] = passes
    log("slice", forwards=forwards, launches=counts)
    if counts != expected:
        raise AssertionError(f"kernel launches {counts} != {expected}")

    for n, got in answers.items():
        check(f"predict_{n}", got, xs[n])
    check("predict_4096_steady", last, xs[4096])
    rel64 = float(np.abs(answers[64] - cpu64).max() / np.abs(cpu64).max())
    log("slice", check="predict_64_vs_cpu_float64", rel_err=f"{rel64:.3e}",
        bar=SLICE_RTOL)
    if not rel64 <= SLICE_RTOL:
        raise AssertionError(f"64 rows vs CPU float64: {rel64}")
    stats = predictor.stats()
    log("slice", requests=stats["requests"],
        latency_p50_ms=f"{stats['latency_p50_ms']:.4f}",
        latency_p99_ms=f"{stats['latency_p99_ms']:.4f}",
        steady_rows=4096, steady_requests=steady)
    return counts, stats


def bf16_steps(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """How many bf16 steps apart two bf16 tensors are, element by element."""
    return (got.view(torch.int16).int() - want.view(torch.int16).int()).abs()


def held(name: str, got: torch.Tensor, want: torch.Tensor, precision: str,
         **where) -> tuple[float, float]:
    """Hold a kernel output to its plain version; returns (max abs error,
    error over bar).  A bf16 output (dx of a bf16 x) is the f32 sum
    rounded once more, so where the two sums straddle a rounding boundary
    it may sit one bf16 step (2^-8 of the value) from the plain one: such
    elements are allowed, at most 1 in 1000, and counted."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {got.shape}/{got.dtype} vs "
                             f"{want.shape}/{want.dtype}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite output")
    err = (got.float() - want.float()).abs()
    rel, absl = BARS[precision]
    bar = rel * float(want.float().abs().max()) + absl
    over = err > bar
    flips = 0
    if got.dtype == torch.bfloat16 and bool(over.any()):
        if not bool((bf16_steps(got, want)[over] == 1).all()):
            raise AssertionError(f"{name} {where}: more than one bf16 step")
        flips = int(over.sum())
        if flips > max(1, over.numel() // 1000):
            raise AssertionError(f"{name} {where}: {flips} bf16 steps")
        err = err.masked_fill(over, 0.0)
    max_err = float(err.max()) if err.numel() else 0.0
    if not max_err <= bar:
        raise AssertionError(f"{name} {where}: {max_err} > {bar}")
    log("kernel", name=name, precision=precision, max_abs_err=f"{max_err:.3e}",
        bar=f"{bar:.3e}", bf16_steps=flips,
        **{k: v for k, v in where.items()})
    return max_err, max_err / bar


def check_backward(device) -> dict:
    """Phase 6a: K2, K4 and K3 against their plain versions; returns the
    worst 'high' (main path) error of each, over f32 inputs."""
    rng = np.random.default_rng(SEED + 5)
    worst = {"fused_dw_bwd": 0.0, "fused_bwd": 0.0, "fused_fwd": 0.0,
             "fused_bwd_partial_sum": 0.0}
    bwds = (
        ("fused_dw_bwd", _fused_dw_bwd, kan_layer_fused_dw_bwd_reference,
         ("high", "default", "bf16")),
        ("fused_bwd", _fused_bwd, kan_layer_fused_bwd_reference,
         ("high", "default")),
    )
    for n in (784, 10):
        for b in (1, 37, 64, 4096):
            for tanh in (True, False):
                for x_dtype in (torch.float32, torch.bfloat16):
                    x, w2 = layer_inputs(rng, b, n, tanh, "high", device)
                    x = x.to(x_dtype)
                    g = torch.from_numpy(
                        rng.normal(size=(b, T)).astype(np.float32)
                    ).to(device)
                    where = dict(shape=f"x[{b},{n}]", tanh=tanh,
                                 x=str(x_dtype).split(".")[-1])
                    for name, bwd, ref, precisions in bwds:
                        for precision in precisions:
                            dx, dw = bwd(x, w2, g, DP1, tanh, precision)
                            want_dx, want_dw = ref(x, w2, g, DP1, tanh,
                                                   precision)
                            torch.cuda.synchronize()
                            route = bwd_route(b, n, T, x_dtype, precision)
                            ex, _ = held(name + ".dx", dx, want_dx,
                                         precision, **where, **route)
                            ew, _ = held(name + ".dw", dw, want_dw,
                                         precision, **where, **route)
                            if precision == "high" and x_dtype == torch.float32:
                                worst[name] = max(worst[name], ex, ew)
                            if precision == "bf16":
                                _, dw_high = bwd(x, w2, g, DP1, tanh, "high")
                                torch.cuda.synchronize()
                                gap = float((dw - dw_high).abs().max())
                                bar = 1e-4 * float(want_dw.abs().max()) + 1e-5
                                log("kernel", control="bf16_vs_high_dw",
                                    gap=f"{gap:.3e}", must_exceed=f"{bar:.3e}",
                                    **where)
                                if not gap > bar:
                                    raise AssertionError(
                                        f"'bf16' dW within {gap} of 'high'"
                                    )
                    # K3: the v1 forward, with phase 3's checks
                    got = kan_layer_fused(x, w2, DP1, tanh)
                    want = kan_layer_fused_reference(x, w2, DP1, tanh)
                    torch.cuda.synchronize()
                    e3, _ = held("fused_fwd", got, want, "high", **where)
                    if x_dtype == torch.float32:
                        worst["fused_fwd"] = max(worst["fused_fwd"], e3)
                    else:
                        k1 = kan_layer_fused_dw(x, w2, DP1, tanh, "high")
                        torch.cuda.synchronize()
                        gap = float((got - k1).abs().max())
                        bar = 1e-4 * float(want.abs().max()) + 1e-5
                        log("kernel", control="v1_bf16_x_vs_dw_high",
                            gap=f"{gap:.3e}", must_exceed=f"{bar:.3e}",
                            **where)
                        if not gap > bar:
                            raise AssertionError(
                                f"v1 forward within {gap} of K1 'high' on a "
                                "bf16 x: w2 was not rounded to bf16"
                            )
                    # the fixed-order pass over a real workspace: the
                    # bits of the plain sum in its order, twice
                    if x_dtype == torch.float32 and tanh:
                        ws = _bwd_pass("qkan_fused_dw_bwd", x, w2, g, DP1,
                                       tanh, (0,), True)[1]
                        got = fused_bwd_partial_sum(ws, b, n, DP1, T)
                        again = fused_bwd_partial_sum(ws, b, n, DP1, T)
                        want = fused_bwd_partial_sum_reference(ws, b, n,
                                                               DP1, T)
                        fixed = fused_bwd_fixed_order_reference(ws, b, n,
                                                                DP1, T)
                        torch.cuda.synchronize()
                        if not (torch.equal(got, fixed)
                                and torch.equal(got, again)):
                            raise AssertionError(
                                f"dW pass {where}: not the bits of the "
                                "fixed-order plain sum, or not twice")
                        e5, _ = held("fused_bwd_partial_sum", got, want,
                                     "high", **where)
                        worst["fused_bwd_partial_sum"] = max(
                            worst["fused_bwd_partial_sum"], e5
                        )
    return worst


def bwd_route(b: int, n: int, t_dim: int, x_dtype=torch.float32,
              precision: str = "high", dp1: int = DP1) -> dict:
    """The route K2/K4 take at these sizes (``fused_bwd_plan``): tensor
    cores or not, and the features a block takes (0 on the CUDA cores)."""
    tc, chunk, _, _, nrb = fl.fused_bwd_plan(
        b, n, dp1, t_dim, x_dtype == torch.bfloat16, precision == "bf16")
    return dict(tensor_cores=tc, chunk=chunk, row_blocks=nrb)


def check_backward_shapes(device) -> dict:
    """Phase 6d: K2 ('high') and K4, f32 x, tanh on, at every (in, T) of
    LAYER_SHAPES and B in LAYER_BATCHES: the route (which must be the
    tensor cores) and chunk logged, twice with the same bits, each held
    to its plain version; then the first 37 rows' dx of each at B 37, 64
    and 4096 (one set of inputs, cut): the same bits, since the chunk and
    the mma order are functions of (in, dp1, T).  Returns the worst error
    of each."""
    rng = np.random.default_rng(SEED + 21)
    worst = {"fused_dw_bwd": 0.0, "fused_bwd": 0.0}
    for n, t_dim in LAYER_SHAPES:
        x, w2 = layer_inputs(rng, max(LAYER_BATCHES), n, True, "high",
                             device, t_dim)
        g = torch.from_numpy(rng.normal(size=(x.shape[0], t_dim))
                             .astype(np.float32)).to(device)
        for name, bwd, ref in (
                ("fused_dw_bwd", _fused_dw_bwd,
                 kan_layer_fused_dw_bwd_reference),
                ("fused_bwd", _fused_bwd, kan_layer_fused_bwd_reference)):
            for b in LAYER_BATCHES:
                route = bwd_route(b, n, t_dim)
                where = dict(shape=f"x[{b},{n}] T {t_dim}", **route)
                if not route["tensor_cores"]:
                    raise AssertionError(f"{name} {where}: not on the "
                                         "tensor cores")
                xb, gb = x[:b], g[:b]
                got = bwd(xb, w2, gb, DP1, True, "high")
                again = bwd(xb, w2, gb, DP1, True, "high")
                torch.cuda.synchronize()
                if not all(torch.equal(a, c) for a, c in zip(got, again)):
                    raise AssertionError(f"{name} {where}: two runs differ")
                want = ref(xb, w2, gb, DP1, True, "high")
                for part, a, w in zip((".dx", ".dw"), got, want):
                    err, _ = held(name + part, a, w, "high", **where)
                    worst[name] = max(worst[name], err)
            rows = [bwd(x[:b], w2, g[:b], DP1, True, "high")[0][:37]
                    for b in (37, 64, 4096)]
            torch.cuda.synchronize()
            same = all(torch.equal(rows[0], r) for r in rows[1:])
            log("kernel", name=name, check="dx_rows_0_37_at_B_37_64_4096",
                shape=f"in {n} T {t_dim}", same_bits=same)
            if not same:
                raise AssertionError(f"{name} in {n} T {t_dim}: a row's dx "
                                     "moves with B")
    return worst


def check_wide(device) -> dict:
    """Phase 6c: widths past one launch, each kernel against its plain
    version at phase 3's bars (K12-K14 at phase 13's), twice with the same
    bits: K1, K3, K2 and K4 (dx and dW) and K5 ('sumsq' and 'mse') at
    x[256, 64], dp1 34, T 96; K12, K13 and K14 at D+1 8 / N 64 / K 128 and
    at D+1 40.  Returns the worst f32 error of each kernel."""
    rng = np.random.default_rng(SEED + 20)
    worst = {}
    b, n, dp1, t_dim = WIDE_LAYER
    where = dict(shape=f"x[{b},{n}] dp1 {dp1} T {t_dim}")

    def twice(name, call, ref, precision="high"):
        got, again = call(), call()
        torch.cuda.synchronize()
        for a, c in zip(got, again):
            if not (a is None and c is None or torch.equal(a, c)):
                raise AssertionError(f"{name} {where}: two runs differ")
        for part, a, w in zip(("", ".dw"), got, ref()):
            if a is not None:
                err, _ = held(name + part, a, w, precision, **where)
                worst[name] = max(worst.get(name, 0.0), err)

    for x_dtype in (torch.float32, torch.bfloat16):
        x, w2 = layer_inputs(rng, b, n, True, "high", device, t_dim, dp1)
        x = x.to(x_dtype)
        g = torch.from_numpy(rng.normal(size=(b, t_dim)).astype(np.float32))
        g = g.to(device)
        y = torch.from_numpy(rng.normal(size=(b, t_dim)).astype(np.float32))
        y = y.to(device)
        where["x"] = str(x_dtype).split(".")[-1]
        twice("fused_dw_fwd", lambda: (kan_layer_fused_dw(x, w2, dp1),),
              lambda: (kan_layer_fused_dw_reference(x, w2, dp1),))
        twice("fused_fwd", lambda: (kan_layer_fused(x, w2, dp1),),
              lambda: (kan_layer_fused_reference(x, w2, dp1),))
        twice("fused_dw_bwd", lambda: _fused_dw_bwd(x, w2, g, dp1, True,
                                                    "high"),
              lambda: kan_layer_fused_dw_bwd_reference(x, w2, g, dp1))
        twice("fused_bwd", lambda: _fused_bwd(x, w2, g, dp1, True, "high"),
              lambda: kan_layer_fused_bwd_reference(x, w2, g, dp1))
        for loss in ("sumsq", "mse"):
            args = (x, w2, dp1, y if loss == "mse" else None, loss)
            got = kan_train_step_fused(*args)
            again = kan_train_step_fused(*args)
            want = kan_train_step_fused_reference(*args)
            torch.cuda.synchronize()
            if not all(torch.equal(a, c) for a, c in zip(got, again)):
                raise AssertionError(f"fused_step {where}: two runs differ")
            err, _ = held("fused_step.dw", got[1], want[1], "high", **where,
                          loss=loss)
            rel = abs(float(got[0]) - float(want[0])) / abs(float(want[0]))
            if not rel <= STEP_RTOL:
                raise AssertionError(f"fused_step loss {where}: {rel}")
            worst["fused_step"] = max(worst.get("fused_step", 0.0), err)
    for mb, mn, mk, mdp1 in WIDE_M3:
        for x_dtype in (torch.float32, torch.bfloat16):
            x = torch.from_numpy(rng.uniform(-1, 1, (mb, mn))
                                 .astype(np.float32)).to(device, x_dtype)
            m3 = torch.from_numpy(rng.normal(
                0, 1 / np.sqrt(mdp1 * mn), (mdp1, mn, mk)).astype(np.float32))
            m3 = m3.to(device)
            gm = torch.from_numpy(rng.normal(size=(mb, mk))
                                  .astype(np.float32)).to(device, x_dtype)
            where = dict(shape=f"x[{mb},{mn}] m3[{mdp1},{mn},{mk}]",
                         x=str(x_dtype).split(".")[-1],
                         slices={k: pl3.m3_slices(mn, mdp1, mk, k)
                                 for k in (0, 1, 2)})
            want_dx, want_dm = qkan_layer_fused_bwd_reference(x, m3, gm)
            for name, call, want in (
                    ("m3_fwd", lambda: (pl3._launch_fwd(x, m3),),
                     (qkan_layer_fused_reference(x, m3),)),
                    ("m3_bwd", lambda: pl3._launch_bwd(x, m3, gm, True),
                     (want_dx, want_dm)),
                    ("m3_bwd_dw", lambda: pl3._launch_bwd(x, m3, gm, False),
                     (None, want_dm))):
                twice(name, call, lambda want=want: want)
    return worst


def bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    """(least ms, what bounds it) on one H100 at its published peaks."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def unit_bound(bytes_moved: float, flops: float,
               tensor_cores: bool) -> tuple:
    """(least ms, what bounds it, the units, the FP32 CUDA-core bound ms)
    on the units the kernel uses: on the tensor cores the flops as three
    TF32 passes (3xTF32) over 495 TFLOP/s; on the CUDA cores the FP32
    rate."""
    fp32_ms, fp32_by = bound(bytes_moved, flops)
    if not tensor_cores:
        return fp32_ms, fp32_by, "FP32 CUDA cores", fp32_ms
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = 3.0 * flops / TF32_FLOP_PER_S * 1e3
    ms, by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return ms, by, "tensor cores, 3xTF32", fp32_ms


def step_bound(bytes_moved: float, flops: float, n: int, dp1: int,
               t_dim: int) -> tuple:
    """``unit_bound`` of a train step: its route is
    ``fused_step_tensor_cores``."""
    return unit_bound(bytes_moved, flops,
                      fl.fused_step_tensor_cores(n, dp1, t_dim))


def kernel_cases(rng, device, b: int, n: int, t_dim: int = T) -> dict:
    """Every fused-layer kernel at one shape, 'high', f32 x, tanh on: name
    -> (kernel call, plain call, one PyTorch call or None, (bound ms, what
    bounds it) on the units the kernel uses (``unit_bound``: a forward
    that ``fused_fwd_plan`` sends to the tensor cores is bound as
    3xTF32), the FP32 CUDA-core bound ms beside it where that differs,
    else None).  Phases 6b and 8 time the same calls; each call is one
    library call (a forward with its feature splits' pass; a backward
    without its dW pass, which phase 6b times alone).  A backward on the
    tensor cores (``fused_bwd_plan``) is bound as 3xTF32 too."""
    x, w2 = layer_inputs(rng, b, n, True, "high", device, t_dim)
    g = torch.from_numpy(rng.normal(size=(b, t_dim)).astype(np.float32))
    g = g.to(device)
    mm = 2.0 * b * n * (DP1 - 1) * t_dim  # flops of one contraction
    # bytes of x [B, in], w2 [dp1*in, T] and one [B, T] (g or out)
    x_b, w_b, bt_b = 4.0 * b * n, 4.0 * DP1 * n * t_dim, 4.0 * b * t_dim
    on_tc = fl.fused_fwd_plan(b, n, DP1, t_dim)[0]
    f_ms, f_by, _, f_fp32 = unit_bound(x_b + w_b + bt_b, mm, on_tc)
    fwd = ((f_ms, f_by), f_fp32 if on_tc else None)
    # a backward reads x, g and w2 and writes dx and dW, and does two
    # contractions: on the tensor cores where fused_bwd_plan sends it
    bwd_tc = bwd_route(b, n, t_dim)["tensor_cores"]
    k_ms, k_by, _, k_fp32 = unit_bound(2 * x_b + 2 * w_b + bt_b, 2 * mm,
                                       bwd_tc)
    bwd = ((k_ms, k_by), k_fp32 if bwd_tc else None)
    return {
        "fused_dw_fwd": (
            lambda: kan_layer_fused_dw(x, w2, DP1),
            lambda: kan_layer_fused_dw_reference(x, w2, DP1),
            None, *fwd,
        ),
        "fused_fwd": (
            lambda: kan_layer_fused(x, w2, DP1),
            lambda: kan_layer_fused_reference(x, w2, DP1),
            None, *fwd,
        ),
        "fused_dw_bwd": (
            lambda: _bwd_pass("qkan_fused_dw_bwd", x, w2, g, DP1, True, (0,),
                              True),
            lambda: kan_layer_fused_dw_bwd_reference(x, w2, g, DP1),
            None, *bwd,
        ),
        "fused_bwd": (
            lambda: _bwd_pass("qkan_fused_bwd", x, w2, g, DP1, True, (), True),
            lambda: kan_layer_fused_bwd_reference(x, w2, g, DP1),
            None, *bwd,
        ),
    }


def time_all(device, card: str) -> dict:
    """Phase 6b: every fused-layer kernel, its plain version and its
    bound, 'high', f32 x, tanh on, at every (in, T) of LAYER_SHAPES and B
    in LAYER_BATCHES, with its device µs a call (``torch.profiler``, every
    kernel of the library call) and, on the tensor cores, the FP32
    CUDA-core bound beside the 3xTF32 one.  Event times are CUDA-event medians of
    single calls, wrapper included."""
    rng = np.random.default_rng(SEED + 6)
    table = {}
    for n, t_dim in LAYER_SHAPES:
        for b in LAYER_BATCHES:
            cases = kernel_cases(rng, device, b, n, t_dim)
            for name, (kern, plain, lib, (b_ms, b_by), fp32_ms) in \
                    cases.items():
                k_ms = median_ms(kern, reps=30)
                p_ms = median_ms(plain, reps=10, warm=2)
                l_ms = median_ms(lib) if lib is not None else None
                kernels = device_per_call(kern)
                dev = sum(us for _, us in kernels) if kernels else None
                route = (bwd_route(b, n, t_dim) if "bwd" in name else
                         dict(zip(("tensor_cores", "splits", "chunk"),
                                  fl.fused_fwd_plan(b, n, DP1, t_dim))))
                table[(name, n, t_dim, b)] = dict(
                    ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms,
                    bound_by=b_by, bound_fp32_ms=fp32_ms, device_us=dev,
                    kernels={k[:48]: us for k, us in kernels}, **route,
                )
                log("time", kernel=name, shape=f"x[{b},{n}] T {t_dim}",
                    **route,
                    kernel_ms=f"{k_ms:.4f}",
                    device_us="not measured" if dev is None else f"{dev:.3f}",
                    plain_ms=f"{p_ms:.4f}",
                    library_ms="null" if l_ms is None else f"{l_ms:.4f}",
                    bound_us=f"{b_ms * 1e3:.3f}", bound_by=b_by,
                    bound_fp32_us=("n/a" if fp32_ms is None
                                   else f"{fp32_ms * 1e3:.3f}"),
                    card=f"'{card}'")
    return table


# -- the fixed-order partial-sum passes (csrc/partial_sum.cu) ----------------

PASS_KERNEL = "partial_sum_kernel"  # in the names of both forms of the pass


def pass_cases(device, which: str) -> dict:
    """The dW pass ('dw': layer 0 at B = 4096 and 64; 'k5': the headline
    step's workspace) or the dM pass ('dm': the M3 headline and N16 K128)
    over real partials: tag -> (pass call, plain call in the pass's order,
    plain call as ``part.sum(0)``, the one PyTorch call ``torch.sum(part,
    dim=0)`` over the same partials, (bound ms, what bounds it), (nblk,
    per, segments)).  The bound: the partials read once and the sums
    written once, one add a partial."""
    rng = np.random.default_rng(SEED + 17)
    cases = {}
    if which == "dm":
        for tag, (b, n, k, dp1) in ((DM_HEAD, (HB, HN, HK, HDEG + 1)),
                                    ("dM_N16_K128_B4096", M3_WIDE)):
            _, x, m3 = m3_timing_cases(device, b, n, k, dp1, timed=False)
            g = torch.from_numpy(rng.normal(size=(b, k)).astype(np.float32))
            _, part, _ = pl3._bwd_pass(x, m3, g.to(device), False)
            nblk, per = part.shape[0], part[0].numel()
            seg = partial_sum_segments(nblk, per)
            cases[tag] = (
                lambda part=part: pl3.m3_dm_partial_sum(part),
                lambda part=part, seg=seg: fixed_order_sum_reference(part, seg),
                lambda part=part: pl3.m3_dm_partial_sum_reference(part),
                lambda part=part: torch.sum(part, dim=0),
                bound(4.0 * (nblk * per + per), float(nblk * per)),
                (nblk, per, seg))
        return cases
    if which == "dw":
        shapes = [(DW_HEAD, 4096, SHAPE[0], DP1, T, True),
                  ("dW_layer0_B64", 64, SHAPE[0], DP1, T, True)]
    else:
        shapes = [("dW_k5_headline", HB, HN, HDEG + 1, HK, False)]
    for tag, b, n, dp1, t_dim, tanh in shapes:
        if which == "dw":
            x, w2 = layer_inputs(rng, b, n, tanh, "high", device)
            g = torch.from_numpy(rng.normal(size=(b, t_dim))
                                 .astype(np.float32)).to(device)
            ws = _bwd_pass("qkan_fused_dw_bwd", x, w2, g, dp1, tanh, (0,),
                           True)[1]
        else:  # K5's own workspace, in its own layout (fused_step_layout)
            (x, _), w = headline_inputs(device)
            w2 = weights_to_m3(w, HN, HK).reshape(-1, HK).contiguous()
            _, ws, _ = _step_pass(x, w2, dp1, None, "sumsq", tanh)
        kw = {"step": which == "k5"}
        part, _ = fused_bwd_workspace_partials(ws, b, n, dp1, t_dim, **kw)
        nblk, per = part.shape
        args = (ws, b, n, dp1, t_dim)
        cases[tag] = (
            lambda args=args, kw=kw: fused_bwd_partial_sum(*args, **kw),
            lambda args=args, kw=kw: fused_bwd_fixed_order_reference(*args,
                                                                     **kw),
            lambda args=args, kw=kw: fused_bwd_partial_sum_reference(*args,
                                                                     **kw),
            lambda part=part: torch.sum(part, dim=0),
            bound(4.0 * (nblk * (per + t_dim) + dp1 * n * t_dim),
                  float(nblk * (per + t_dim))),
            (nblk, per, partial_sum_segments(nblk, per)))
    return cases


def time_passes(cases: dict, card: str) -> dict:
    """Each pass first held bit for bit to its plain version in its own
    order, twice on the same partials, and within the BARS of
    ``part.sum(0)``; then its event ms, device µs, plain ms and bound,
    beside ``torch.sum(part, dim=0)``'s event ms and device µs."""
    table = {}
    for tag, (kern, fixed, plain, lib, (b_ms, b_by), (nblk, per, seg)) in \
            cases.items():
        got, again, want = kern(), kern(), fixed()
        torch.cuda.synchronize()
        if not (torch.equal(got, want) and torch.equal(got, again)):
            raise AssertionError(f"pass {tag}: not the bits of the plain sum "
                                 f"in its order (S = {seg}), or not twice")
        err, _ = held("partial_sum_pass", got, plain(), "high", case=tag)
        ms, lib_ms = paired_ms(kern, lib)
        plain_ms = median_ms(plain, reps=10, warm=2)
        dev = [us for k, us in device_per_call(kern) if PASS_KERNEL in k]
        lib_kernels = device_per_call(lib)
        row = dict(nblk=nblk, per=per, segments=seg, max_abs_err=err,
                   ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                   device_us=dev[0] if dev else None,
                   library_device_us=(sum(us for _, us in lib_kernels)
                                      if lib_kernels else None),
                   bound_ms=b_ms, bound_by=b_by)
        table[tag] = row
        log("time", kernel="partial_sum_pass", case=tag, nblk=nblk, per=per,
            segments=seg,
            kernel_ms=f"{row['ms']:.4f}",
            device_us="not measured" if not dev else f"{dev[0]:.3f}",
            plain_ms=f"{row['plain_ms']:.4f}",
            torch_sum_ms=f"{row['library_ms']:.4f}",
            torch_sum_device_us=("not measured" if not lib_kernels
                                 else f"{row['library_device_us']:.3f}"),
            bound_us=f"{b_ms * 1e3:.3f}", bound_by=b_by, card=f"'{card}'")
    return table


class StepLossKAN(FixedKAN):
    """FixedKAN that keeps each step's loss (on the card, no sync)."""

    def _run_epochs(self, train_step, *args):
        self.step_losses = []

        def step(idx_row):
            loss = train_step(idx_row)
            self.step_losses.append(loss)
            return loss

        return super()._run_epochs(step, *args)


def step_gaps(a: StepLossKAN, b: StepLossKAN) -> dict:
    """|a - b| / |b| of the per-step losses at steps 1, 2, 4, ..., 128."""
    la = torch.stack(a.step_losses).double().cpu().numpy()
    lb = torch.stack(b.step_losses).double().cpu().numpy()
    gap = np.abs(la - lb) / np.abs(lb)
    return {k: f"{gap[k - 1]:.1e}" for k in (1, 2, 4, 8, 16, 32, 64, 128)
            if k <= len(gap)}


def train_data():
    """4096 rows uniform in [0, 1)^784, labels the argmax of a fixed random
    linear teacher, so the loss can fall."""
    rng = np.random.default_rng(SEED + 4)
    x = rng.random((TRAIN_ROWS, SHAPE[0]), dtype=np.float32)
    teacher = rng.normal(size=(SHAPE[0], T))
    return x, np.argmax((x - 0.5) @ teacher, axis=1)


def scaled_coef_gap(model, ref) -> float:
    return max(
        float((a["coefficients"].double() - b["coefficients"].double())
              .abs().max() / b["coefficients"].abs().max())
        for a, b in zip(model.params, ref.params)
    )


def check_start_gradients(path: Path, device, x, y) -> None:
    """Phase 7a: the loss gradients at the start through each backend."""
    model = FixedKAN.load_model(path, device=device)
    for rows in (TRAIN_BATCH, TRAIN_ROWS):
        xb = torch.from_numpy(x[:rows]).to(device)
        yb = torch.nn.functional.one_hot(
            torch.from_numpy(y[:rows]).to(device), T
        ).float()
        grads = {}
        for backend in ("xla", "fused_dw", "fused"):
            params = [{
                "degrees": lp["degrees"],
                "coefficients": lp["coefficients"].clone().requires_grad_(),
                "horizontal_weights":
                    lp["horizontal_weights"].clone().requires_grad_(),
            } for lp in model.params]
            logits = kan_apply(params, xb, MAX_DEGREE, backend=backend,
                               matmul_precision="high")
            loss = torch.mean(-torch.sum(
                yb * torch.log_softmax(logits, dim=-1), dim=-1
            ))
            leaves = [lp[k] for lp in params
                      for k in ("coefficients", "horizontal_weights")]
            grads[backend] = torch.autograd.grad(loss, leaves)
        for backend in ("fused_dw", "fused"):
            worst = max(
                float((a - b).abs().max() / b.abs().max())
                for a, b in zip(grads[backend], grads["xla"])
            )
            log("train", check=f"start_gradients_{backend}_vs_xla",
                rows=rows, max_err_over_leaf_max=f"{worst:.3e}",
                bar=TRAIN_RTOL)
            if not worst <= TRAIN_RTOL:
                raise AssertionError(f"{backend} gradients: {worst}")


def check_short_run(path: Path, device, x, y, preset: dict) -> None:
    """Phase 7b: 4 steps, where FP32 keeps the trajectories together."""
    runs = {}
    for backend in ("xla", "fused_dw", "fused"):
        model = FixedKAN.load_model(path, device=device)
        losses = model.train(x[:SHORT_ROWS], y[:SHORT_ROWS],
                             batch_size=TRAIN_BATCH, backend=backend,
                             seed=SEED, **preset)
        runs[backend] = (np.asarray(losses), model)
    xla_losses, xla_model = runs["xla"]
    for backend in ("fused_dw", "fused"):
        losses, model = runs[backend]
        rel = float(np.max(np.abs(losses - xla_losses) / np.abs(xla_losses)))
        coef = scaled_coef_gap(model, xla_model)
        log("train", check=f"short_run_{backend}_vs_xla", steps=4,
            loss_rel=f"{rel:.3e}", coef_scaled=f"{coef:.3e}",
            bar=TRAIN_RTOL)
        if not (rel <= TRAIN_RTOL and coef <= TRAIN_RTOL):
            raise AssertionError(f"{backend} left the 'xla' trajectory in "
                                 f"4 steps: losses {rel}, coefficients {coef}")


def run_training(device, workdir: Path) -> tuple[dict, dict]:
    """Phase 7: the flagship width trains from one random start on each
    backend; returns (per-path launch counts, ms per train step)."""
    path = workdir / "flagship_train_start.npz"
    write_checkpoint(path)
    x, y = train_data()
    preset = dict(FixedKANConfig.TRAIN_PRESETS["recommended"])
    preset["epochs"] = TRAIN_EPOCHS
    check_start_gradients(path, device, x, y)
    check_short_run(path, device, x, y, preset)

    steps = TRAIN_EPOCHS * (TRAIN_ROWS // TRAIN_BATCH)
    runs, paths, step_ms = {}, {}, {}
    for backend in ("xla", "fused_dw", "fused"):
        model = StepLossKAN.load_model(path, device=device)
        torch.cuda.synchronize()
        reset_counts()
        start = time.perf_counter()
        losses = model.train(x, y, batch_size=TRAIN_BATCH, backend=backend,
                             seed=SEED, **preset)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        counts = read_counts()
        paths[f"train_{backend}"] = counts
        step_ms[backend] = wall * 1e3 / steps
        log("train", backend=backend, losses=[f"{v:.6f}" for v in losses],
            diverged=model.last_train_diverged,
            precision=model.last_matmul_precision, steps=steps,
            ms_per_step=f"{step_ms[backend]:.4f}", launches=counts)
        if (len(losses) != TRAIN_EPOCHS or model.last_train_diverged
                or not np.all(np.isfinite(losses))):
            raise AssertionError(f"{backend}: bad losses {losses}")
        if not losses[1] < losses[0]:
            raise AssertionError(f"{backend}: loss did not fall {losses}")
        expected = dict.fromkeys(counts, 0)
        layers = len(SHAPE) - 1
        # a backward's dW pass a layer, and the forward's pass where it
        # splits the features (layer 0 at batch 64)
        passes = steps * (layers + fwd_passes(TRAIN_BATCH))
        if backend == "fused_dw":
            expected.update(fused_dw_fwd=layers * steps,
                            fused_dw_bwd=layers * steps,
                            fused_bwd_partial_sum=passes)
        elif backend == "fused":
            expected.update(fused_fwd=layers * steps,
                            fused_bwd=layers * steps,
                            fused_bwd_partial_sum=passes)
        if counts != expected:
            raise AssertionError(f"{backend}: launches {counts} != {expected}")
        runs[backend] = (np.asarray(losses), model)

    # the FP32 floor of this run: 'xla' in float64 from the same start
    model64 = StepLossKAN.load_model(path, device=device)
    model64.params = [
        {k: v.double() if v.is_floating_point() else v for k, v in lp.items()}
        for lp in model64.params
    ]
    losses64 = np.asarray(model64.train(x.astype(np.float64), y,
                                        batch_size=TRAIN_BATCH, seed=SEED,
                                        **preset))
    xla_losses, xla_model = runs["xla"]
    floor = float(np.max(np.abs(xla_losses - losses64) / losses64))
    coef_floor = scaled_coef_gap(xla_model, model64)
    log("train", check="fp32_floor_xla_vs_xla_float64",
        loss_rel=f"{floor:.3e}", coef_scaled=f"{coef_floor:.3e}",
        per_step=step_gaps(xla_model, model64))
    for backend in ("fused_dw", "fused"):
        losses, model = runs[backend]
        rel = float(np.max(np.abs(losses - xla_losses) / np.abs(xla_losses)))
        coef = scaled_coef_gap(model, xla_model)
        log("train", check=f"{backend}_vs_xla_128_steps",
            loss_rel=f"{rel:.3e}", coef_scaled=f"{coef:.3e}",
            loss_over_floor=f"{rel / max(floor, 1e-300):.3f}",
            coef_over_floor=f"{coef / max(coef_floor, 1e-300):.3f}",
            bar=FLOOR_FACTOR,
            per_step=step_gaps(model, xla_model))
        if not (rel <= FLOOR_FACTOR * floor
                and coef <= FLOOR_FACTOR * coef_floor):
            raise AssertionError(
                f"{backend} left 'xla' by more than {FLOOR_FACTOR}x the FP32 "
                f"floor in 128 steps: losses {rel} (floor {floor}), "
                f"coefficients {coef} (floor {coef_floor})"
            )

    # each trained model serves one request through the predictor
    x_req = np.random.default_rng(SEED + 7).random(
        (TRAIN_ROWS, SHAPE[0]), dtype=np.float32
    )
    for backend, (_, model) in runs.items():
        predictor = BatchedPredictor(model, max_batch=TRAIN_ROWS)
        reset_counts()
        got = predictor.predict(x_req)
        counts = read_counts()
        paths[f"serve_trained_{backend}"] = counts
        if counts["fused_dw_fwd"] != len(SHAPE) - 1:
            raise AssertionError(f"serving launches {counts}")
        with torch.inference_mode():
            want = kan_apply(model.params, torch.from_numpy(x_req).to(device),
                             MAX_DEGREE, backend="xla",
                             matmul_precision="high").cpu().numpy()
        rel = float(np.abs(got - want).max() / np.abs(want).max())
        log("train", check=f"serve_trained_{backend}", rows=TRAIN_ROWS,
            rel_err=f"{rel:.3e}", bar=SLICE_RTOL)
        if not (got.shape == want.shape and rel <= SLICE_RTOL):
            raise AssertionError(f"trained {backend} model serves {rel}")
    return paths, step_ms


KERNEL_NAMES = {
    # both forward kernels: fused_dw_fwd_kernel and fused_dw_fwd_kernel_tc
    "fused_dw_fwd": "fused_dw_fwd_kernel",
    "fused_fwd": "fused_dw_fwd_kernel",  # K3 shares K1's device code
    "fused_dw_bwd": "fused_dw_bwd_kernel",
    "fused_bwd": "fused_dw_bwd_kernel",
}


def device_events(prof) -> list:
    """(name, device us, count) of the device-side events of a profile."""
    out = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        out.append((ev.key, float(us), int(ev.count)))
    return out


def profile_device_time(device, workdir: Path, card: str) -> None:
    """Phase 8: device time per kernel and the train step's busy share."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(SEED + 8)
    calls = 20
    for n, t_dim in ((784, 10), (10, 10)):  # the flagship's own layers
        for b in LAYER_BATCHES:
            for name, (fn, *_) in kernel_cases(rng, device, b, n,
                                               t_dim).items():
                fn()
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    for _ in range(calls):
                        fn()
                    torch.cuda.synchronize()
                us = [u / c for k, u, c in device_events(prof)
                      if KERNEL_NAMES[name] in k]
                log("profile", kernel=name, shape=f"x[{b},{n}] T {t_dim}",
                    device_us="not measured" if not us else f"{max(us):.3f}",
                    card=f"'{card}'")

    path = workdir / "flagship_profile_start.npz"
    write_checkpoint(path)
    x, y = train_data()
    rows = 10 * TRAIN_BATCH
    for backend in ("xla", "fused_dw", "fused"):
        model = FixedKAN.load_model(path, device=device)
        model.train(x[:rows], y[:rows], epochs=1, batch_size=TRAIN_BATCH,
                    backend=backend)  # warm: first-call costs stay out
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            start = time.perf_counter()
            model.train(x[:rows], y[:rows], epochs=1,
                        batch_size=TRAIN_BATCH, backend=backend)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - start) * 1e6
        events = sorted(device_events(prof), key=lambda e: -e[1])
        busy = sum(u for _, u, _ in events)
        log("profile", train_backend=backend, steps=10,
            wall_ms_per_step=f"{wall_us / 10 / 1e3:.4f}",
            device_ms_per_step=f"{busy / 10 / 1e3:.4f}",
            busy_share=f"{busy / wall_us:.4f}",
            launches_per_step=sum(c for _, _, c in events) / 10,
            card=f"'{card}'")
        for key, us, count in events[:6]:
            log("profile", train_backend=backend, kernel=key[:60],
                us_per_step=f"{us / 10:.3f}", count=count)


# -- phases 9-11: the quantum runtime -------------------------------------------

# kernel vs plain: both sides do the same few flops an amplitude and
# differ by a contracted FMA or the last bit of sin/cos
SV_BAR = {torch.float32: 1e-6, torch.float64: 1e-13}
SV_SIZES = (5, 11, 21)
# the headline quantum layer (tests/test_quantum_mode.py's N=K=16 case)
QN = QK = 16
QDEG = 7
QB = 256
# 10a: f32 is the atol of test_quantum_grad_finite_f32_at_saturation, f64
# that of test_quantum_forward_matches_classical; 10b: test_quantum_mode's
# gradient bar
QLAYER_BAR = {torch.float32: 1e-4, torch.float64: 1e-8}
QGRAD_BAR = 1e-6
DEMO_STEPS, DEMO_LR, DEMO_B = 60, 0.05, 8
SCALE_N = 13  # the example's n: a 2^13 diagonal, a 27-qubit circuit
DENSE_N = 10  # a 1024 x 1024 matrix: 21 qubits
# kernel name in the kernels line -> (TPU kernel, its counters, the device
# function's name in the profiler)
SV_KERNELS = {
    "ucry_cs_pair": ("sim/pallas_kernels.py:168",
                     ("ucry_cs_pair", "ucry_cs_pair_bwd", "ucry_cs",
                      "ucry_cs_bwd"), "ucry_cs_kernel"),
    "ucry": ("sim/pallas_kernels.py:47", ("ucry", "ucry_bwd"), "ucry_kernel"),
    "diag_mult": ("sim/pallas_kernels.py:240", ("diag_mult",), "diag_kernel"),
    "h_pair": ("sim/pallas_kernels.py:266", ("h_pair",), "h_pair_kernel"),
}


def _on(device, a, dtype):
    return torch.from_numpy(np.asarray(a)).to(device=device, dtype=dtype)


def check_statevector_kernels(device) -> dict:
    """Phase 9: every statevector kernel against its plain version;
    returns name -> worst |kernel - plain| over all cases."""
    rng = np.random.default_rng(SEED + 9)
    worst = {}

    def held_sv(name, got, want, dtype, **where) -> float:
        torch.cuda.synchronize()
        if (got.shape != want.shape or got.dtype != want.dtype
                or not bool(torch.isfinite(got).all())):
            raise AssertionError(f"{name} {where}: bad output")
        err = float((got - want).abs().max())
        bar = SV_BAR[dtype] * float(want.abs().max())
        if not err <= bar:
            raise AssertionError(f"{name} {where}: {err} > {bar}")
        worst[name] = max(worst.get(name, 0.0), err)
        return err / bar

    def dt(dtype):
        return str(dtype).split(".")[-1]

    # (qubits, batch, shared angles): the sweep, then the main paths'
    # own shapes
    cases = [(q, b, shared) for q in SV_SIZES
             for b, shared in ((1, True), (8, True), (8, False))]
    cases += [(17, QB, False), (17, DEMO_B, False), (11, 4, True)]
    for q, batch, shared in cases:
        lead = (batch,) if batch > 1 else ()
        for dtype in (torch.float32, torch.float64):
            where = dict(q=q, batch=batch,
                         angles="shared" if shared else "per-row",
                         float=dt(dtype))
            rows = () if shared else lead
            psi = _on(device, rng.normal(size=(*lead, 2**q)), dtype)
            th = _on(device, rng.uniform(0, 2 * np.pi, (*rows, 2 ** (q - 1))),
                     dtype)
            d = _on(device, rng.uniform(-1, 1, (*rows, 2**q)), dtype)
            c, s = torch.cos(th / 2), torch.sin(th / 2)
            want = pk.ucry_msb_cs_reference(psi, c, s)
            ratios = {
                "ucry_cs_pair": held_sv(
                    "ucry_cs_pair", pk.ucry_msb_cs_pallas_pair(psi, c, s),
                    want, dtype, **where),
                "ucry_cs(K7)": held_sv(
                    "ucry_cs_pair", pk.ucry_msb_cs_pallas(psi, c, s),
                    want, dtype, **where),
                "ucry": held_sv(
                    "ucry", pk.ucry_msb_pallas(psi, th),
                    pk.ucry_msb_reference(psi, th), dtype, **where),
                "diag_mult": held_sv(
                    "diag_mult", pk.diag_mult_pallas(psi, d),
                    pk.diag_mult_reference(psi, d), dtype, **where),
            }
            for qubit in sorted({0, q // 2, q - 1}):
                ratios[f"h_pair[{qubit}]"] = held_sv(
                    "h_pair", pk.h_gate_pallas(psi, qubit),
                    pk.h_gate_reference(psi, qubit), dtype, **where)
            log("sv_kernel", **where, err_over_bar={
                k: f"{v:.3f}" for k, v in ratios.items()})
            del psi, th, d, c, s, want
    for dtype in (torch.float32, torch.float64):
        psi = _on(device, rng.normal(size=2**11), dtype)
        ratios = [held_sv("h_pair", pk.h_gate_pallas(psi, k),
                          pk.h_gate_reference(psi, k), dtype, qubit=k)
                  for k in range(11)]
        log("sv_kernel", check="h_pair_every_qubit_of_11", float=dt(dtype),
            worst_err_over_bar=f"{max(ratios):.3f}")

    def grads(fn, args, tgt):
        leaves = [a.detach().clone().requires_grad_() for a in args]
        loss = torch.sum((fn(*leaves) - tgt) ** 2)
        return torch.autograd.grad(loss, leaves)

    for lead, shared in (((), True), ((8,), True), ((8,), False)):
        for dtype in (torch.float32, torch.float64):
            rows = () if shared else lead
            psi = _on(device, rng.normal(size=(*lead, 2**11)), dtype)
            tgt = _on(device, rng.normal(size=(*lead, 2**11)), dtype)
            th = _on(device, rng.uniform(-3, 3, (*rows, 2**10)), dtype)
            c, s = torch.cos(th / 2), torch.sin(th / 2)
            for name, kern, plain, args in (
                ("ucry", pk.ucry_msb_pallas, pk.ucry_msb_reference,
                 (psi, th)),
                ("ucry_cs_pair", pk.ucry_msb_cs_pallas_pair,
                 pk.ucry_msb_cs_reference, (psi, c, s)),
            ):
                got, want = grads(kern, args, tgt), grads(plain, args, tgt)
                ratios = [held_sv(name + "_vjp", g, w, dtype)
                          for g, w in zip(got, want)]
                log("sv_kernel", check=f"{name}_vjp_vs_autograd_of_plain",
                    batch=lead[0] if lead else 1,
                    angles="shared" if shared else "per-row", float=dt(dtype),
                    err_over_bar=[f"{r:.3f}" for r in ratios])
    return worst


def _path(name: str, fn, expected: dict, paths: dict):
    """Run one main path with the counts at 0, check them, keep them."""
    torch.cuda.synchronize()
    reset_counts()
    start = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - start) * 1e3
    counts = read_counts()
    want = dict.fromkeys(counts, 0)
    want.update(expected)
    if counts != want:
        raise AssertionError(f"{name}: launches {counts} != {want}")
    paths[name] = counts
    log("path", path=name, ms=f"{ms:.4f}",
        launches={k: v for k, v in counts.items() if v})
    return out, ms


def _bar_check(name: str, err: float, bar: float, **fields) -> None:
    log("quantum", check=name, max_abs_err=f"{err:.3e}", bar=f"{bar:.1e}",
        **fields)
    if not err <= bar:
        raise AssertionError(f"{name}: {err} > {bar}")


def run_quantum_slice(device) -> tuple[dict, dict, dict]:
    """Phase 10: the quantum paths; returns (per-path launch counts, ms,
    one call of each path for the profiler)."""
    paths, times, calls = {}, {}, {}
    rng = np.random.default_rng(SEED + 10)
    x_np = rng.uniform(-0.9, 0.9, (QB, QN))
    w_np = rng.uniform(-0.9, 0.9, (QDEG + 1, QN * QK))

    # a. the batched quantum layer against the classical layer
    for dtype in (torch.float32, torch.float64):
        name = f"quantum_layer_{str(dtype).split('.')[-1]}"
        x, w = _on(device, x_np, dtype), _on(device, w_np, dtype)
        with torch.no_grad():
            qkan_layer_forward_quantum_batched(x, w, QN, QK)  # warm
            got, times[name] = _path(
                name, lambda: qkan_layer_forward_quantum_batched(x, w, QN, QK),
                {"ucry": 1}, paths)
            want = qkan_layer_forward_batched(x, w, QN, QK)
        if got.shape != (QB, QK) or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{name}: bad output {tuple(got.shape)}")
        calls[f"{name}_forward_B{QB}"] = torch.no_grad()(
            lambda x=x, w=w: qkan_layer_forward_quantum_batched(x, w, QN, QK))
        _bar_check(name, float((got - want).abs().max()), QLAYER_BAR[dtype],
                   batch=QB, max_abs_out=f"{float(want.abs().max()):.3e}")

    # b. the gradient through the simulator against the classical one
    x8 = _on(device, x_np[:DEMO_B], torch.float64)
    w_true = _on(device, rng.uniform(-0.8, 0.8, w_np.shape), torch.float64)
    target = qkan_layer_forward_batched(x8, w_true, QN, QK)

    def mse_grad(forward):
        w = _on(device, w_np, torch.float64).requires_grad_()
        loss = torch.mean((forward(x8, w, QN, QK) - target) ** 2)
        return torch.autograd.grad(loss, [w])[0]

    # the state entering the rotation does not depend on the weights, so
    # the VJP computes dtheta only: K8's backward launch is not needed
    g_q, times["quantum_grad_f64"] = _path(
        "quantum_grad_f64",
        lambda: mse_grad(qkan_layer_forward_quantum_batched), {"ucry": 1},
        paths)
    g_c = mse_grad(qkan_layer_forward_batched)
    _bar_check("quantum_grad_f64_vs_classical",
               float((g_q - g_c).abs().max()), QGRAD_BAR, batch=DEMO_B,
               max_abs_grad=f"{float(g_c.abs().max()):.3e}")

    # c. the training demo: Adam through the simulator, f32
    rng_demo = np.random.default_rng(0)
    w_true = _on(device, rng_demo.uniform(-0.8, 0.8, w_np.shape),
                 torch.float32)
    xs = _on(device, rng_demo.uniform(-0.9, 0.9, (DEMO_B, QN)), torch.float32)
    targets = qkan_layer_forward_batched(xs, w_true, QN, QK)
    w = _on(device, rng_demo.uniform(-0.5, 0.5, w_np.shape),
            torch.float32).requires_grad_()
    opt = torch.optim.Adam([w], lr=DEMO_LR)

    def demo_loss():
        preds = qkan_layer_forward_quantum_batched(xs, w, QN, QK)
        return torch.mean((preds - targets) ** 2)

    with torch.no_grad():
        initial = float(demo_loss())

    def step():
        opt.zero_grad(set_to_none=True)
        loss = demo_loss()
        loss.backward()
        opt.step()
        with torch.no_grad():
            w.clamp_(-1.0, 1.0)
        return loss.detach()

    def train():
        return torch.stack([step() for _ in range(DEMO_STEPS)]).cpu().numpy()

    losses, train_ms = _path("quantum_train_f32", train,
                             {"ucry": DEMO_STEPS}, paths)
    times["quantum_train_f32_ms_per_step"] = train_ms / DEMO_STEPS
    with torch.no_grad():
        final = float(demo_loss())
    log("quantum", check="train_demo", steps=DEMO_STEPS,
        loss_start=f"{initial:.4e}", loss_final=f"{final:.4e}",
        losses_every_10=[f"{v:.3e}" for v in losses[::10]],
        ms_per_step=f"{train_ms / DEMO_STEPS:.4f}")
    if not (np.all(np.isfinite(losses)) and final < initial / 10.0):
        raise AssertionError(f"training did not converge: {initial} -> {final}")
    calls[f"quantum_train_step_f32_B{DEMO_B}"] = step

    # d. block encoding at scale: one column of a 2^13 diagonal's encoding
    rng_scale = np.random.default_rng(0)
    size = 2**SCALE_N
    diag = rng_scale.uniform(-1, 1, size)
    start = time.perf_counter()
    cs, sn, alpha, n = fable_runtime_params(np.diag(diag))
    host_s = time.perf_counter() - start
    cs_t, sn_t = _on(device, cs, torch.float32), _on(device, sn, torch.float32)
    del cs, sn
    col = 3
    e = torch.zeros(2 ** (2 * n + 1), dtype=torch.float32, device=device)
    e[col] = 1.0
    psi, times["block_encoding_27q"] = _path(
        "block_encoding_27q",
        lambda: simulate_fable_runtime(cs_t, sn_t, n, psi0=e),
        {"ucry_cs_pair": 1}, paths)
    recovered = (psi[:size] * (alpha * size)).double().cpu().numpy()
    expected = np.zeros(size)
    expected[col] = diag[col]
    torch.cuda.synchronize()
    start = time.perf_counter()
    simulate_fable_runtime(cs_t, sn_t, n, psi0=e)
    torch.cuda.synchronize()
    steady_ms = (time.perf_counter() - start) * 1e3
    times["block_encoding_27q_steady"] = steady_ms
    _bar_check("block_encoding_27q_column", float(np.abs(recovered - expected)
                                                  .max()),
               5e-4 * max(1.0, alpha), qubits=2 * n + 1,
               state_mb=psi.numel() * 4 / 2**20, host_params_s=f"{host_s:.2f}",
               steady_ms=f"{steady_ms:.4f}")
    del psi
    calls["block_encoding_27q"] = lambda: simulate_fable_runtime(
        cs_t, sn_t, n, psi0=e)

    a32 = rng.uniform(-1, 1, (32, 32))
    circ, alpha32 = fable(a32)
    basis = torch.zeros((4, 2**circ.num_qubits), dtype=torch.float32,
                        device=device)
    basis[torch.arange(4), torch.arange(4)] = 1.0
    out, _ = _path("fable_dense_32", lambda: simulate(circ, psi0=basis),
                   {"ucry_cs_pair": 1}, paths)
    rec = out[:, :32].double().cpu().numpy().T * alpha32 * 32
    _bar_check("fable_dense_32_columns", float(np.abs(rec - a32[:, :4]).max()),
               5e-4 * max(1.0, alpha32))

    # e. the gate-by-gate FABLE simulation on K8 and K10
    a = rng.uniform(-1, 1, (2**DENSE_N, 2**DENSE_N))
    (psi, alpha), times["fable_pallas_21q"] = _path(
        "fable_pallas_21q",
        lambda: pk.simulate_fable_pallas(a, device=device),
        {"ucry": 1, "h_pair": 2 * DENSE_N}, paths)
    rec = psi[: 2**DENSE_N].double().cpu().numpy() * alpha * 2**DENSE_N
    _bar_check("fable_pallas_21q_column0", float(np.abs(rec - a[:, 0]).max()),
               5e-4 * max(1.0, alpha))
    oracle = simulate(fable(a)[0], dtype=torch.float32, backend="xla",
                      device=device)
    _bar_check("fable_pallas_21q_state_vs_xla",
               float((psi - oracle).abs().max()), 1e-5)
    calls["fable_pallas_21q"] = lambda: pk.simulate_fable_pallas(
        a, device=device)

    # f. the diagonal gate on that state
    d = _on(device, rng.uniform(-1, 1, psi.shape[-1]), torch.float32)
    got, times["diag_mult_21q"] = _path(
        "diag_mult_21q", lambda: pk.diag_mult_pallas(psi, d),
        {"diag_mult": 1}, paths)
    want = pk.diag_mult_reference(psi, d)
    _bar_check("diag_mult_21q", float((got - want).abs().max()),
               SV_BAR[torch.float32] * float(want.abs().max()))
    return paths, times, calls


def profile_quantum(calls: dict, card: str) -> None:
    """Phase 11b: one call of each quantum path under torch.profiler:
    wall ms (host clock, profiler on), device ms, busy share, and the
    kernels that take the device time."""
    from torch.profiler import ProfilerActivity, profile

    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            start = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - start) * 1e6
        events = sorted(device_events(prof), key=lambda e: -e[1])
        busy = sum(u for _, u, _ in events)
        log("profile", path=name, wall_ms=f"{wall_us / 1e3:.4f}",
            device_ms=f"{busy / 1e3:.4f}", busy_share=f"{busy / wall_us:.4f}",
            launches=sum(c for _, _, c in events), card=f"'{card}'")
        for key, us, count in events[:6]:
            log("profile", path=name, kernel=key[:70], device_us=f"{us:.3f}",
                count=count)


def statevector_cases(rng, device, q: int) -> dict:
    """Every statevector kernel on one f32 state of 2^q amplitudes: name
    -> (kernel call, plain call, one PyTorch call or None, (bound ms, what
    bounds it)).  Phase 11 checks, times and profiles the same calls."""
    n = 2**q
    psi = _on(device, rng.standard_normal(n, dtype=np.float32), torch.float32)
    th = _on(device, rng.uniform(0, 2 * np.pi, n // 2), torch.float32)
    c, s = torch.cos(th / 2), torch.sin(th / 2)
    d = _on(device, rng.uniform(-1, 1, n), torch.float32)
    qubit = (q - 1) // 2  # the lowest qubit of a FABLE row register
    # the 2x2 Hadamard on the [outer, 2, inner] view: the contraction the
    # port's _apply_dense runs for an 'h' gate (TF32 is off)
    h2 = torch.tensor([[1.0, 1.0], [1.0, -1.0]], dtype=torch.float32,
                      device=device) / np.sqrt(2.0)
    # bytes: each input read once, each output written once; operations:
    # the 2x2 products and sums (K8's sincos left out: it is well under
    # the bytes' time)
    return {
        "ucry_cs_pair": (lambda: pk.ucry_msb_cs_pallas_pair(psi, c, s),
                         lambda: pk.ucry_msb_cs_reference(psi, c, s), None,
                         bound(12.0 * n, 3.0 * n)),
        "ucry": (lambda: pk.ucry_msb_pallas(psi, th),
                 lambda: pk.ucry_msb_reference(psi, th), None,
                 bound(10.0 * n, 3.0 * n)),
        "diag_mult": (lambda: pk.diag_mult_pallas(psi, d),
                      lambda: pk.diag_mult_reference(psi, d),
                      lambda: torch.mul(psi, d), bound(12.0 * n, 1.0 * n)),
        "h_pair": (lambda: pk.h_gate_pallas(psi, qubit),
                   lambda: pk.h_gate_reference(psi, qubit),
                   lambda: torch.matmul(
                       h2, psi.view(-1, 2, 2**qubit)).reshape(-1),
                   bound(8.0 * n, 2.0 * n)),
    }


def _sv_device_us(fn, key: str):
    """Device µs a launch of the kernels of ``fn`` whose name holds
    ``key`` ('' for all), the largest, from ``device_per_call``."""
    us = [u for k, u in device_per_call(fn, calls=20) if key in k]
    return max(us) if us else None


def time_statevector(device, card: str) -> dict:
    """Phase 11: each kernel held to its plain version, then event ms,
    host µs a call, device µs, plain ms and bound per kernel at 21 qubits
    (L2) and 27 qubits (HBM), each beside its one PyTorch call's event ms,
    host µs and device µs where there is one (K9: ``torch.mul``, K10:
    ``torch.matmul``), called in turns; returns the table and name ->
    worst |kernel - plain|."""
    rng = np.random.default_rng(SEED + 11)
    table, worst = {}, {}
    for q in (21, 27):
        cases = statevector_cases(rng, device, q)
        for name, (kern, plain, lib, (b_ms, b_by)) in cases.items():
            got, want = kern(), plain()
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            bar = SV_BAR[torch.float32] * float(want.abs().max())
            if not (got.shape == want.shape and err <= bar):
                raise AssertionError(f"{name} at 2^{q}: {err} > {bar}")
            if lib is not None:
                lib_err = float((lib() - want).abs().max())
                if not lib_err <= bar:
                    raise AssertionError(
                        f"{name}'s library call at 2^{q}: {lib_err} > {bar}")
            worst[name] = max(worst.get(name, 0.0), err)
            del got, want
            p_ms = median_ms(plain)
            # the kernel and its one PyTorch call in turns: event ms, and
            # host µs a call from the call to its return on an idle card
            if lib is not None:
                k_ms, l_ms = paired_ms(kern, lib, reps=50)
                h_us, lh_us = paired_host_us(kern, lib, reps=50)
            else:
                k_ms, l_ms = median_ms(kern), None
                h_us, lh_us = paired_host_us(kern, kern, reps=25)[0], None
            dev_us = _sv_device_us(kern, SV_KERNELS[name][2])
            l_dev = _sv_device_us(lib, "") if lib is not None else None
            table[(name, q)] = dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                                    bound_ms=b_ms, bound_by=b_by,
                                    device_us=dev_us, host_us=h_us,
                                    library_host_us=lh_us,
                                    library_device_us=l_dev)
            na = "not measured"
            log("time", kernel=name, state=f"2^{q} f32",
                memory="L2" if q == 21 else "HBM", kernel_ms=f"{k_ms:.4f}",
                device_us=na if dev_us is None else f"{dev_us:.3f}",
                host_us=f"{h_us:.2f}", plain_ms=f"{p_ms:.4f}",
                library_ms="null" if l_ms is None else f"{l_ms:.4f}",
                library_device_us=("null" if lib is None else na
                                   if l_dev is None else f"{l_dev:.3f}"),
                library_host_us="null" if lh_us is None else f"{lh_us:.2f}",
                bound_us=f"{b_ms * 1e3:.3f}", bound_by=b_by,
                err_over_bar=f"{err / bar:.3f}", card=f"'{card}'")
        del cases
        torch.cuda.empty_cache()
    log("time", note="library_ms null for ucry_cs_pair and ucry: no "
        "single PyTorch call computes a multiplexed rotation")
    return table, worst


def time_ucry_launch_shapes(device, card: str) -> dict:
    """Phase 11: K8 where 63 of its 64 main-path launches run, 17 qubits
    with per-row angles at B = 256 (the layer forward, 10a) and B = 8 (the
    gradient and the training demo, 10b-c): held to its plain version
    (phase 9's bar), then event ms, device µs, plain ms and bound."""
    rng = np.random.default_rng(SEED + 19)
    q = QN + 1  # the packed circuit of an N = 16 layer
    table = {}
    for batch in (QB, DEMO_B):
        n = batch * 2**q
        psi = _on(device, rng.standard_normal((batch, 2**q), dtype=np.float32),
                  torch.float32)
        th = _on(device, rng.uniform(0, 2 * np.pi, (batch, 2 ** (q - 1))),
                 torch.float32)

        def kern():
            return pk.ucry_msb_pallas(psi, th)

        def plain():
            return pk.ucry_msb_reference(psi, th)

        got, want = kern(), plain()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        bar = SV_BAR[torch.float32] * float(want.abs().max())
        if not (got.shape == want.shape and err <= bar):
            raise AssertionError(f"ucry at 2^{q} x {batch}: {err} > {bar}")
        del got, want
        b_ms, b_by = bound(10.0 * n, 3.0 * n)
        us = [u for k, u in device_per_call(kern) if SV_KERNELS["ucry"][2] in k]
        row = dict(ms=median_ms(kern), plain_ms=median_ms(plain),
                   device_us=us[0] if us else None, bound_ms=b_ms,
                   bound_by=b_by, library_ms=None, max_abs_err=err)
        table[f"17q_B{batch}_per_row"] = row
        log("time", kernel="ucry", state=f"{batch} x 2^{q} f32, per-row angles",
            kernel_ms=f"{row['ms']:.4f}",
            device_us="not measured" if not us else f"{us[0]:.3f}",
            plain_ms=f"{row['plain_ms']:.4f}", bound_us=f"{b_ms * 1e3:.3f}",
            bound_by=b_by, err_over_bar=f"{err / bar:.3f}", card=f"'{card}'")
    return table


# -- phase 12: the fused single-layer train step (K5) -------------------------

# the headline QKAN-layer step of benchmarks/fused_retune_probe.py
# (headline_sweep): bench.py's rotating-pool shape, no tanh, 'sumsq'
HN = HK = 16
HDEG = 7
HB = 262144
HLR = 1e-7
HSTEPS = 20
STEP_RTOL = 1e-4  # the loss, kernel against plain and against float64
FOLD_BAR = 1e-5   # the fold's out against qkan_layer_forward_batched
# the benchmark cell qkan-layer-16x16-d7: its rows and batch (phase 12d)
LAYER_ROWS, LAYER_B = 1 << 24, 1 << 22


def headline_inputs(device):
    """The probe's inputs: x uniform in [-1, 1) and its reverse (the
    rotating pool), the layer weights [D+1, N*K] uniform in [-1, 1)."""
    rng = np.random.default_rng(SEED + 12)
    x = torch.from_numpy(rng.uniform(-1, 1, (HB, HN)).astype(np.float32))
    w = torch.from_numpy(
        rng.uniform(-1, 1, (HDEG + 1, HN * HK)).astype(np.float32)
    )
    x = x.to(device)
    return (x, x.flip(0).contiguous()), w.to(device)


def step_cases(device) -> list:
    """(name, args of kan_train_step_fused) at the shapes of phase 12a."""
    rng = np.random.default_rng(SEED + 13)
    (hx, _), hw = headline_inputs(device)
    h_w2 = weights_to_m3(hw, HN, HK).reshape(-1, HK).contiguous()
    cases = [("headline", (hx, h_w2, HDEG + 1, None, "sumsq", False)),
             ("headline_bf16_x", (hx.to(torch.bfloat16), h_w2, HDEG + 1,
                                  None, "sumsq", False))]

    def add(name, b, n, dp1, loss, x_dtype=torch.float32, t_dim=T):
        x = torch.from_numpy(rng.uniform(-2, 2, (b, n)).astype(np.float32))
        w2 = torch.from_numpy(rng.normal(
            0, 1 / np.sqrt(dp1 * n), (dp1 * n, t_dim)).astype(np.float32))
        y = torch.from_numpy(rng.normal(size=(b, t_dim)).astype(np.float32))
        cases.append((name, (x.to(device, x_dtype), w2.to(device),
                             dp1, y.to(device) if loss == "mse" else None,
                             loss, True)))

    for b in (1, 64, 4096):
        for loss in ("mse", "sumsq"):
            add(f"layer0_B{b}_{loss}", b, 784, DP1, loss)
    # a target of 32: layer 0 of a FixedKAN [784, 32, ...] mapping to the
    # next width
    for b in (64, 4096):
        add(f"layer0_T32_B{b}_mse", b, 784, DP1, "mse", t_dim=32)
    for loss in ("mse", "sumsq"):
        add(f"ragged_B37_in10_{loss}", 37, 10, DP1, loss)
    add("layer0_B4096_mse_bf16_x", 4096, 784, DP1, "mse", torch.bfloat16)
    add("dp1_1_B4096_sumsq", 4096, 784, 1, "sumsq")
    return cases


def check_step_kernel(device) -> float:
    """Phase 12a: K5 against its plain version on the card, twice on the
    same inputs (the same bits); returns the worst f32 dW error."""
    worst = 0.0
    for name, args in step_cases(device):
        loss, dw = kan_train_step_fused(*args)
        again = kan_train_step_fused(*args)
        want_loss, want_dw = kan_train_step_fused_reference(*args)
        torch.cuda.synchronize()
        x, w2, dp1 = args[:3]
        where = dict(case=name, x=f"[{x.shape[0]},{x.shape[1]}]",
                     dtype=str(x.dtype).split(".")[-1],
                     tensor_cores=fl.fused_step_tensor_cores(
                         x.shape[1], dp1, w2.shape[1]))
        err, _ = held("fused_step.dw", dw, want_dw, "high", **where)
        if x.dtype == torch.float32:
            worst = max(worst, err)
        rel = abs(float(loss) - float(want_loss)) / abs(float(want_loss))
        same = torch.equal(loss, again[0]) and torch.equal(dw, again[1])
        log("kernel", name="fused_step.loss", loss=f"{float(loss):.8e}",
            rel_err=f"{rel:.3e}", bar=STEP_RTOL, same_bits_twice=same,
            **where)
        if not (loss.shape == () and rel <= STEP_RTOL):
            raise AssertionError(f"fused_step loss {name}: {rel}")
        if not same:
            raise AssertionError(f"fused_step {name}: two runs differ")
    return worst


def step_f64(x, w2):
    """(loss, dW) of sum((basis(x) @ w2)^2) by float64 autograd: the JAX
    test's ``fwd`` with no tanh."""
    w64 = w2.detach().double().requires_grad_()
    bas = chebyshev_basis(x.double(), w2.shape[0] // x.shape[1] - 1,
                          clip=False)
    out = bas.transpose(1, 2).reshape(x.shape[0], -1) @ w64
    loss = torch.sum(out**2)
    (dw,) = torch.autograd.grad(loss, [w64])
    return loss.detach(), dw


def run_headline(device, paths: dict) -> dict:
    """Phase 12b: the fold, the start against float64 autograd, then
    HSTEPS steps w2 <- w2 - lr dW on the rotating pool with the counts at
    0; returns the path's host ms."""
    pool, w = headline_inputs(device)
    w2 = weights_to_m3(w, HN, HK).reshape(-1, HK).contiguous()
    fold_out = kan_layer_fused_reference(pool[0], w2, HDEG + 1, False)
    want = qkan_layer_forward_batched(pool[0], w, HN, HK)
    err = float((fold_out - want).abs().max())
    bar = FOLD_BAR * float(want.abs().max())
    log("step", check="fold_vs_qkan_layer_forward_batched",
        max_abs_err=f"{err:.3e}", bar=f"{bar:.3e}")
    if not err <= bar:
        raise AssertionError(f"the fold's out: {err} > {bar}")

    loss, dw = kan_train_step_fused(pool[0], w2, HDEG + 1, apply_tanh=False)
    loss64, dw64 = step_f64(pool[0], w2)
    rel = abs(float(loss) - float(loss64)) / float(loss64)
    err = float((dw.double() - dw64).abs().max())
    bar = STEP_RTOL * float(dw64.abs().max())
    log("step", check="start_vs_float64_autograd", loss=f"{float(loss):.8e}",
        loss_rel=f"{rel:.3e}", dw_max_abs_err=f"{err:.3e}",
        dw_bar=f"{bar:.3e}")
    if not (rel <= STEP_RTOL and err <= bar):
        raise AssertionError(f"headline start: loss {rel}, dW {err} > {bar}")

    def train():
        v, losses = w2.clone(), []
        for i in range(HSTEPS):
            loss_i, dw_i = kan_train_step_fused(pool[i % 2], v, HDEG + 1,
                                                apply_tanh=False)
            v = v - HLR * dw_i
            losses.append(loss_i)
        return v, torch.stack(losses)

    (final, losses), ms = _path(
        "headline_step", train,
        {"fused_step": HSTEPS, "fused_bwd_partial_sum": HSTEPS}, paths)
    ref = w2.double()
    for i in range(HSTEPS):
        ref = ref - HLR * step_f64(pool[i % 2], ref)[1]
    losses = losses.double().cpu().numpy()
    err = float((final.double() - ref).abs().max())
    bar = STEP_RTOL * float(ref.abs().max())
    moved = float((ref - w2.double()).abs().max())
    log("step", path="headline_step", steps=HSTEPS, lr=HLR,
        ms_per_step=f"{ms / HSTEPS:.4f}",
        loss_first=f"{losses[0]:.8e}", loss_last=f"{losses[-1]:.8e}",
        w2_max_abs_err=f"{err:.3e}", bar=f"{bar:.3e}",
        w2_moved=f"{moved:.3e}")
    if not (np.all(np.isfinite(losses)) and err <= bar):
        raise AssertionError(f"headline steps: w2 {err} > {bar}")
    if not losses[-2] < losses[0]:  # same batch as step 0: it must fall
        raise AssertionError(f"headline steps: loss did not fall {losses}")
    return ms


def step_timing_cases(device) -> dict:
    """Phase 12c: per shape, (K5 call, plain call, the K3 + K4 pair's
    step, the torch-ops step, ``step_bound``'s four)."""
    cases = {}
    pool, w = headline_inputs(device)
    x = pool[0]
    w2 = weights_to_m3(w, HN, HK).reshape(-1, HK).contiguous()
    w2_leaf = w2.clone().requires_grad_()
    w_leaf = w.clone().requires_grad_()

    def pair_headline():
        out = kan_layer_fused(x, w2_leaf, HDEG + 1, False)
        return torch.autograd.grad(torch.sum(out**2), [w2_leaf])

    def torch_headline():
        out = qkan_layer_forward_batched(x, w_leaf, HN, HK)
        return torch.autograd.grad(torch.sum(out**2), [w_leaf])

    b, n, dp1, t_dim = HB, HN, HDEG + 1, HK
    cases["headline"] = (
        lambda: kan_train_step_fused(x, w2, dp1, apply_tanh=False),
        lambda: kan_train_step_fused_reference(x, w2, dp1, apply_tanh=False),
        pair_headline, torch_headline,
        step_bound(4.0 * (b * n + 2 * dp1 * n * t_dim + 1),
                   2 * 2.0 * b * n * (dp1 - 1) * t_dim, n, dp1, t_dim),
    )

    rng = np.random.default_rng(SEED + 14)
    b, n = 4096, SHAPE[0]
    xf, w2f = layer_inputs(rng, b, n, True, "high", device)
    y = torch.from_numpy(rng.normal(size=(b, T)).astype(np.float32)).to(device)
    w2f_leaf = w2f.clone().requires_grad_()

    def pair_layer0():
        out = kan_layer_fused(xf, w2f_leaf, DP1)
        return torch.autograd.grad(torch.mean((out - y) ** 2), [w2f_leaf])

    def torch_layer0():
        out = kan_layer_fused_reference(xf, w2f_leaf, DP1)
        return torch.autograd.grad(torch.mean((out - y) ** 2), [w2f_leaf])

    cases["layer0_B4096_mse"] = (
        lambda: kan_train_step_fused(xf, w2f, DP1, y=y, loss="mse"),
        lambda: kan_train_step_fused_reference(xf, w2f, DP1, y=y, loss="mse"),
        pair_layer0, torch_layer0,
        step_bound(4.0 * (b * n + b * T + 2 * DP1 * n * T + 1),
                   2 * 2.0 * b * n * (DP1 - 1) * T, n, DP1, T),
    )

    # the same at T 32
    t32 = 32
    x32, w32 = layer_inputs(rng, b, n, True, "high", device, t32)
    y32 = torch.from_numpy(rng.normal(size=(b, t32)).astype(np.float32))
    y32 = y32.to(device)
    w32_leaf = w32.clone().requires_grad_()

    def pair_t32():
        out = kan_layer_fused(x32, w32_leaf, DP1)
        return torch.autograd.grad(torch.mean((out - y32) ** 2), [w32_leaf])

    def torch_t32():
        out = kan_layer_fused_reference(x32, w32_leaf, DP1)
        return torch.autograd.grad(torch.mean((out - y32) ** 2), [w32_leaf])

    cases["layer0_T32_B4096_mse"] = (
        lambda: kan_train_step_fused(x32, w32, DP1, y=y32, loss="mse"),
        lambda: kan_train_step_fused_reference(x32, w32, DP1, y=y32,
                                               loss="mse"),
        pair_t32, torch_t32,
        step_bound(4.0 * (b * n + b * t32 + 2 * DP1 * n * t32 + 1),
                   2 * 2.0 * b * n * (DP1 - 1) * t32, n, DP1, t32),
    )
    return cases


def device_per_call(fn, calls: int = 10) -> list:
    """(kernel, device µs a call) of ``fn``, largest first, from
    torch.profiler over ``calls`` calls: each kernel's mean time a launch
    times its launches a call, so a launch the profiler drops at the start
    of its window does not count against the call.  A window in which the
    profiler saw no device event is taken again, up to three times."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [(k, u / c * max(1, round(c / calls)))
                  for k, u, c in device_events(prof) if c]
        if events:
            break
    return sorted(events, key=lambda e: -e[1])


def time_step(device, card: str) -> dict:
    """Phase 12c: K5's event ms, device µs and plain ms beside its bound,
    and one step of the K3 + K4 pair and of torch ops, each with its
    device time by kernel, per shape."""
    table = {}
    for shape, (kern, plain, pair, ops, (b_ms, b_by, units, fp32_ms)) in \
            step_timing_cases(device).items():
        times = {k: median_ms(fn, reps=30) for k, fn in (
            ("ms", kern), ("plain_ms", plain), ("pair_ms", pair),
            ("torch_ops_ms", ops))}
        device_us = {}
        for step, fn in (("fused_step", kern), ("pair_k3_k4", pair),
                         ("torch_ops", ops)):
            kernels = device_per_call(fn)
            device_us[step] = sum(us for _, us in kernels) if kernels else None
            log("profile", shape=shape, step=step,
                device_us_call=("not measured" if not kernels
                                else f"{device_us[step]:.3f}"),
                card=f"'{card}'")
            for key, us in kernels[:6]:
                log("profile", shape=shape, step=step, kernel=key[:60],
                    device_us=f"{us:.3f}")
            if step == "fused_step":
                # the call's three kernels: K5, the dW pass, the loss sum
                split = {part: sum(us for k, us in kernels if fn in k) or None
                         for part, fn in (
                             ("step_kernel_us", "fused_step_kernel"),
                             ("dw_pass_us", PASS_KERNEL),
                             ("loss_sum_us", "fused_step_loss_kernel"))}
                log("profile", shape=shape, step=step, **{
                    k: "not measured" if v is None else f"{v:.3f}"
                    for k, v in split.items()})
        table[shape] = dict(
            times, bound_ms=b_ms, bound_by=b_by, bound_units=units,
            bound_fp32_ms=fp32_ms, library_ms=None,
            device_us=split["step_kernel_us"], **split,
            device_us_call=device_us["fused_step"],
            pair_device_us=device_us["pair_k3_k4"],
            torch_ops_device_us=device_us["torch_ops"])
        log("time", kernel="fused_step", shape=shape,
            kernel_ms=f"{times['ms']:.4f}",
            device_us=("not measured" if split["step_kernel_us"] is None
                       else f"{split['step_kernel_us']:.3f}"),
            plain_ms=f"{times['plain_ms']:.4f}",
            pair_k3_k4_ms=f"{times['pair_ms']:.4f}",
            torch_ops_ms=f"{times['torch_ops_ms']:.4f}",
            bound_us=f"{b_ms * 1e3:.3f}", bound_by=b_by,
            bound_units=f"'{units}'", bound_fp32_us=f"{fp32_ms * 1e3:.3f}",
            card=f"'{card}'")
    log("time", note="library_ms null for fused_step: no single PyTorch "
        "call computes the train step")
    return table


def qlayer_cell_inputs(device):
    """Phase 12d's rows x [LAYER_ROWS, 16] uniform in [-1, 1), targets y
    normal, and the layer's weights [8, 256] uniform in [-1, 1), made on
    the card."""
    gen = torch.Generator(device=device).manual_seed(SEED + 14)
    x = torch.rand(LAYER_ROWS, HN, generator=gen, device=device) * 2 - 1
    y = torch.randn(LAYER_ROWS, HK, generator=gen, device=device)
    w = torch.rand(HDEG + 1, HN * HK, generator=gen, device=device) * 2 - 1
    return x, y, w


def run_qlayer_cell(device, paths: dict) -> None:
    """Phase 12d: K5 at the cell's shape against its plain version, then
    one epoch of ``qkan_layer_train`` with the counts at 0."""
    x, y, w = qlayer_cell_inputs(device)
    trainer = QKANLayerTrainer(w, HN, HK, learning_rate=1e-3)
    w2 = trainer.fold(trainer.weights)
    args = (x[:LAYER_B], w2, HDEG + 1, y[:LAYER_B], "mse", False)
    layout = fl.fused_step_layout(LAYER_B, HN, HDEG + 1, HK)
    if layout != (True, 15936, 264):
        raise AssertionError(f"qlayer cell: K5's layout {layout}")
    loss, dw = kan_train_step_fused(*args)
    again = kan_train_step_fused(*args)
    want_loss, want_dw = kan_train_step_fused_reference(*args)
    torch.cuda.synchronize()
    where = dict(case="qlayer_cell", x=f"[{LAYER_B},{HN}]",
                 rows_a_block=layout[1], row_blocks=layout[2])
    held("fused_step.dw", dw, want_dw, "high", **where)
    rel = abs(float(loss) - float(want_loss)) / abs(float(want_loss))
    same = torch.equal(loss, again[0]) and torch.equal(dw, again[1])
    log("kernel", name="fused_step.loss", loss=f"{float(loss):.8e}",
        rel_err=f"{rel:.3e}", bar=STEP_RTOL, same_bits_twice=same, **where)
    if not (loss.shape == () and rel <= STEP_RTOL):
        raise AssertionError(f"qlayer cell: fused_step loss {rel}")
    if not same:
        raise AssertionError("qlayer cell: two K5 calls differ")
    del again, want_loss, want_dw

    steps = LAYER_ROWS // LAYER_B
    record = trainer.record_steps(1)
    qkan_layer_train.steps = 0
    losses, ms = _path(
        "qkan_layer_train",
        lambda: qkan_layer_train(trainer, x, y, LAYER_B),
        {"fused_step": steps, "fused_bwd_partial_sum": steps},
        paths)
    same = (torch.equal(record.losses[0], loss)
            and torch.equal(record.grad, trainer.unfold(dw)))
    log("step", path="qkan_layer_train", rows=LAYER_ROWS, batch=LAYER_B,
        steps=qkan_layer_train.steps, ms_per_step=f"{ms / steps:.4f}",
        losses=" ".join(f"{v:.8e}" for v in losses[0]),
        first_step_bits_of_k5_call=same)
    if qkan_layer_train.steps != steps:
        raise AssertionError(f"qlayer cell: {qkan_layer_train.steps} steps")
    if not (np.all(np.isfinite(losses)) and same):
        raise AssertionError(f"qlayer cell: losses {losses}, first step "
                             f"the kernel's bits: {same}")


# -- phase 13: the batched QKAN layer over M3 (K12-K14) ------------------------

# name in the kernels line -> (TPU kernel, its plan's kind, and its
# device functions: (name, template flags that tell the CUDA-core K13 from
# K14) in the profiler's demangled or mangled names; the first name is the
# tensor-core kernel's, which "m3_fwd_kernel" matches too)
M3_KERNELS = {
    "m3_fwd": ("experimental/pallas_layer.py:60", 0,
               (("m3_fwd_kernel", ()),)),
    "m3_bwd": ("experimental/pallas_layer.py:71", 1,
               (("m3_bwd_kernel_tc", ()), ("m3_bwd_kernel<", ("true>",)),
                ("13m3_bwd_kernelI", ("Lb1E",)))),
    "m3_bwd_dw": ("experimental/pallas_layer.py:198", 2,
                  (("m3_bwd_dw_kernel_tc", ()),
                   ("m3_bwd_kernel<", ("false>",)),
                   ("13m3_bwd_kernelI", ("Lb0E",)))),
}
M3_WIDE = (4096, 16, 128, 8)  # B, N, K, dp1: the N16K128 variant
# the pass tables' rows that the kernels line takes as the passes' own
# numbers: layer 0 at B = 4096 (26 row blocks) and the M3 headline
DW_HEAD = "dW_layer0_B4096"
DM_HEAD = "dM_headline"


def _m3_device_us(kernels: list, name: str) -> tuple:
    """(device µs a call, the units it ran on) of the kernel ``name`` in
    ``device_per_call``'s list, the units read from the device functions'
    names (a ``_tc`` kernel runs on the tensor cores); (None, None) where
    the list holds none of them."""
    mine = [(k, u) for k, u in kernels
            if any(fn in k and (not flags or any(f in k for f in flags))
                   for fn, flags in M3_KERNELS[name][2])]
    if not mine:
        return None, None
    units = {"tensor cores" if "_kernel_tc" in k else "CUDA cores"
             for k, _ in mine}
    if len(units) > 1:
        raise AssertionError(f"{name}: one call ran on both routes {mine}")
    return sum(u for _, u in mine), units.pop()


def m3_route(x, m3, name: str) -> str:
    """The units a call of the kernel ``name`` runs on (``m3_tc_plan``)."""
    kind = M3_KERNELS[name][1]
    dp1, n, k = m3.shape
    tc = pl3.m3_tc_plan(n, dp1, k, kind, x.dtype == torch.bfloat16).ok
    return "tensor cores" if tc else "CUDA cores"


def m3_cases(device) -> list:
    """(name, x, m3, g) at the shapes of phase 13a; g in x's dtype."""
    rng = np.random.default_rng(SEED + 15)
    (hx, _), hw = headline_inputs(device)
    h_m3 = weights_to_m3(hw, HN, HK)
    cases = []

    def add(name, x, m3):
        g = torch.from_numpy(rng.normal(size=(x.shape[0], m3.shape[2]))
                             .astype(np.float32))
        cases.append((name, x, m3, g.to(device, x.dtype)))

    def rand(b, n, k, dp1, lo=-1.0, hi=1.0, x_dtype=torch.float32, w=None):
        x = torch.from_numpy(rng.uniform(lo, hi, (b, n)).astype(np.float32))
        if w is None:  # tests/test_pallas_layer.py's weights
            w = torch.from_numpy((rng.standard_normal((dp1, n * k)) * 0.3)
                                 .astype(np.float32))
        return x.to(device, x_dtype), weights_to_m3(w.to(device), n, k)

    add("headline", hx, h_m3)
    add("headline_bf16_x", hx.to(torch.bfloat16), h_m3)
    b, n, k, dp1 = M3_WIDE
    add(f"N{n}_K{k}_B{b}", *rand(b, n, k, dp1))
    for b, n, k, deg in ((64, 4, 3, 5), (48, 4, 3, 6), (100, 3, 2, 3)):
        add(f"jax_test_B{b}_N{n}_K{k}_deg{deg}", *rand(b, n, k, deg + 1))
    for dp1 in (1, 2):
        add(f"B1_dp1_{dp1}", *rand(1, HN, HK, dp1))
    add("B4096_bf16_x", *rand(4096, HN, HK, HDEG + 1, x_dtype=torch.bfloat16))
    add("B4096_x_in_-2_2", *rand(4096, HN, HK, HDEG + 1, -2.0, 2.0))
    return cases


def check_m3_kernels(device) -> dict:
    """Phase 13a: K12, K13, K14 and the dM pass against their plain
    versions on the card, twice on the same inputs (the same bits), and
    K13's dM partials against K14's bits where both run on the tensor
    cores in the same block layout; returns the worst error of each over
    f32 inputs."""
    worst = dict.fromkeys([*M3_KERNELS, "m3_dm_sum"], 0.0)
    for name, x, m3, g in m3_cases(device):
        def run():
            dx, part13, _ = pl3._bwd_pass(x, m3, g, True)
            _, part14, _ = pl3._bwd_pass(x, m3, g, False)
            return (qkan_layer_fused(x, m3), dx, pl3.m3_dm_partial_sum(part13),
                    pl3.m3_dm_partial_sum(part14), part14, part13)

        got, again = run(), run()
        want_out = qkan_layer_fused_reference(x, m3)
        want_dx, want_dm = qkan_layer_fused_bwd_reference(x, m3, g, True)
        want_sum = pl3.m3_dm_partial_sum_reference(got[4])
        torch.cuda.synchronize()
        same = all(torch.equal(a, c) for a, c in zip(got, again))
        where = dict(case=name, x=f"[{x.shape[0]},{x.shape[1]}]",
                     m3=f"[{m3.shape[0]},{m3.shape[1]},{m3.shape[2]}]",
                     dtype=str(x.dtype).split(".")[-1], same_bits_twice=same,
                     routes="'" + ", ".join(
                         f"{k} {m3_route(x, m3, k)}" for k in M3_KERNELS)
                     + "'")
        errs = {
            "m3_fwd": held("m3_fwd.out", got[0], want_out, "high", **where),
            "m3_bwd": max(held("m3_bwd.dx", got[1], want_dx, "high", **where),
                          held("m3_bwd.dm", got[2], want_dm, "high", **where)),
            "m3_bwd_dw": held("m3_bwd_dw.dm", got[3], want_dm, "high",
                              **where),
            "m3_dm_sum": held("m3_dm_sum", pl3.m3_dm_partial_sum(got[4]),
                              want_sum, "high", **where),
        }
        if not same:
            raise AssertionError(f"m3 kernels {name}: two runs differ")
        b, (dp1, n, k) = x.shape[0], m3.shape
        if (m3_route(x, m3, "m3_bwd") == m3_route(x, m3, "m3_bwd_dw")
                == "tensor cores" and pl3.m3_bwd_layout(b, n, dp1, k, True)
                == pl3.m3_bwd_layout(b, n, dp1, k, False)):
            bits = torch.equal(got[5], got[4])
            log("kernel", check="m3_bwd_dm_partials_vs_k14", case=name,
                bit_equal=bits)
            if not bits:
                raise AssertionError(f"m3_bwd {name}: K13's dM partials "
                                     "are not K14's bits")
        if x.dtype == torch.float32:
            for k, (err, _) in errs.items():
                worst[k] = max(worst[k], err)
    log("kernel", check="m3_worst_f32", **{k: f"{v:.3e}" for k, v in worst.items()})
    return worst


def check_m3_batch_bits(device) -> None:
    """Phase 13a: K12's first 37 rows of out and K13's of dx have the same
    bits at B 37, 4096 and 262144 (the headline; 37 and 4096 at N16
    K128)."""
    (hx, _), hw = headline_inputs(device)
    rng = np.random.default_rng(SEED + 20)
    b, n, k, dp1 = M3_WIDE
    wide = torch.from_numpy(rng.normal(0, 1 / np.sqrt(dp1 * n), (dp1, n, k))
                            .astype(np.float32)).to(device)
    for m3, batches in ((weights_to_m3(hw, HN, HK), (37, 4096, HB)),
                        (wide, (37, b))):
        g = torch.from_numpy(rng.normal(size=(batches[-1], m3.shape[2]))
                             .astype(np.float32)).to(device)
        for name, fn in (
                ("m3_fwd", lambda bb: qkan_layer_fused(
                    hx[:bb].contiguous(), m3)),
                ("m3_bwd", lambda bb: pl3._bwd_pass(
                    hx[:bb].contiguous(), m3, g[:bb].contiguous(),
                    True)[0])):
            full = fn(batches[-1])
            same = {bb: torch.equal(fn(bb)[:37], full[:37])
                    for bb in batches[:-1]}
            torch.cuda.synchronize()
            log("kernel", check=f"{name}_rows_0_36_across_B",
                m3=f"[{m3.shape[0]},{m3.shape[1]},{m3.shape[2]}]",
                batches="/".join(map(str, batches)),
                route=f"'{m3_route(hx, m3, name)}'",
                bit_equal=all(same.values()))
            if not all(same.values()):
                raise AssertionError(f"{name}: rows 0-36 differ across B "
                                     f"{same}")


def m3_chain_f64(x, w, x_grad: bool = False):
    """(loss, grad_w) or (loss, grad_x, grad_w) of sum(out^2) by float64
    autograd, out the fold of w over the UNCLIPPED basis of x."""
    w64 = w.detach().double().requires_grad_()
    x64 = x.detach().double().requires_grad_(x_grad)
    m2 = weights_to_m3(w64, HN, HK).reshape(-1, HK)
    bas = chebyshev_basis(x64, HDEG, clip=False)
    out = bas.transpose(1, 2).reshape(x.shape[0], -1) @ m2
    loss = torch.sum(out**2)
    grads = torch.autograd.grad(loss, [x64, w64] if x_grad else [w64])
    return (loss.detach(), *grads)


def _scaled_check(name: str, got, want, **fields) -> None:
    err = float((got.double() - want).abs().max())
    bar = STEP_RTOL * float(want.abs().max())
    log("m3", check=name, max_abs_err=f"{err:.3e}", bar=f"{bar:.3e}",
        **fields)
    if not err <= bar:
        raise AssertionError(f"{name}: {err} > {bar}")


def m3_step(x, w):
    """One fwd+bwd of the chain: (loss, grad_w) through
    ``qkan_layer_forward_batched_fused`` with x as data."""
    leaf = w.detach().requires_grad_()
    loss = torch.sum(qkan_layer_forward_batched_fused(x, leaf, HN, HK) ** 2)
    (gw,) = torch.autograd.grad(loss, [leaf])
    return loss.detach(), gw


def run_m3_chain(device, paths: dict) -> float:
    """Phase 13b: bench.py's headline chain in torch, w <- w - lr grad_w
    sum(qkan_layer_forward_batched_fused(x_i, w)^2) for HSTEPS steps on the
    rotating pool, held to float64 autograd; then one fwd+bwd in both
    arguments.  Returns the chain's host ms."""
    pool, w = headline_inputs(device)
    loss, gw = m3_step(pool[0], w)
    loss64, gw64 = m3_chain_f64(pool[0], w)
    rel = abs(float(loss) - float(loss64)) / float(loss64)
    log("m3", check="start_loss_vs_float64_autograd", loss=f"{float(loss):.8e}",
        loss_rel=f"{rel:.3e}", bar=STEP_RTOL)
    if not rel <= STEP_RTOL:
        raise AssertionError(f"m3 chain start loss: {rel}")
    _scaled_check("start_grad_w_vs_float64_autograd", gw, gw64)

    def train():
        v, losses = w, []
        for i in range(HSTEPS):
            loss_i, gw_i = m3_step(pool[i % 2], v)
            v = v - HLR * gw_i
            losses.append(loss_i)
        return v, torch.stack(losses)

    (final, losses), ms = _path(
        "m3_chain", train,
        {"m3_fwd": HSTEPS, "m3_bwd_dw": HSTEPS, "m3_dm_sum": HSTEPS}, paths)
    ref = w.double()
    for i in range(HSTEPS):
        ref = ref - HLR * m3_chain_f64(pool[i % 2], ref)[1]
    losses = losses.double().cpu().numpy()
    moved = float((ref - w.double()).abs().max())
    err = float((final.double() - ref).abs().max())
    log("m3", path="m3_chain", steps=HSTEPS, lr=HLR,
        ms_per_step=f"{ms / HSTEPS:.4f}", loss_first=f"{losses[0]:.8e}",
        loss_last=f"{losses[-1]:.8e}", w_moved=f"{moved:.3e}")
    _scaled_check("final_w_vs_float64_steps", final, ref)
    if not (np.all(np.isfinite(losses)) and losses[-2] < losses[0]):
        raise AssertionError(f"m3 chain: loss did not fall {losses}")
    if not moved > 10 * err:  # the steps moved w by far more than the gap
        raise AssertionError(f"m3 chain: w moved {moved}, gap {err}")

    def both():
        xl = pool[0].clone().requires_grad_()
        wl = w.clone().requires_grad_()
        out = qkan_layer_forward_batched_fused(xl, wl, HN, HK)
        return torch.autograd.grad(torch.sum(out**2), [xl, wl])

    (gx, gw), _ = _path("m3_both_args", both,
                        {"m3_fwd": 1, "m3_bwd": 1, "m3_dm_sum": 1}, paths)
    _, gx64, gw64 = m3_chain_f64(pool[0], w, x_grad=True)
    _scaled_check("both_args_dx_vs_float64_autograd", gx, gx64)
    _scaled_check("both_args_grad_w_vs_float64_autograd", gw, gw64)
    return ms


def m3_timing_cases(device, b, n, k, dp1, timed: bool = True) -> tuple:
    """Each kernel at one shape, f32: name -> (kernel call, plain call, one
    PyTorch call or None, ``unit_bound`` on the units of the call's route:
    (bound ms, what bounds it, the units, the FP32 bound ms)); and the
    inputs (only those where ``timed`` is false)."""
    rng = np.random.default_rng(SEED + 16)
    if (b, n, k, dp1) == (HB, HN, HK, HDEG + 1):
        (x, _), w = headline_inputs(device)
        m3 = weights_to_m3(w, n, k)
    else:
        x = torch.from_numpy(rng.uniform(-1, 1, (b, n)).astype(np.float32))
        m3 = torch.from_numpy(rng.normal(0, 1 / np.sqrt(dp1 * n), (dp1, n, k))
                              .astype(np.float32))
        x, m3 = x.to(device), m3.to(device)
    if not timed:
        return None, x, m3
    g = torch.from_numpy(rng.normal(size=(b, k)).astype(np.float32)).to(device)
    mm = 2.0 * b * n * (dp1 - 1) * k  # flops of one contraction
    x_b, m_b, bk_b = 4.0 * b * n, 4.0 * dp1 * n * k, 4.0 * b * k

    def ub(name, nbytes, flops):  # on the units the call's route uses
        return unit_bound(nbytes, flops,
                          m3_route(x, m3, name) == "tensor cores")

    cases = {
        "m3_fwd": (lambda: qkan_layer_fused(x, m3),
                   lambda: qkan_layer_fused_reference(x, m3),
                   None, ub("m3_fwd", x_b + m_b + bk_b, mm)),
        "m3_bwd": (lambda: pl3._bwd_pass(x, m3, g, True),
                   lambda: qkan_layer_fused_bwd_reference(x, m3, g, True),
                   None, ub("m3_bwd", 2 * x_b + 2 * m_b + bk_b, 2 * mm)),
        "m3_bwd_dw": (lambda: pl3._bwd_pass(x, m3, g, False),
                      lambda: qkan_layer_fused_bwd_reference(x, m3, g, False),
                      None, ub("m3_bwd_dw", x_b + m_b + bk_b, mm)),
    }
    return cases, x, m3


def time_m3(device, card: str, step_table: dict) -> dict:
    """Phase 13c: each kernel's event ms, device µs, plain ms and bound at
    the headline shape and at N16/K128/B4096; then one K12 + K14 step at
    the headline (from the weights, from an M3 leaf) and one K12 + K13
    step in both arguments, with their device time by kernel, beside phase
    12c's K5 step, the K3 + K4 pair and torch ops."""
    table = {}
    for shape in ((HB, HN, HK, HDEG + 1), M3_WIDE):
        b, n, k, dp1 = shape
        tag = f"B{b}_N{n}_K{k}_dp1_{dp1}"
        cases, x, m3 = m3_timing_cases(device, *shape)
        for name, (kern, plain, lib, (b_ms, b_by, units, fp32_ms)) in \
                cases.items():
            k_ms = median_ms(kern, reps=30)
            p_ms = median_ms(plain, reps=30)
            l_ms = median_ms(lib, reps=30) if lib is not None else None
            dev, route = _m3_device_us(device_per_call(kern), name)
            if route != m3_route(x, m3, name):
                raise AssertionError(
                    f"{name} {tag}: ran on {route}, its plan says "
                    f"{m3_route(x, m3, name)}")
            table[(name, tag)] = dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                                      bound_ms=b_ms, bound_by=b_by,
                                      bound_units=units,
                                      bound_fp32_ms=fp32_ms, device_us=dev,
                                      kernel_route=route)
            log("time", kernel=name, shape=tag, route=f"'{route}'",
                kernel_ms=f"{k_ms:.4f}",
                device_us="not measured" if dev is None else f"{dev:.3f}",
                plain_ms=f"{p_ms:.4f}",
                library_ms="null" if l_ms is None else f"{l_ms:.4f}",
                bound_us=f"{b_ms * 1e3:.3f}", bound_by=b_by,
                bound_units=f"'{units}'",
                bound_fp32_us=f"{fp32_ms * 1e3:.3f}", card=f"'{card}'")
    log("time", note="library_ms null for m3_fwd, m3_bwd, m3_bwd_dw: no "
        "single PyTorch call computes the basis and the contraction")

    # one step at the headline: from the weights (the fold, K12, K14 and
    # the dM pass) and from an M3 leaf (as K5 takes its folded w2)
    pool, w = headline_inputs(device)
    x = pool[0]
    m3_leaf = weights_to_m3(w, HN, HK).requires_grad_()

    def step_m3():
        out = qkan_layer_fused(x, m3_leaf)
        return torch.autograd.grad(torch.sum(out**2), [m3_leaf])

    def step_both():  # 13b's step in both arguments: K12, K13 and P2
        xl = x.clone().requires_grad_()
        wl = w.clone().requires_grad_()
        out = qkan_layer_forward_batched_fused(xl, wl, HN, HK)
        return torch.autograd.grad(torch.sum(out**2), [xl, wl])

    k5 = step_table["headline"]
    for step, fn in (("m3_step_from_w", lambda: m3_step(x, w)),
                     ("m3_step_from_m3", step_m3),
                     ("m3_step_both_args", step_both)):
        ms = median_ms(fn, reps=30)
        kernels = device_per_call(fn)
        dev = sum(us for _, us in kernels) if kernels else None
        table[step] = dict(ms=ms, device_us_call=dev)
        log("profile", shape="headline", step=step, ms=f"{ms:.4f}",
            device_us_call="not measured" if dev is None else f"{dev:.3f}",
            k5_ms=f"{k5['ms']:.4f}", k5_device_us_call=k5["device_us_call"],
            pair_k3_k4_ms=f"{k5['pair_ms']:.4f}",
            pair_device_us=k5["pair_device_us"],
            torch_ops_ms=f"{k5['torch_ops_ms']:.4f}",
            torch_ops_device_us=k5["torch_ops_device_us"], card=f"'{card}'")
        for key, us in kernels[:8]:
            log("profile", shape="headline", step=step, kernel=key[:60],
                device_us=f"{us:.3f}")
    return table


def time_backwards(device, card: str) -> dict:
    """Phase 13c: each producer with its pass in one library call (K14 +
    dM, K13 + dM at the M3 headline; K2 + dW at layer 0, B = 4096, and at
    the train step's layer 0, B = 64, where the step is host-bound; K5 +
    dW at the headline step), first held to the bits of the producer
    followed by the pass alone.  Both routes go through the same wrapper
    (``_bwd_pass`` / ``_step_pass``, with and without ``finish``): their
    event ms and host µs a call, each timed in turns, and the one call's
    device µs by kernel."""
    (x, _), w = headline_inputs(device)
    m3 = weights_to_m3(w, HN, HK)
    w2 = m3.reshape(-1, HK).contiguous()
    rng = np.random.default_rng(SEED + 18)
    g = torch.from_numpy(rng.normal(size=(HB, HK)).astype(np.float32))
    g = g.to(device)
    dp1 = HDEG + 1

    def m3_pair(want_dx):
        return (lambda: pl3._bwd_pass(x, m3, g, want_dx, finish=True)[2],
                lambda: pl3.m3_dm_partial_sum(
                    pl3._bwd_pass(x, m3, g, want_dx)[1]))

    def k2_pair(b, t_dim, want_dx):
        xf = torch.from_numpy(rng.uniform(-2, 2, (b, SHAPE[0]))
                              .astype(np.float32)).to(device)
        w2f = torch.from_numpy(rng.normal(0, 0.05, (DP1 * SHAPE[0], t_dim))
                               .astype(np.float32)).to(device)
        gf = torch.from_numpy(rng.normal(size=(b, t_dim))
                              .astype(np.float32)).to(device)
        args = ("qkan_fused_dw_bwd", xf, w2f, gf, DP1, True, (0,), want_dx)
        return (lambda: _bwd_pass(*args, finish=True)[2],
                lambda: fused_bwd_partial_sum(_bwd_pass(*args)[1], b,
                                              SHAPE[0], DP1, t_dim, want_dx))

    calls = {
        "k14_dm": m3_pair(False),
        "k13_dm": m3_pair(True),
        "k2_dw_layer0_B4096": k2_pair(4096, T, True),
        "k2_dw_train_layer0_B64": k2_pair(TRAIN_BATCH, SHAPE[1], False),
        "k5_dw": (lambda: _step_pass(x, w2, dp1, None, "sumsq", False,
                                     finish=True)[2],
                  lambda: fused_bwd_partial_sum(
                      _step_pass(x, w2, dp1, None, "sumsq", False)[1], HB, HN,
                      dp1, HK, step=True)),
    }
    table = {}
    for name, (one, two) in calls.items():
        got, want = one(), two()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: one call differs from the "
                                 "producer and the pass alone")
        one_ms, two_ms = paired_ms(one, two)
        one_host, two_host = paired_host_us(one, two)
        kernels = device_per_call(one)
        row = dict(ms=one_ms, two_calls_ms=two_ms, host_us=one_host,
                   two_calls_host_us=two_host,
                   device_us_call=sum(us for _, us in kernels),
                   device_us_by_kernel={k[:60]: us for k, us in kernels})
        table[name] = row
        log("time", backward=name, one_call_ms=f"{row['ms']:.4f}",
            two_calls_ms=f"{row['two_calls_ms']:.4f}",
            one_call_host_us=f"{one_host:.1f}",
            two_calls_host_us=f"{two_host:.1f}",
            device_us_call=f"{row['device_us_call']:.3f}", card=f"'{card}'")
        for key, us in kernels[:4]:
            log("profile", backward=name, kernel=key[:60],
                device_us=f"{us:.3f}")
    table["train_step_B64"] = time_step_backward_routes(card)
    return table


def time_step_backward_routes(card: str) -> dict:
    """Phase 13c, end to end where the host sets the pace: the flagship's
    forward and backward at batch 64 through autograd (4 K1, 4 K2 with
    their dW passes; layer 0 without dx), 30 steps back to back a window.
    The backwards take the pass in the producer's call, or as a call of
    its own (``fused_layer._launch_bwd`` swapped for the two-call route);
    windows in turns, ms a step for each; the two routes' gradients are
    first held to the same bits."""
    rng = np.random.default_rng(SEED + 19)
    x = torch.from_numpy(rng.uniform(-1, 1, (TRAIN_BATCH, SHAPE[0]))
                         .astype(np.float32)).to("cuda")
    ws = [torch.from_numpy(rng.normal(0, 1 / np.sqrt(DP1 * n), (DP1 * n, t))
                           .astype(np.float32)).to("cuda").requires_grad_()
          for n, t in zip(SHAPE[:-1], SHAPE[1:])]

    def step():
        h = x
        for w in ws:
            h = kan_layer_fused_dw(h, w, DP1)
        return torch.autograd.grad(torch.sum(h * h), ws)

    one = fl._launch_bwd

    def two(entry, xx, w2, g, dp1, apply_tanh, extra, want_dx):
        dx, wsp, _ = _bwd_pass(entry, xx, w2, g, dp1, apply_tanh, extra,
                               want_dx)
        return dx, fused_bwd_partial_sum(
            wsp, xx.shape[0], xx.shape[1], dp1, w2.shape[1], want_dx,
            x_bf16=xx.dtype == torch.bfloat16,
            round_bf16=bool(extra and extra[0]))

    def window(route, steps: int = 30):
        fl._launch_bwd = route
        try:
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(steps):
                grads = step()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / steps, grads
        finally:
            fl._launch_bwd = one

    _, g_one = window(one, 3)
    _, g_two = window(two, 3)
    if not all(torch.equal(a, b) for a, b in zip(g_one, g_two)):
        raise AssertionError("train step B64: the two backward routes differ")
    times = {"one_call": [], "two_calls": []}
    for i in range(8):
        for name in (("one_call", "two_calls") if i % 2 == 0
                     else ("two_calls", "one_call")):
            times[name].append(window(one if name == "one_call" else two)[0])
    row = {k: float(np.median(v)) for k, v in times.items()}
    log("time", backward="train_step_B64", one_call_ms_a_step=
        f"{row['one_call']:.4f}", two_calls_ms_a_step=f"{row['two_calls']:.4f}",
        windows=len(times["one_call"]), card=f"'{card}'")
    return row


# -- phase 14: the sharded statevector and the fused exchange (K11) -------------

SLOTS = 8  # the JAX tests' mesh, as 8 slots on one card
EXCHANGE_HALVES = (1, 2**10, 2**20, 2**23)  # M: 2^23 is the 27-qubit slot
EXCHANGE_BITS = (0, 1, 2)
SHARD_IMPLS = ("rdma", "collective", "all_to_all")
# launches of one sharded FABLE-diagonal run (17 or 27 qubits on 8 slots):
# 'rdma' fuses the first H wall's two global qubits and the global-target
# ucry into K11 (one launch a slot each); the collective routes exchange
# and rotate at the local MSB with K8
SHARD_LAUNCHES = {"rdma": {"exchange_ucry": SLOTS, "exchange_h": 2 * SLOTS},
                  "collective": {"ucry": SLOTS},
                  "all_to_all": {"ucry": SLOTS}}


def _slot_blocks(gen, m: int, dtype, device) -> list:
    return [torch.randn(2 * m, generator=gen, device=device, dtype=dtype)
            for _ in range(SLOTS)]


def _exchange_plain(gate, blocks, cs, sn, dev_bit):
    """K11's plain version on every slot (the partner's half read in
    place: all slots sit on one card)."""
    m = blocks[0].shape[0] // 2
    out = []
    for d in range(SLOTS):
        g = (d >> dev_bit) & 1
        kept = blocks[d][g * m:(g + 1) * m]
        received = blocks[d ^ (1 << dev_bit)][g * m:(g + 1) * m]
        out.append(rdma.ucry_exchange_reference(kept, received, cs[d], sn[d],
                                                g)
                   if gate == "ucry" else
                   rdma.h_exchange_reference(kept, received, g))
    return out


def _exchange_kernel(gate, blocks, cs, sn, dev_bit):
    if gate == "ucry":
        return rdma.ucry_exchange_fused_rdma(blocks, cs, sn, dev_bit)
    return rdma.h_exchange_fused_rdma(blocks, dev_bit)


def _slots_err(got: list, want: list, dtype) -> float:
    """max over slots of |kernel - plain| over its bar (phase 9's)."""
    torch.cuda.synchronize()
    worst = 0.0
    for g, w in zip(got, want):
        if (g.shape != w.shape or g.dtype != w.dtype
                or not bool(torch.isfinite(g).all())):
            raise AssertionError("K11: bad output")
        bar = SV_BAR[dtype] * max(float(w.abs().max()), 1e-300)
        worst = max(worst, float((g - w).abs().max()) / bar)
    return worst


def check_exchange_kernel(device) -> float:
    """Phase 14a: K11 (both gates) against its plain version on 8 slots of
    the card: f32 and f64, every dev_bit of the mesh, half blocks M in
    EXCHANGE_HALVES, forward (twice: the same bits) and the backward of
    sum(out^3) through the autograd Function against autograd through the
    plain version.  Returns the worst |kernel - plain|."""
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 14)
    worst_abs = 0.0
    for m in EXCHANGE_HALVES:
        for dtype in (torch.float32, torch.float64):
            ratios = {}
            for dev_bit in EXCHANGE_BITS:
                blocks = _slot_blocks(gen, m, dtype, device)
                th = [torch.rand(m, generator=gen, device=device,
                                 dtype=dtype) * (2 * np.pi)
                      for _ in range(SLOTS)]
                cs = [torch.cos(t / 2) for t in th]
                sn = [torch.sin(t / 2) for t in th]
                del th
                for gate in ("ucry", "h"):
                    got = _exchange_kernel(gate, blocks, cs, sn, dev_bit)
                    want = _exchange_plain(gate, blocks, cs, sn, dev_bit)
                    fwd = _slots_err(got, want, dtype)
                    again = _exchange_kernel(gate, blocks, cs, sn, dev_bit)
                    torch.cuda.synchronize()
                    if not all(torch.equal(a, b) for a, b in zip(got, again)):
                        raise AssertionError(f"K11 {gate}: other bits on a "
                                             "second run")
                    worst_abs = max(worst_abs, max(
                        float((g - w).abs().max()) for g, w in zip(got, want)))
                    # the VJP recovers the pre-rotation pair from the
                    # saved outputs, so d cos / d sin carry a rounding of
                    # |g| |out| (g = 3 out^2) where autograd of the plain
                    # version multiplies the inputs: their bar scales
                    # with that product
                    term = [3.0 * float(w.abs().max()) ** 3 for w in want]
                    del got, want, again
                    bwd = []
                    for fn in (_exchange_kernel, _exchange_plain):
                        leaves = [t.detach().requires_grad_()
                                  for t in (*blocks, *cs, *sn)]
                        lb = leaves[:SLOTS]
                        lc, ls = leaves[SLOTS:2 * SLOTS], leaves[2 * SLOTS:]
                        outs = fn(gate, lb, lc, ls, dev_bit)
                        used = leaves if gate == "ucry" else lb
                        bwd.append(torch.autograd.grad(
                            sum((o**3).sum() for o in outs), used))
                        del outs, leaves, lb, lc, ls
                    got_g, want_g = bwd
                    bwd_ratio = _slots_err(list(got_g[:SLOTS]),
                                           list(want_g[:SLOTS]), dtype)
                    for k, (g, w) in enumerate(zip(got_g[SLOTS:],
                                                   want_g[SLOTS:])):
                        bwd_ratio = max(bwd_ratio, float((g - w).abs().max())
                                        / (SV_BAR[dtype] * term[k % SLOTS]))
                    ratios[f"{gate}[bit {dev_bit}]"] = (fwd, bwd_ratio)
                    del bwd, got_g, want_g
                del blocks, cs, sn
            torch.cuda.empty_cache()
            log("exchange", check="K11_vs_plain", slots=SLOTS, half=m,
                float=str(dtype).split(".")[-1], same_bits_twice=True,
                err_over_bar_fwd_bwd={k: f"{f:.3f}/{b:.3f}"
                                      for k, (f, b) in ratios.items()})
            if not all(f <= 1.0 and b <= 1.0 for f, b in ratios.values()):
                raise AssertionError(f"K11 over its bar at M={m}: {ratios}")
    return worst_abs


def run_sharded_layer(device, mesh8, paths: dict) -> dict:
    """Phase 14b: the quantum layer of phase 10a with its block encoding
    on 8 slots of the card, every exchange_impl, f32 and f64, forward and
    the gradient of sum(out^2) in x and w, against the single-card
    ``qkan_layer_forward_quantum``; returns host ms by path."""
    from qkan_implementation_tpu_torch.ops.quantum import (
        _diag_circuit_template,
        qkan_layer_forward_quantum,
        qkan_layer_forward_quantum_sharded,
    )

    rng = np.random.default_rng(SEED + 14)
    x_np = rng.uniform(-0.9, 0.9, QN)
    w_np = rng.uniform(-0.9, 0.9, (QDEG + 1, QN * QK))
    n = int(np.log2(QN * QK))
    circ, _ = _diag_circuit_template(n)
    counted = count_exchanges(circ, SLOTS)
    times = {}

    def fwd_bwd(forward, dtype):
        x = _on(device, x_np, dtype).requires_grad_()
        w = _on(device, w_np, dtype).requires_grad_()
        out = forward(x, w)
        gx, gw = torch.autograd.grad((out**2).sum(), [x, w])
        return out.detach(), gx, gw

    for dtype in (torch.float32, torch.float64):
        dt = str(dtype).split(".")[-1]
        want = fwd_bwd(lambda x, w: qkan_layer_forward_quantum(x, w, QN, QK),
                       dtype)
        for impl in SHARD_IMPLS:
            name = f"sharded_layer_{impl}_{dt}"
            fwd_bwd(lambda x, w: qkan_layer_forward_quantum_sharded(
                x, w, QN, QK, mesh8, exchange_impl=impl), dtype)  # warm
            got, times[name] = _path(name, lambda: fwd_bwd(
                lambda x, w: qkan_layer_forward_quantum_sharded(
                    x, w, QN, QK, mesh8, exchange_impl=impl), dtype),
                SHARD_LAUNCHES[impl], paths)
            if got[0].shape != (QK,):
                raise AssertionError(f"{name}: shape {tuple(got[0].shape)}")
            state = sharded_simulate(circ, mesh8, dtype=dtype,
                                     exchange_impl=impl)
            for part, g, w in zip(("out", "dx", "dw"), got, want):
                _bar_check(f"{name}_{part}_vs_single_card",
                           float((g - w).abs().max()), QLAYER_BAR[dtype],
                           max_abs=f"{float(w.abs().max()):.3e}")
            k11 = {k: paths[name][k] for k in ("exchange_ucry", "exchange_h")}
            log("sharded", path=name, qubits=2 * n + 1,
                q_local=2 * n + 1 - 3, k11_launches=k11,
                count_exchanges=counted,
                layout_exchanges=state.exchange_count)
            if (sum(k11.values()) > 0) != (impl == "rdma"):
                raise AssertionError(f"{name}: K11 launches {k11}")
            # the dry walk counts the collective schedule; 'rdma' parks the
            # fused qubits at the local MSB, where the second H wall finds
            # them local
            if impl != "rdma" and state.exchange_count != counted:
                raise AssertionError(f"{name}: {state.exchange_count} "
                                     f"exchanges, count_exchanges {counted}")
            del state
    return times


def _device_breakdown(fn, calls: int = 3) -> list:
    """(kernel, device µs a call, launches a call) of ``fn``, largest
    first, from torch.profiler over ``calls`` calls: each kernel's mean
    time a launch times its launches a call (as ``device_per_call``), so
    launches the profiler drops at the start of its window do not count
    against the call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = []
    for k, u, c in device_events(prof):
        if c:
            per_call = max(1, round(c / calls))
            out.append((k, u / c * per_call, per_call))
    return sorted(out, key=lambda e: -e[1])


def run_sharded_scale(device, mesh8, paths: dict, card: str) -> dict:
    """Phase 14c: the 2^13 diagonal of phase 10d through the packed
    extraction on 8 slots of the card (27 qubits, 64 MB a slot in f32),
    'rdma' and 'collective', against the single-card packed extraction;
    returns host ms, event ms and device µs by route."""
    from qkan_implementation_tpu_torch.ops.quantum import (
        _diag_angles,
        _diag_circuit_template,
        packed_initial_shards,
        quantum_extract_diag_packed,
        quantum_extract_diag_packed_sharded,
    )

    size = 2**SCALE_N
    diag_np = np.random.default_rng(0).uniform(-1, 1, size)
    diag = _on(device, diag_np, torch.float32)
    alpha = max(1.0, float(np.abs(diag_np).max()) * (1 + 32 * 2.0**-23))
    bar = 5e-4 * max(1.0, alpha)
    with torch.no_grad():
        single = quantum_extract_diag_packed(diag)
        table, got = {}, {}
        for impl in ("rdma", "collective"):
            name = f"sharded_extract_27q_{impl}"
            quantum_extract_diag_packed_sharded(diag, mesh8,
                                                exchange_impl=impl)  # warm
            got[impl], host_ms = _path(
                name, lambda: quantum_extract_diag_packed_sharded(
                    diag, mesh8, exchange_impl=impl),
                SHARD_LAUNCHES[impl], paths)
            _bar_check(f"{name}_vs_single_card",
                       float((got[impl] - single).abs().max()), bar,
                       vs_diag=f"{float((got[impl] - diag).abs().max()):.3e}",
                       single_card_vs_diag=(
                           f"{float((single - diag).abs().max()):.3e}"),
                       entries=size, alpha=f"{alpha:.6f}")

            def call(impl=impl):
                return quantum_extract_diag_packed_sharded(
                    diag, mesh8, exchange_impl=impl)

            event_ms = median_ms(call, reps=5, warm=1)
            kernels = _device_breakdown(call)
            busy = sum(u for _, u, _ in kernels)
            k11_us = sum(u for k, u, _ in kernels if "exchange_" in k)
            table[impl] = dict(host_ms=host_ms, event_ms=event_ms,
                               device_us=busy, k11_device_us=k11_us)
            log("sharded", path=name, host_ms=f"{host_ms:.4f}",
                event_ms=f"{event_ms:.4f}", device_ms=f"{busy / 1e3:.4f}",
                k11_launches=paths[name]["exchange_ucry"]
                + paths[name]["exchange_h"], card=f"'{card}'")
            for key, us, count in kernels[:8]:
                log("sharded", path=name, kernel=key[:70],
                    device_us=f"{us:.3f}", launches=f"{count:g}")
        gap = float((got["rdma"] - got["collective"]).abs().max())
        log("sharded", check="extract_27q_rdma_vs_collective",
            max_abs_gap=f"{gap:.3e}")
        flat, _ = _diag_angles(diag)
        circ, idx = _diag_circuit_template(SCALE_N)
        state = sharded_simulate(
            circ, mesh8, psi0=packed_initial_shards(size, mesh8,
                                                    torch.float32),
            dtype=torch.float32, exchange_impl="rdma",
            runtime_params={idx: flat})
        report = shard_memory_report(state)
        log("sharded", check="shard_memory_report_27q", **report)
        if not (report["balanced"] and report["max_bytes_per_device"]
                == 2 ** (2 * SCALE_N + 1) * 4 // SLOTS):
            raise AssertionError(f"27-qubit shards: {report}")
        del state, flat
    torch.cuda.empty_cache()
    return table


def time_exchange(device, card: str) -> tuple[dict, float]:
    """Phase 14d: K11 at the 27-qubit shape (8 slots of 2^24 f32
    amplitudes, dev_bit 2): event ms, device µs and plain ms of one
    exchange (8 launches) beside its bound, and the collective path for
    the same exchange and gate (``pairwise_exchange`` at the local MSB,
    then K6 or K10 on each slot).  Returns the table and the worst
    |kernel - plain|."""
    from qkan_implementation_tpu_torch.sim.sharded import (
        _exchange_global_local,
    )

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 15)
    m = EXCHANGE_HALVES[-1]
    q_local, dev_bit = m.bit_length(), 2
    n = SLOTS * 2 * m
    blocks = _slot_blocks(gen, m, torch.float32, device)
    th = [torch.rand(m, generator=gen, device=device) * (2 * np.pi)
          for _ in range(SLOTS)]
    cs = [torch.cos(t / 2) for t in th]
    sn = [torch.sin(t / 2) for t in th]
    del th

    def collective(gate):
        moved = _exchange_global_local(blocks, dev_bit, q_local - 1)
        if gate == "ucry":
            return [pk.ucry_msb_cs_pallas_pair(b, c, s)
                    for b, c, s in zip(moved, cs, sn)]
        return [pk.h_gate_pallas(b, q_local - 1) for b in moved]

    table, worst = {}, 0.0
    for gate, (b_ms, b_by) in (("ucry", bound(12.0 * n, 3.0 * n)),
                               ("h", bound(8.0 * n, 2.0 * n))):
        kern = lambda gate=gate: _exchange_kernel(gate, blocks, cs, sn,
                                                  dev_bit)
        plain = lambda gate=gate: _exchange_plain(gate, blocks, cs, sn,
                                                  dev_bit)
        coll = lambda gate=gate: collective(gate)
        got, want, other = kern(), plain(), coll()
        ratio = max(_slots_err(got, want, torch.float32),
                    _slots_err(other, want, torch.float32))
        if ratio > 1.0:
            raise AssertionError(f"K11 {gate} at 27 qubits: {ratio}")
        worst = max(worst, max(float((g - w).abs().max())
                               for g, w in zip(got, want)))
        del got, want, other
        row = dict(ms=median_ms(kern, reps=20, warm=3),
                   plain_ms=median_ms(plain, reps=20, warm=3),
                   collective_ms=median_ms(coll, reps=20, warm=3),
                   bound_ms=b_ms, bound_by=b_by, library_ms=None)
        k_us = [u for k, u, _ in _device_breakdown(kern, 10)
                if "exchange_" in k]
        row["device_us"] = sum(k_us) if k_us else None
        row["collective_device_us"] = sum(
            u for _, u, _ in _device_breakdown(coll, 10))
        table[gate] = row
        log("time", kernel=f"exchange_{gate}",
            state=f"{SLOTS} slots x 2^24 f32 (27 qubits)",
            kernel_ms=f"{row['ms']:.4f}",
            device_us="not measured" if row["device_us"] is None
            else f"{row['device_us']:.3f}",
            plain_ms=f"{row['plain_ms']:.4f}",
            collective_ms=f"{row['collective_ms']:.4f}",
            collective_device_us=f"{row['collective_device_us']:.3f}",
            bound_us=f"{b_ms * 1e3:.3f}", bound_by=b_by,
            err_over_bar=f"{ratio:.3f}", card=f"'{card}'")
    del blocks, cs, sn
    torch.cuda.empty_cache()
    log("time", note="library_ms null for K11: no single PyTorch call "
        "exchanges and rotates; collective_ms is pairwise_exchange + K6/K10")
    return table, worst

# -- phase 15: structure search and the flagship experiment from raw digits ---

# 15a: the degree QUBO at the flagship's first layer width
QUBO_FUNCS, QUBO_READS, QUBO_SWEEPS = 32, 1000, 1000
# best energy (recomputed in float64 from the best sample) against the
# brute-force ground state
GROUND_BAR = 1e-9
# 15b: the flagship's rows (digits-784, augmented), and the card's float32
# scores against the same port code on the CPU in float64, on the same
# layer inputs
SEARCH_ROWS = 10000
SCORE_RTOL = 1e-3
# 15c: the recipe of benchmarks/mnist_shape_evidence.py:114-120, 198-205
# ("improved_trained_fused_dw") on digits-784 at 10k rows
FLAGSHIP_RUN = dict(
    network_shape=SHAPE, max_degree=MAX_DEGREE, train_size=10000,
    dataset="digits-784", lstsq_method="normal",
    degree_objective="penalized_mse", consistent_tanh=True,
    complexity_weight=0.001, weight_epochs=15, weight_trainable="all",
    weight_lr_scale="fanin", weight_grad_clip=1.0, learning_rate=0.002,
    weight_batch_size=64, weight_backend="fused_dw", seed=SEED,
)
# the band of the JAX package's CPU records is 0.8778 +- 0.0132
# (mnist_shape_improved_trained_cpu_f32_nruns.json) and 0.8861
# (mnist_shape_improved_trained_fused_dw.json)
FLAGSHIP_MIN_ACC = 0.85


def random_qubo(n: int, seed: int) -> QuboModel:
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, n))
    J = (a + a.T) / 2
    np.fill_diagonal(J, 0.0)
    return QuboModel(h=rng.normal(size=n), J=J, offset=0.5)


def block_qubo(nblocks: int, bs: int, seed: int) -> QuboModel:
    """A block-diagonal QUBO (the blocked kernel's structure) with dense
    random blocks."""
    parts = [random_qubo(bs, seed + b) for b in range(nblocks)]
    J = np.zeros((nblocks * bs, nblocks * bs))
    for b, m in enumerate(parts):
        J[b * bs:(b + 1) * bs, b * bs:(b + 1) * bs] = m.J
    return QuboModel(np.concatenate([m.h for m in parts]), J, 0.0)


def profiled_launches(fn) -> tuple:
    """(device events, device ms) of one call of ``fn`` under
    torch.profiler: what the call launches on the card."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = device_events(prof)
    return sum(c for _, _, c in evs), sum(us for _, us, _ in evs) / 1e3


def host_ms(fn) -> float:
    """Host ms of one call that ends on the host (the annealers return
    numpy), from an idle card."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def check_annealers(device, smi: str) -> dict:
    """Phase 15a: the annealers on the card against exact answers."""
    out = {}
    rng = np.random.default_rng(SEED + 15)
    scores = np.sort(rng.uniform(0.01, 0.1, DP1))[::-1].copy()
    for objective in ("reference", "penalized_mse"):
        model = degree_selection_qubo(scores, QUBO_FUNCS, 0.001,
                                      objective=objective)
        exact = np.zeros(model.num_variables)
        exact[int(np.argmin(model.h[:DP1]))::DP1] = 1.0

        def solve():
            return solve_qubo(model, QUBO_READS, QUBO_SWEEPS, seed=SEED,
                              one_hot_block_size=DP1, device=device)

        solve()  # warm
        ms = host_ms(solve)
        sample, energy = solve()
        if not np.array_equal(sample, exact):
            raise AssertionError(f"solve_qubo ({objective}): sample is not "
                                 "the blockwise argmin")
        # the whole call under the profiler: its sweeps run in S1, one
        # launch a chunk, so the profiler keeps few events
        launches, device_ms = profiled_launches(solve)
        out[f"solve_qubo_{objective}"] = {
            "ms": ms, "device_ms": device_ms, "launches": launches,
            "launches_per_sweep": launches / QUBO_SWEEPS,
            "steps": QUBO_SWEEPS * DP1}
        log("anneal", check=f"solve_qubo_{objective}",
            functions=QUBO_FUNCS, degrees=DP1, reads=QUBO_READS,
            sweeps=QUBO_SWEEPS, equals_exact=True, ms=f"{ms:.1f}",
            device_ms=f"{device_ms:.1f}", launches=launches,
            launches_per_step=f"{launches / QUBO_SWEEPS / DP1:.4f}",
            card=f"'{smi}'")
    for n in (12, 16):
        cases = {
            "sa_delayed": (random_qubo(n, SEED + n), lambda m: (
                simulated_annealing(m, 256, 300, seed=SEED, device=device))),
            "sa_blocked": (block_qubo(n // 4, 4, SEED + n), lambda m: (
                simulated_annealing(m, 256, 300, seed=SEED,
                                    block_structure=4, device=device))),
            "pt_delayed": (random_qubo(n, SEED + n), lambda m: (
                parallel_tempering(m, 16, 16, 200, seed=SEED,
                                   device=device))),
            "native": (random_qubo(n, SEED + n), lambda m: (
                anneal_native(m, 256, 1000, seed=SEED))),
        }
        for name, (model, run) in cases.items():
            ground = brute_force_native(model)[1]
            t0 = time.perf_counter()
            samples, _ = run(model)
            ms = (time.perf_counter() - t0) * 1e3
            best = float(np.min(model.energy(samples)))
            gap = abs(best - ground)
            bar = GROUND_BAR * max(1.0, abs(ground))
            log("anneal", check=name, n=n, ground=f"{ground:.12f}",
                best=f"{best:.12f}", gap=f"{gap:.3e}", bar=f"{bar:.1e}",
                ms=f"{ms:.1f}", card=f"'{smi}'")
            if not gap <= bar:
                raise AssertionError(f"{name} n={n}: {best} vs {ground}")
            out[f"{name}_n{n}_ms"] = ms
    # the dense delayed sweep's cost: 8 more sweeps at 1000 reads
    for n in (64, 256):
        model = random_qubo(n, SEED + n)
        ms = [host_ms(lambda s=s: simulated_annealing(
            model, 1000, s, seed=SEED, device=device)) for s in (2, 10)]
        per = (ms[1] - ms[0]) / 8
        out[f"delayed_ms_per_sweep_n{n}"] = per
        log("anneal", check="delayed_sweep_cost", n=n, reads=1000,
            ms_per_sweep=f"{per:.3f}", steps_per_sweep=n, card=f"'{smi}'")
    return out


# 15a: the block-diagonal sweep kernel (S1) at the search cells' shapes:
# (bs, nb) of the degree QUBO of each digits-search layer (degree 5, the
# flagship's output widths) and of market-search (degree 3, 79 features),
# at 1000 reads, on one chunk of the anneal's sweeps; timed at the first
# and the last
S1_SHAPES = {"digits_layer0": (DP1, 32), "digits_layer1_2": (DP1, 16),
             "digits_layer3": (DP1, 10), "market": (4, 79)}
S1_TIMED = ("digits_layer0", "market")


def blocked_chunk(bs: int, nb: int, seed: int, device):
    """(s, f, u, betas, J_blocks) of the first chunk of a block-diagonal
    anneal on the card, made as ``_anneal_kernel_blocked`` makes them: a
    random block QUBO, the state and uniforms from the anneal's
    generator, the fields h + J s, the schedule of ``QUBO_SWEEPS`` sweeps
    in float32."""
    model = block_qubo(nb, bs, seed)
    f32 = torch.float32
    h = torch.as_tensor(model.h.reshape(nb, bs), dtype=f32, device=device)
    J = torch.as_tensor(anneal_sa._block_diagonal_J(model, bs), dtype=f32,
                        device=device)
    gen = anneal_sa._generator(seed, device)
    shape = (bs, QUBO_READS, nb)
    s = anneal_sa._bernoulli_half(gen, shape, h)
    f = (h.T[:, None, :] + torch.einsum("bij,jrb->irb", J, s)).contiguous()
    k = anneal_sa._sweep_chunk(shape, f32, QUBO_SWEEPS)
    u = anneal_sa._uniform(gen, (k, *shape), h)
    betas = torch.tensor(anneal_sa._schedule(
        anneal_sa.default_beta_range(model), QUBO_SWEEPS, f32)[:k],
        dtype=f32).to(device)
    return s, f, u, betas, J


def check_blocked_kernel(device, smi: str) -> tuple[float, dict]:
    """Phase 15a, last: S1 (``blocked_sweeps`` on the card) against its
    plain version (``_blocked_sweeps``, the torch ops) on the same state,
    uniforms, schedule and couplings, bit for bit; then its ms a chunk,
    the plain version's and the bound (the uniforms read once, the state
    and fields read and written once) at ``S1_TIMED``.  Returns (max abs
    error, the table)."""
    worst, table = 0.0, {}
    for i, (name, (bs, nb)) in enumerate(S1_SHAPES.items()):
        s, f, u, betas, J = blocked_chunk(bs, nb, SEED + 21 + i, device)
        k = u.shape[0]
        s_ref, f_ref = s.clone(), f.clone()
        anneal_sa._blocked_sweeps(s_ref, f_ref, u, betas, J)
        s_k, f_k = s.clone(), f.clone()
        before = anneal_sa.blocked_sweeps.launches
        anneal_sa.blocked_sweeps(s_k, f_k, u, betas, J)
        torch.cuda.synchronize()
        launches = anneal_sa.blocked_sweeps.launches - before
        err = max(float((s_k - s_ref).abs().max()),
                  float((f_k - f_ref).abs().max()))
        flips = int((s_k != s).sum())
        worst = max(worst, err)
        row = {"bs": bs, "nb": nb, "reads": QUBO_READS, "sweeps": k,
               "max_abs_err": err, "flips": flips, "launches": launches}
        if name in S1_TIMED:
            ws, wf = s.clone(), f.clone()
            ps, pf = s.clone(), f.clone()

            def kern():
                anneal_sa.blocked_sweeps(ws, wf, u, betas, J)

            def plain():
                anneal_sa._blocked_sweeps(ps, pf, u, betas, J)

            ms, plain_ms = paired_ms(kern, plain, reps=10, warm=2)
            kernels = device_per_call(kern)
            dev = sum(us for _, us in kernels) if kernels else None
            chains = QUBO_READS * nb
            nbytes = 4 * (u.numel() + 4 * bs * chains + J.numel() + k)
            bound_ms, bound_by = bound(nbytes, 2.0 * k * bs * bs * chains)
            row.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by, device_us=dev,
                       us_per_sweep=ms * 1e3 / k,
                       device_us_per_sweep=dev / k if dev else None)
        table[name] = row
        log("anneal", check="blocked_kernel", shape=name, bs=bs, nb=nb,
            reads=QUBO_READS, sweeps=k, max_abs_err=f"{err:.3e}", bar=0,
            flips=flips, launches=launches,
            **{key: (f"{row[key]:.4f}" if isinstance(row[key], float)
                     else row[key])
               for key in ("ms", "plain_ms", "bound_ms", "device_us")
               if key in row}, card=f"'{smi}'")
        if err != 0.0 or launches != 1 or not flips:
            raise AssertionError(f"blocked kernel at {name}: err {err}, "
                                 f"{launches} launches, {flips} flips")
    return worst, table


# the polish's energy bars, relative to the larger of |E| and the offset
# (the degree QUBO's blocks' energies cancel against it): against numpy's
# sum, whose own rounding reads up to 1e-12 of E at 79 blocks, and against
# the exact sum (math.fsum)
POLISH_ENERGY_RTOL = 1e-12
POLISH_EXACT_RTOL = 1e-15


def check_polish_kernel(device, smi: str) -> tuple[float, dict]:
    """Phase 15a, last: S2 (``polish_blocked`` on the card) against the
    host route (every read to numpy, ``polish_one_hot_blocks``,
    ``QuboModel.energy``, ``np.argmin``) on the state 20 sweeps of S1 leave
    on the degree QUBO of each of ``S1_SHAPES``: every read's polished bits
    and the best sample bit for bit, its energy within
    ``POLISH_ENERGY_RTOL`` of the host's and ``POLISH_EXACT_RTOL`` of the
    exact sum; then S2's device µs, event ms (beside the
    plain version's on the card), the host ms of the card's polish (S2
    and the copy of the best read, what ``solve_qubo``'s polish span
    holds) and of the numpy route it replaces, and the bytes bound.
    Returns (largest relative gap to the host's energy, the table)."""
    worst, table = 0.0, {}
    f32, f64 = torch.float32, torch.float64
    for i, (name, (bs, nb)) in enumerate(S1_SHAPES.items()):
        rng = np.random.default_rng(SEED + 31 + i)
        scores = np.sort(rng.uniform(0.01, 0.1, bs))[::-1].copy()
        model = degree_selection_qubo(scores, nb, 0.001,
                                      objective="penalized_mse")
        J = anneal_sa._block_diagonal_J(model, bs)
        s0 = anneal_sa._anneal_blocked_state(
            *anneal_sa._blocked_terms(model, J, f32, device),
            anneal_sa._schedule(anneal_sa.default_beta_range(model), 20,
                                f32),
            anneal_sa._generator(SEED + 31 + i, device), QUBO_READS, 20)
        h64, J64 = anneal_sa._blocked_terms(model, J, f64, device)

        def numpy_route(state=s0):
            samples = state.permute(1, 2, 0).reshape(QUBO_READS, -1)
            polished = anneal_sa.polish_one_hot_blocks(
                model, samples.cpu().double().numpy(), bs)
            energies = model.energy(polished)
            best = int(np.argmin(energies))
            return polished, polished[best], float(energies[best])

        polished, want, e_want = numpy_route()
        s_k = s0.clone()
        before = anneal_sa.polish_one_hot_blocks.card_calls
        best = anneal_sa.polish_blocked(s_k, h64, J64).cpu().numpy()
        calls = anneal_sa.polish_one_hot_blocks.card_calls - before
        same_reads = np.array_equal(
            s_k.permute(1, 2, 0).reshape(QUBO_READS, -1).cpu().numpy(),
            polished)
        same_best = np.array_equal(best[:-1], want)
        e_got = float(best[-1]) + model.offset
        on = np.flatnonzero(want)
        e_exact = math.fsum([*model.h[on], model.offset])  # J's diagonal 0
        scale = max(abs(e_want), abs(model.offset))
        gap = abs(e_got - e_want) / scale
        exact_gap = abs(e_got - e_exact) / scale
        worst = max(worst, gap)
        ws, ps = s0.clone(), s0.clone()

        def kern():
            anneal_sa.polish_blocked(ws, h64, J64)

        def plain():
            anneal_sa._polish_blocked(ps, h64, J64)

        ms, plain_ms = paired_ms(kern, plain, reps=20, warm=2)
        kernels = device_per_call(kern)
        dev = sum(us for _, us in kernels) if kernels else None
        card_host_ms = float(np.median([host_ms(
            lambda: anneal_sa.polish_blocked(ws, h64, J64).cpu())
            for _ in range(10)]))
        numpy_ms = float(np.median([host_ms(numpy_route)
                                    for _ in range(3)]))
        # the state read and written, h and J, the energies written and
        # read, the best read written; 4 R nb bs^2 float64 operations
        # (0.14 µs at digits layer 0 on 34 TFLOP/s FP64) lie below it
        nbytes = (2 * 4 * s0.numel() + 8 * (h64.numel() + J64.numel())
                  + 2 * 8 * QUBO_READS + 8 * (nb * bs + 1))
        row = {"bs": bs, "nb": nb, "reads": QUBO_READS,
               "energy_rel_gap": gap, "exact_rel_gap": exact_gap,
               "calls": calls, "ms": ms,
               "plain_ms": plain_ms, "device_us": dev,
               "kernels": [k for k, _ in kernels],
               "host_ms": card_host_ms, "numpy_ms": numpy_ms,
               "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
               "bound_by": "bytes"}
        table[name] = row
        log("anneal", check="polish_kernel", shape=name, bs=bs, nb=nb,
            reads=QUBO_READS, same_reads=same_reads, same_best=same_best,
            energy_rel_gap=f"{gap:.3e}", bar=POLISH_ENERGY_RTOL,
            exact_rel_gap=f"{exact_gap:.3e}", exact_bar=POLISH_EXACT_RTOL,
            calls=calls, ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
            device_us=f"{dev:.3f}" if dev else None,
            host_ms=f"{card_host_ms:.4f}", numpy_ms=f"{numpy_ms:.2f}",
            bound_us=f"{row['bound_ms'] * 1e3:.3f}", card=f"'{smi}'")
        if not (same_reads and same_best and gap <= POLISH_ENERGY_RTOL
                and exact_gap <= POLISH_EXACT_RTOL and calls == 1):
            raise AssertionError(f"polish kernel at {name}: reads "
                                 f"{same_reads}, best {same_best}, energy "
                                 f"gaps {gap}, {exact_gap}, {calls} card "
                                 "calls")
    return worst, table


def layer_inputs_of(kan, x):
    """Each layer's fit input (tanh of its input: consistent_tanh) on the
    card, from the model's own parameters."""
    fits, current = [], x
    for lp in kan.params:
        fits.append(torch.tanh(current))
        current = kan_layer_apply(lp, current, kan.config.max_degree)
    return fits


def kernel_sweep_share(fn) -> float:
    """Run ``fn`` and return the share (%) of the sweeps it asked
    ``solve_qubo`` for that ran in S1 (``anneal_kernel_sweep_pct``), None
    where it asked for none."""
    asked = anneal_sa.solve_qubo.sweeps
    swept = anneal_sa.simulated_annealing.kernel_sweeps
    fn()
    asked = anneal_sa.solve_qubo.sweeps - asked
    if not asked:
        return None
    return 100.0 * (anneal_sa.simulated_annealing.kernel_sweeps
                    - swept) / asked


def run_structure_search(device, paths: dict, smi: str) -> dict:
    """Phase 15b: structure search at full width on the card; its anneal
    run is a main path ("structure_search")."""
    x, labels, meta = load_digits_784(train=True, augment_to=SEARCH_ROWS,
                                      seed=SEED)
    y = to_one_hot(labels, T)
    cfg = FixedKANConfig.preset("recommended", SHAPE, MAX_DEGREE,
                                complexity_weight=0.001)
    real_kernel = anneal_sa._anneal_blocked_state
    state_devices = []

    def spy(*args, **kw):
        out = real_kernel(*args, **kw)
        state_devices.append(out.device.type)
        return out

    anneal_sa._anneal_blocked_state = spy
    try:
        kans = {}
        for solver in ("anneal", "exact"):
            kans[solver] = FixedKAN(cfg, device=device)
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            share = kernel_sweep_share(lambda: kans[solver].optimize(
                x, y, solver=solver, seed=SEED))
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            if solver == "anneal":
                paths["structure_search"] = read_counts()
                if share != 100.0:
                    raise AssertionError(f"{share}% of the search's sweeps "
                                         "in S1")
                # every solve_qubo polished on the card (S2): one a layer
                polished = read_counts()["anneal_polish"]
                if polished != len(SHAPE) - 1:
                    raise AssertionError(f"{polished} polishes on the card "
                                         f"in {len(SHAPE) - 1} solves")
            log("search", solver=solver, rows=x.shape[0],
                data=meta["source"], seconds=f"{seconds:.3f}",
                s1_launches=read_counts()["anneal_blocked"],
                s2_calls=read_counts()["anneal_polish"],
                kernel_sweep_pct=share, card=f"'{smi}'")
    finally:
        anneal_sa._anneal_blocked_state = real_kernel
    if state_devices != [device.type] * (len(SHAPE) - 1):
        raise AssertionError(f"anneal state on {state_devices}")
    out = {"layers": []}
    fits = layer_inputs_of(kans["anneal"],
                           torch.as_tensor(x, dtype=torch.float32,
                                           device=device))
    y_card = torch.as_tensor(y, dtype=torch.float32, device=device)
    cpu = FixedKAN(cfg, device="cpu")
    worst64 = 0.0
    for i, (st_a, st_e, x_fit) in enumerate(zip(
            kans["anneal"].last_search_stats,
            kans["exact"].last_search_stats, fits)):
        for sweep in st_a["sweeps"]:
            if not all(d.startswith(device.type) for d in sweep["devices"]):
                raise AssertionError(f"layer {i}: {sweep} not on the card")
        if st_a["degrees"] != st_e["degrees"]:
            raise AssertionError(f"layer {i}: anneal degrees "
                                 f"{st_a['degrees']} != exact "
                                 f"{st_e['degrees']}")
        card = np.asarray(st_a["scores"])
        with torch.no_grad():
            s64, _ = cpu._evaluate_layer_degrees(
                x_fit.cpu().double(), y_card.cpu().double())
            route64 = cpu._sweep_log[-1]["route"]
            s32, _ = cpu._evaluate_layer_degrees(x_fit.cpu(), y_card.cpu())
        gap64 = float(np.max(np.abs(card - s64) / np.abs(s64)))
        gap32 = float(np.max(np.abs(card - s32) / np.abs(s32)))
        worst64 = max(worst64, gap64)
        degree64 = int(np.argmin(degree_selection_qubo(
            s64, 1, cfg.complexity_weight, objective=cfg.degree_objective).h))
        row = {"route": st_a["route"], "route_cpu_f64": route64,
               "scores": st_a["scores"], "scores_cpu_f64": s64.tolist(),
               "degrees": np.bincount(st_a["degrees"],
                                      minlength=DP1).tolist(),
               "solve_ms": st_a["solve_seconds"] * 1e3,
               "anneal_ms": st_a["select_seconds"] * 1e3,
               "gap_vs_cpu_f64": gap64, "gap_vs_cpu_f32": gap32,
               "degree_from_cpu_f64": degree64}
        out["layers"].append(row)
        log("search", layer=i, route=row["route"],
            route_cpu_f64=route64, degree_counts=row["degrees"],
            solve_ms=f"{row['solve_ms']:.1f}",
            anneal_ms=f"{row['anneal_ms']:.1f}",
            exact_select_ms=f"{st_e['select_seconds'] * 1e3:.3f}",
            scores="[" + ", ".join(f"{v:.6g}" for v in card) + "]",
            gap_vs_cpu_f64=f"{gap64:.3e}", gap_vs_cpu_f32=f"{gap32:.3e}",
            degree_from_cpu_f64=degree64, bar=SCORE_RTOL, card=f"'{smi}'")
        # the same code on the CPU in f32, same inputs and route: the
        # card's solves themselves
        if not gap32 <= SCORE_RTOL:
            raise AssertionError(f"layer {i}: card vs CPU float32 {gap32}")
        # float64 takes another route where f32 sends a wide layer to QR
        # with its 1e-6 ridge floor (JAX fixed_kan.py:616-640): there the
        # gap is the f32 route's own, logged as a finding
        if row["route"] == route64 and not gap64 <= SCORE_RTOL:
            raise AssertionError(f"layer {i}: card vs CPU float64 {gap64}")
    out["worst_gap_vs_cpu_f64"] = worst64
    out["search_seconds"] = sum(r["solve_ms"] + r["anneal_ms"]
                                for r in out["layers"]) / 1e3
    log("search", worst_gap_vs_cpu_f64=f"{worst64:.3e}", bar=SCORE_RTOL,
        within_bar=worst64 <= SCORE_RTOL,
        held="the layers whose float32 route is float64's", card=f"'{smi}'")
    return out


def run_flagship(device, workdir: Path, paths: dict, smi: str) -> tuple:
    """Phases 15c and 15d: the flagship experiment from raw digits on the
    card, then its saved model served on the fused kernels.  Returns the
    saved model's path and the phase's numbers."""
    reset_counts()
    res = run_mnist_experiment(save_dir=str(workdir), verbose=False,
                               device=device, **FLAGSHIP_RUN)
    counts = read_counts()
    paths["flagship_experiment"] = counts
    m = res["metrics"]
    steps = (FLAGSHIP_RUN["train_size"] // FLAGSHIP_RUN["weight_batch_size"]
             * FLAGSHIP_RUN["weight_epochs"])
    step_ms = m["weight_time_seconds"] * 1e3 / steps
    log("flagship", dataset=res["dataset"], rows=res["train_size"],
        test_rows=res["test_size"],
        train_accuracy=f"{m['train_accuracy']:.4f}",
        test_accuracy=f"{m['test_accuracy']:.4f}",
        bar=FLAGSHIP_MIN_ACC,
        structure_time_seconds=f"{m['structure_time_seconds']:.3f}",
        weight_time_seconds=f"{m['weight_time_seconds']:.3f}",
        train_step_ms=f"{step_ms:.4f}", steps=steps,
        k1_launches=counts["fused_dw_fwd"],
        k2_launches=counts["fused_dw_bwd"],
        dw_pass_launches=counts["fused_bwd_partial_sum"],
        diverged=m["train_diverged"], card=f"'{smi}'")
    if not m["test_accuracy"] >= FLAGSHIP_MIN_ACC:
        raise AssertionError(f"flagship test accuracy {m['test_accuracy']}")
    layers = len(SHAPE) - 1
    if counts["fused_dw_fwd"] != layers * steps or \
            counts["fused_dw_bwd"] != layers * steps:
        raise AssertionError(f"K1/K2 launches {counts} != {layers * steps}")

    # 15d: the saved npz, served on 'fused_dw'
    model = FixedKAN.load_model(res["model_file"], device=device)
    model.config.layer_backend = "fused_dw"
    x_test, y_test, _ = load_digits_784(train=False)
    predictor = BatchedPredictor(model, max_batch=512)
    reset_counts()
    logits = predictor.predict(x_test)
    paths["flagship_serve"] = read_counts()

    def fold(dtype):
        """The model through the 'xla' fold on the card, activations in
        ``dtype`` (phase 5's two references: FP32, and float64 over the
        stored float32 parameters)."""
        with torch.inference_mode():
            return kan_apply(
                model.params, torch.as_tensor(x_test, dtype=dtype,
                                              device=device),
                MAX_DEGREE, backend="xla", matmul_precision="high",
            ).double().cpu().numpy()

    want, want32 = fold(torch.float64), fold(torch.float32)
    scale = np.abs(want).max()
    rel = float(np.abs(logits - want).max() / scale)
    rel_fp32 = float(np.abs(logits - want32).max() / scale)
    fp32_own = float(np.abs(want32 - want).max() / scale)
    served_acc = float((logits.argmax(axis=1) == y_test).mean())
    log("flagship", check="served_fused_dw", rows=len(x_test),
        rel_err=f"{rel:.3e}", bar=SLICE_RTOL,
        rel_err_vs_fp32_fold=f"{rel_fp32:.3e}",
        fp32_fold_vs_float64=f"{fp32_own:.3e}",
        served_accuracy=f"{served_acc:.4f}",
        k1_launches=paths["flagship_serve"]["fused_dw_fwd"],
        latency_ms=f"{predictor.stats()['latency_p50_ms']:.4f}",
        card=f"'{smi}'")
    # held to the fold in float64: on this trained model the FP32 fold is
    # itself ~1e-4 of max|logit| from it (layer 0's 4704-term sums cancel)
    if not rel <= SLICE_RTOL:
        raise AssertionError(f"served logits vs the float64 fold: {rel}")
    if served_acc != m["test_accuracy"]:
        raise AssertionError(f"served accuracy {served_acc} != "
                             f"{m['test_accuracy']}")
    return res["model_file"], {"test_accuracy": m["test_accuracy"],
            "train_accuracy": m["train_accuracy"],
            "structure_time_seconds": m["structure_time_seconds"],
            "weight_time_seconds": m["weight_time_seconds"],
            "train_step_ms": step_ms, "served_rel_err": rel,
            "served_rel_err_vs_fp32_fold": rel_fp32,
            "fp32_fold_vs_float64": fp32_own}


# -- phase 16: the int8 serving recipes on the card ----------------------------

# the int8 products' shapes: [B, F] @ [F, K], the padding edges of
# torch._int_mm's route (B <= 16, F or K not a multiple of 8) and the
# flagship's layer 0 and last layer (16 inputs x 6 degrees -> 10)
INT8_SHAPES = [(b, f, k) for b in (1, 37, 4096)
               for f, k in ((4704, 32), (96, 10))] + [
    (37, 128, 16), (1, 768, 16), (16, 10, 10), (17, 10, 10), (4096, 16, 16)]
INT8_RECIPES = ("int8x2", "int8x2w", "int8")
# test accuracy: 'int8x2' within 0.01 of the float model's (the JAX CPU
# record eval_precision_probe_cpu.json: 'int8x2' 0.8889 against 0.8861 on
# its own model); every recipe within 0.01 of the same recipe on the
# host CPU, whose products tests/test_torch_int8.py holds equal to the
# JAX package's.  On phase 15c's model the JAX package's own 'int8x2w'
# scores 0.7528 and 'int8' 0.1778 against the float 0.8861
# (tools/int8_recipes_vs_jax.py on the model the card trained): the
# basis at one int8 level costs it, so a float bar cannot hold for them
INT8_ACC_BAR = 0.01
SERVE_ROWS = (1, 64, 4096)


def check_int8_products(device) -> dict:
    """16a: the card's int8 product against the exact float64 product of
    the same operands, through ``torch._int_mm`` (spied: every product
    must go there)."""
    rng = np.random.default_rng(SEED + 16)
    calls = []
    real = torch._int_mm

    def spy(a, b):
        calls.append((tuple(a.shape), tuple(b.shape)))
        return real(a, b)

    torch._int_mm = spy
    try:
        for b, f, k in INT8_SHAPES:
            qa = torch.as_tensor(rng.integers(-127, 128, (b, f)),
                                 dtype=torch.int8, device=device)
            qw = torch.as_tensor(rng.integers(-127, 128, (f, k)),
                                 dtype=torch.int8, device=device)
            n0 = len(calls)
            got = int8_matmul(qa, qw)
            want = (qa.double() @ qw.double()).to(torch.int32)
            if len(calls) != n0 + 1:
                raise AssertionError(f"int8 [{b},{f}]@[{f},{k}] did not run "
                                     "torch._int_mm")
            if not (got.device == qa.device and torch.equal(got, want)):
                raise AssertionError(f"int8 [{b},{f}]@[{f},{k}] differs from "
                                     "the exact product")
            log("int8", check="product", shape=f"[{b},{f}]@[{f},{k}]",
                int_mm=f"{calls[-1][0]}@{calls[-1][1]}", equal=True)
    finally:
        torch._int_mm = real
    return {"shapes": len(INT8_SHAPES), "int_mm_calls": len(calls)}


def serve_p50_ms(model, x, rows: int, reps: int = 20) -> float:
    """Predict p50 (host clock around a synchronised request, as
    ``BatchedPredictor.stats`` keeps it) at ``rows`` rows."""
    predictor = BatchedPredictor(model, max_batch=max(SERVE_ROWS))
    for _ in range(3):
        predictor.predict(x[:rows])
    predictor._latencies.clear()
    for _ in range(reps):
        predictor.predict(x[:rows])
    return predictor.stats()["latency_p50_ms"]


def run_int8_serving(device, model_file: str, float_acc: float,
                     paths: dict, smi: str) -> dict:
    """Phase 16: phase 15's trained flagship served through each int8
    recipe, and the float path, on the card; each recipe beside the same
    recipe on the host CPU, whose products are replayed on the card."""
    out = {"products": check_int8_products(device)}
    x_test, y_test, _ = load_digits_784(train=False)
    x_rows = np.concatenate([x_test] * (max(SERVE_ROWS) // len(x_test) + 1))
    base = FixedKAN.load_model(model_file, device=device)
    with torch.inference_mode():
        want = kan_apply(base.params, torch.as_tensor(
            x_test, dtype=torch.float64, device=device), MAX_DEGREE,
            backend="xla", matmul_precision="high").cpu().numpy()
    scale = max(float(np.std(want)), 1.0)
    errs = {}
    for recipe in (None, *INT8_RECIPES):
        name = recipe or "float32"
        models = {}
        for where in (device, "cpu"):
            models[where] = FixedKAN.load_model(model_file, device=where)
            # the int8 recipes are 'xla' fold products; the float path
            # beside them is the same fold in FP32
            models[where].config.layer_backend = "xla"
            models[where].config.compute_dtype = recipe
        predictor = BatchedPredictor(models[device], max_batch=512)
        reset_counts()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            logits = predictor.predict(x_test)
        paths[f"int8_serve_{name}"] = read_counts()
        warned = [str(w.message) for w in caught
                  if "fan-in 4704" in str(w.message)]
        acc = float((logits.argmax(axis=1) == y_test).mean())
        err = float(np.abs(logits.astype(np.float64) - want).max())
        errs[name] = err
        row = {"test_accuracy": acc, "max_abs_err_vs_f64": err,
               "err_over_scale": err / scale, "warned": bool(warned),
               "dtype": str(logits.dtype)}
        if recipe is not None:
            row.update(host_cpu_recipe(models["cpu"], x_test, y_test,
                                       device))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            row.update({f"p50_ms_{r}": serve_p50_ms(models[device], x_rows,
                                                    r) for r in SERVE_ROWS})
        out[name] = row
        log("int8", recipe=name, test_accuracy=f"{acc:.4f}",
            float_accuracy=f"{float_acc:.4f}",
            host_cpu_accuracy=f"{row.get('cpu_accuracy', acc):.4f}",
            products_equal_cpu=row.get("products_equal_cpu", "-"),
            max_abs_err_vs_f64=f"{err:.3e}",
            err_over_scale=f"{err / scale:.3e}", warned_fan_in=bool(warned),
            **{f"p50_ms_{r}": f"{row[f'p50_ms_{r}']:.4f}"
               for r in SERVE_ROWS},
            card=f"'{smi}'")
        if logits.dtype != np.float32:
            raise AssertionError(f"{name}: output {logits.dtype}")
        if recipe == "int8x2" and not abs(acc - float_acc) <= INT8_ACC_BAR:
            raise AssertionError(f"{name}: accuracy {acc} vs {float_acc}")
        if recipe is not None and not (
                abs(acc - row["cpu_accuracy"]) <= INT8_ACC_BAR
                and row["products_equal_cpu"]):
            raise AssertionError(f"{name}: card {acc} vs host CPU {row}")
        if (recipe == "int8") != bool(warned):
            raise AssertionError(f"{name}: fan-in warning {warned}")
    # the JAX suite's order (test_compute_dtype_int8x2_residual_serving)
    if not errs["int8x2"] < errs["int8x2w"] < errs["int8"]:
        raise AssertionError(f"recipe errors out of order: {errs}")
    out["logit_scale"] = scale
    return out


def host_cpu_recipe(cpu_model, x, labels, device) -> dict:
    """The same recipe on the host CPU: its accuracy, and each of its
    int8 products replayed on the card on the same operands, equal bit
    for bit (the quantisation is elementwise, the products exact)."""
    calls = []
    real = {n: getattr(fk_mod, n) for n in ("int8_quantized_matmul",
                                           "int8_residual_matmul")}

    def spy(fn):
        def record(a2d, W, **kw):
            res = fn(a2d, W, **kw)
            calls.append((fn, a2d, W, kw, res))
            return res
        return record

    for n, fn in real.items():
        setattr(fk_mod, n, spy(fn))
    try:
        with torch.inference_mode(), warnings.catch_warnings():
            warnings.simplefilter("ignore")
            logits = cpu_model(x).numpy()
    finally:
        for n, fn in real.items():
            setattr(fk_mod, n, fn)
    equal = bool(calls) and all(
        torch.equal(fn(a.to(device), w.to(device), **kw).cpu(), res)
        for fn, a, w, kw, res in calls)
    return {"cpu_accuracy": float((logits.argmax(axis=1) == labels).mean()),
            "products_equal_cpu": equal, "products": len(calls)}


# -- phase 17: the market harness on the card ---------------------------------

# 17a: benchmarks/market_bench.py's recipe (hard profile, 250k rows x 79
# features, 200 dates, seed 0, max_degree 3, 1000 reads) and the JAX
# package's numbers for it: the committed float32 record
# benchmarks/records/market_250k_hard.json, and the same recipe in
# float64 (x64) on a CPU, per degree
MARKET = dict(n_rows=250_000, n_features=79, n_dates=200, seed=SEED,
              profile="hard")
MARKET_RECORD_MSE = 0.24493307633592082
MARKET_RECORD_COMP_R2 = 0.04622748733831272
MARKET_F64_VAL_MSE = [0.2545287878228393, 0.24773059164892783,
                      0.24553451578699423, 0.24493309358039209]
MARKET_MSE_RTOL = 1e-6
MARKET_COMP_R2_ATOL = 1e-7
# 17b: config.yaml's models at its 100,000 rows, cut in depth only
CONFIG_YAML = Path(__file__).resolve().parent / "config.yaml"
HARNESS_CUTS = {"num_trials": 1, "mlp_epochs": 3, "fixed_kan_epochs": 2}
FIXED_KAN_MODEL = {"model_type": "fixed_kan", "network_shape": [79, 8, 1],
                   "max_degree": 3, "batch_size": 256,
                   "learning_rate": 1e-2, "n_epochs": 2}
# one MLP epoch on the card against the same epoch on the host CPU, float64
MLP_EPOCH_ROWS = 8192
MLP_EPOCH_RTOL = 1e-8


def market_config(n_rows: int, data_path: str = "(columns)") -> DataConfig:
    return DataConfig(
        data_path=data_path, n_rows=n_rows, train_ratio=0.8,
        feature_cols=get_default_features(), target_col="responder_6",
        weight_col="weight", date_col="date_id")


def run_market_search(device, paths: dict, smi: str) -> dict:
    """17a: the degree search at the record's size, its Gram statistics
    on the card; the search is a main path ("market_search")."""
    t0 = time.perf_counter()
    cols = market_columns(**MARKET)
    t1 = time.perf_counter()
    tr, tt, tw, va, vt, vw = DataPipeline(
        market_config(MARKET["n_rows"]), columns=cols
    ).load_and_preprocess_data()
    t2 = time.perf_counter()
    gram_devices, anneal = [], {}
    real_stats, real_solve = dopt._gram_stats, dopt.solve_qubo

    def stats_spy(*args, **kw):
        out = real_stats(*args, **kw)
        gram_devices.extend(t.device.type for t in out)
        return out

    def solve_spy(model, **kw):
        anneal["model"], anneal["kw"] = model, kw
        anneal["ms"] = host_ms(lambda: anneal.setdefault(
            "out", real_solve(model, **kw)))
        return anneal["out"]

    dopt._gram_stats, dopt.solve_qubo = stats_spy, solve_spy
    try:
        opt = DegreeOptimizer([MARKET["n_features"], 1], 3, device=device)
        torch.cuda.synchronize()
        reset_counts()
        t3 = time.perf_counter()
        found = {}
        share = kernel_sweep_share(lambda: found.setdefault(
            "degrees", opt.optimize_layer(0, tr, tt, weights=tw,
                                          num_reads=1000)))
        degrees = found["degrees"]
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        paths["market_search"] = read_counts()
        if paths["market_search"]["anneal_polish"] != 1:
            raise AssertionError("the market search's solve_qubo did not "
                                 "polish on the card")
        scores, comp_r2 = opt.evaluate_degree(va, vt, weights=vw)
        t5 = time.perf_counter()
    finally:
        dopt._gram_stats, dopt.solve_qubo = real_stats, real_solve
    # the anneal's launches and device ms, the whole call profiled (15a)
    launches, anneal_device_ms = profiled_launches(
        lambda: real_solve(anneal["model"], **anneal["kw"]))
    best = int(np.argmin(scores))
    rel64 = [abs(s - r) / r for s, r in zip(scores, MARKET_F64_VAL_MSE)]
    rel_rec = abs(scores[best] - MARKET_RECORD_MSE) / MARKET_RECORD_MSE
    gap_r2 = abs(comp_r2[best] - MARKET_RECORD_COMP_R2)
    out = {
        "rows": {"train": len(tr), "val": len(va)},
        "seconds": {"generate": t1 - t0, "pipeline": t2 - t1,
                    "degree_search": t4 - t3, "val_scoring": t5 - t4},
        "anneal_ms": anneal["ms"], "anneal_launches": launches,
        "anneal_device_ms": anneal_device_ms,
        "s1_launches": paths["market_search"]["anneal_blocked"],
        "kernel_sweep_pct": share,
        "val_mse": scores.tolist(), "val_comp_r2": comp_r2.tolist(),
        "rel_vs_jax_f64": rel64, "best_rel_vs_record": rel_rec,
        "best_comp_r2_gap": gap_r2,
        "degree_counts": np.bincount(np.ravel(degrees), minlength=4).tolist(),
        "gram_devices": sorted(set(gram_devices)),
    }
    log("market", check="search", rows=MARKET["n_rows"],
        train_rows=len(tr), val_rows=len(va),
        **{f"{k}_s": f"{v:.3f}" for k, v in out["seconds"].items()},
        anneal_ms=f"{anneal['ms']:.1f}", anneal_launches=launches,
        anneal_device_ms=f"{anneal_device_ms:.1f}",
        s1_launches=out["s1_launches"], kernel_sweep_pct=share,
        degree_counts=out["degree_counts"],
        val_mse="[" + ", ".join(f"{v:.11f}" for v in scores) + "]",
        rel_vs_jax_f64=f"{max(rel64):.3e}", bar=MARKET_MSE_RTOL,
        best_val_mse=f"{scores[best]:.17g}", best_rel_vs_record=f"{rel_rec:.3e}",
        best_comp_r2=f"{comp_r2[best]:.17g}", comp_r2_gap=f"{gap_r2:.3e}",
        comp_r2_bar=MARKET_COMP_R2_ATOL, gram_on=out["gram_devices"],
        card=f"'{smi}'")
    if not gram_devices or set(gram_devices) != {device.type}:
        raise AssertionError(f"Gram statistics on {set(gram_devices)}")
    if share != 100.0:
        raise AssertionError(f"{share}% of the market search's sweeps in S1")
    if any(d != 0 for row in degrees for d in row):
        raise AssertionError(f"degrees {out['degree_counts']} != JAX's "
                             "(all 0)")
    if not max(rel64) <= MARKET_MSE_RTOL or not rel_rec <= MARKET_MSE_RTOL:
        raise AssertionError(f"val MSE {scores} vs JAX {MARKET_F64_VAL_MSE}")
    if not gap_r2 <= MARKET_COMP_R2_ATOL:
        raise AssertionError(f"comp-R^2 {comp_r2[best]}")
    return out


def harness_config(tmp: Path, data_path: str) -> Path:
    """config.yaml as it is, cut in depth, plus a fixed_kan model: written
    as JSON (a JSON file is YAML too)."""
    cfg = asdict(load_config(str(CONFIG_YAML)))
    cfg["data"]["data_path"] = data_path
    cfg["num_trials"] = HARNESS_CUTS["num_trials"]
    for m in cfg["models"]:
        if m["model_type"] == "mlp":
            m["n_epochs"] = HARNESS_CUTS["mlp_epochs"]
    fk = dict(FIXED_KAN_MODEL, n_epochs=HARNESS_CUTS["fixed_kan_epochs"])
    cfg["models"].append(fk)
    cfg["save_path"], cfg["log_path"] = str(tmp / "results"), str(tmp / "logs")
    path = tmp / "config.json"
    path.write_text(json.dumps(cfg))
    return path


def mlp_busy_share(device, x, y, w, cfg) -> float:
    """Device busy share of MLP training steps under torch.profiler: the
    device time of one epoch on ``x`` over its host time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_mlp(cfg, x, y, weights=w, seed=SEED, device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return sum(us for _, us, _ in device_events(prof)) / 1e6 / wall


def run_harness(device, paths: dict, smi: str) -> dict:
    """17b: ``run_experiment`` on config.yaml's models at its 100,000
    rows, end to end on the card."""
    probe = {}
    for mod in ("pandas", "pyarrow", "yaml", "matplotlib"):
        try:
            __import__(mod)
            probe[mod] = True
        except ImportError:
            probe[mod] = False
    base = load_config(str(CONFIG_YAML))
    n_rows = base.data.n_rows
    log("harness", config=CONFIG_YAML.name, rows=n_rows,
        cuts=f"num_trials {base.num_trials}->{HARNESS_CUTS['num_trials']}, "
        f"mlp n_epochs "
        f"{[m.n_epochs for m in base.models if m.model_type == 'mlp'][0]}"
        f"->{HARNESS_CUTS['mlp_epochs']}, fixed_kan [79, 8, 1] added at "
        f"{HARNESS_CUTS['fixed_kan_epochs']} epochs", packages=probe)
    captured = {}
    real_train = harness_main.train_mlp

    def train_spy(cfg, x, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = real_train(cfg, x, *args, **kw)
        torch.cuda.synchronize()
        steps = len(res[0]) * (len(x) // min(cfg.batch_size, len(x)))
        captured.update(scores=res[0], seconds=time.perf_counter() - t0,
                        steps=steps)
        return res

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        cols = market_columns(n_rows=n_rows, n_features=79, seed=SEED)
        if probe["pandas"] and probe["pyarrow"]:
            data_path, columns = str(tmp / "train.parquet"), None
            generate_market_parquet(data_path, n_rows=n_rows,
                                    n_features=79, seed=SEED)
        else:
            data_path, columns = "(columns)", cols
        cfg_path = harness_config(tmp, data_path)
        harness_main.train_mlp = train_spy
        reset_counts()
        t0 = time.perf_counter()
        try:
            results = run_experiment(str(cfg_path), device=device,
                                     columns=columns)
        finally:
            harness_main.train_mlp = real_train
        seconds = time.perf_counter() - t0
        paths["market_harness"] = read_counts()
        written = {f: (tmp / "results" / f).exists()
                   for f in ("results_summary.csv", "runs.jsonl",
                             "metrics_comparison.png")}
        records = len((tmp / "results" / "runs.jsonl").read_text()
                      .splitlines()) if written["runs.jsonl"] else 0
        # the qkan result against a direct fit / predict on the same arrays
        tr, tt, tw, va, vt, vw = DataPipeline(
            market_config(n_rows, data_path), columns=columns
        ).load_and_preprocess_data()
        q = next(m for m in base.models if m.model_type == "qkan")
        direct = DegreeOptimizer(q.network_shape, q.max_degree,
                                 q.complexity_weight,
                                 q.significance_threshold, device=device)
        direct.fit(tr, tt, weights=tw, num_reads=q.num_reads,
                   seed=base.random_seed)
        direct_val = compute_metrics(vt, direct.predict(va), vw)
    out = {"seconds": seconds, "packages": probe, "written": written,
           "runs_jsonl_records": records, "results": []}
    for r in results:
        row = {"model": r.model_name, "mse": r.MSE_Score, "r2": r.R2_Score,
               "train_time": r.train_time, "val_metrics": r.val_metrics,
               "params": r.model_params if "mlp" in r.model_name else None}
        out["results"].append(row)
        log("harness", model=r.model_name, mse=f"{r.MSE_Score:.10g}",
            r2=f"{r.R2_Score:.6g}", val_mse=f"{r.val_metrics['mse']:.10g}",
            val_comp_r2=f"{r.val_metrics['comp_r2']:.6g}",
            train_time_s=f"{r.train_time:.3f}", card=f"'{smi}'")
        vals = [r.MSE_Score, r.R2_Score, *r.val_metrics.values(),
                *r.train_metrics.values()]
        if not np.all(np.isfinite(vals)):
            raise AssertionError(f"{r.model_name}: non-finite {vals}")
    qkan = next(r for r in results if r.model_name.startswith("qkan"))
    gap = max(abs(qkan.val_metrics[k] - direct_val[k])
              / max(abs(direct_val[k]), 1e-300) for k in direct_val)
    scores = captured["scores"]
    step_ms = captured["seconds"] * 1e3 / captured["steps"]
    out.update(qkan_vs_direct=gap, mlp_val_mse=scores, mlp_step_ms=step_ms,
               mlp_steps=captured["steps"])
    log("harness", check="qkan_vs_direct_fit", rel_gap=f"{gap:.3e}",
        exact=gap == 0.0, mlp_val_mse=[f"{s:.8f}" for s in scores],
        mlp_step_ms=f"{step_ms:.4f}", mlp_steps=captured["steps"],
        seconds=f"{seconds:.2f}", written=written, runs_jsonl=records,
        card=f"'{smi}'")
    if not gap <= 1e-12:
        raise AssertionError(f"qkan val metrics {qkan.val_metrics} vs a "
                             f"direct fit {direct_val}")
    if not scores[-1] < scores[0]:
        raise AssertionError(f"MLP val MSE did not fall: {scores}")
    if not (written["results_summary.csv"] and written["runs.jsonl"]
            and records == len(results)):
        raise AssertionError(f"harness outputs {written}, {records} records")

    # one MLP epoch, float64, card against the host CPU from one start
    mlp = next(m for m in base.models if m.model_type == "mlp")
    cfg = MLPConfig(79, mlp.hidden_dims, learning_rate=mlp.learning_rate,
                    batch_size=mlp.batch_size, n_epochs=1)
    n = MLP_EPOCH_ROWS
    args = [torch.as_tensor(a[:n], dtype=torch.float64)
            for a in (tr, tt, tw, va, vt, vw)]
    start = init_mlp(cfg, seed=SEED, dtype=torch.float64, device="cpu")
    val = {}
    for where, dev in (("card", device), ("cpu", "cpu")):
        x, y, w, xv, yv, wv = args
        s, _, _ = train_mlp(cfg, x, y, weights=w, x_val=xv, y_val=yv,
                            w_val=wv, seed=SEED, device=dev,
                            init_model=start)
        val[where] = s[0]
    rel = abs(val["card"] - val["cpu"]) / abs(val["cpu"])
    busy = mlp_busy_share(device, *(a.float() for a in args[:3]), cfg)
    out.update(mlp_epoch_f64={**val, "rel": rel}, mlp_busy_share=busy)
    log("harness", check="mlp_epoch_f64_card_vs_cpu", rows=n,
        card_val_mse=f"{val['card']:.15g}", cpu_val_mse=f"{val['cpu']:.15g}",
        rel=f"{rel:.3e}", bar=MLP_EPOCH_RTOL,
        busy_share_f32=f"{busy:.3f}", card=f"'{smi}'")
    if not rel <= MLP_EPOCH_RTOL:
        raise AssertionError(f"MLP epoch card {val['card']} vs CPU "
                             f"{val['cpu']}")
    return out


# -- phase 18: the multi-device paths on slots of the card, and diagnostics ----

# 18a/b: rows of the tp forwards, steps and batch of the tp SGD run
TP_ROWS, TP_STEPS, TP_BATCH = 4096, 20, 64
# 18c: one epoch at batch 64 on the first 4096 rows (64 steps), the
# recommended train preset
MESH_TRAIN_ROWS = 4096
MESH_TRAIN = dict(epochs=1, batch_size=64, learning_rate=0.002,
                  loss="cross_entropy", trainable="all", lr_scale="fanin",
                  lr_schedule="cosine", grad_clip=1.0, seed=SEED)
# 18d: sweeps of the sharded samplers, cut from 1000 to keep the phase
# within a minute (8 slots run one after another on one card); widths
# (reads, chains, replicas, variables) are not cut
SHARDED_SWEEPS, SHARDED_READS, PT_CHAINS, PT_REPLICAS = 40, 1000, 128, 16
SEARCH_SWEEPS = 10
# 18e: microbatches of 16 rows
PP_MICRO, PP_MICRO_ROWS = 4, 16
# 18f: FABLE of a 256 x 256 matrix (17 qubits), and the parquet's rows
SV_FABLE_N, SPARSITY_ROWS = 256, 20000


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """max|got - want| / max|want|."""
    return float((got - want).abs().max() / want.abs().max())


def _tree_gap(got, want) -> float:
    """max over leaves of max|got - want| / max(1, max|want|)."""
    gap = 0.0
    for g, w in zip(got, want):
        for k in w:
            scale = max(1.0, float(w[k].abs().max()))
            gap = max(gap, float((g[k] - w[k]).abs().max()) / scale)
    return gap


def _host_ms_median(fn, reps: int = 5) -> float:
    fn()
    return float(np.median([host_ms(fn) for _ in range(reps)]))


def _hold(name: str, value: float, bar: float) -> None:
    if not value <= bar:
        raise AssertionError(f"{name}: {value} above its bar {bar}")


def run_tp(device, model, x, labels, smi: str) -> tuple[dict, list]:
    """18a, 18b: ``kan_apply_tp`` on the flagship and 20 tp SGD steps,
    against the same work on one slot of the card.  Returns the numbers
    and 18b's per-slot parameters."""
    out = {}
    meshes = {"tp8": Mesh([device] * SLOTS, ("tp",)),
              "dp4_tp2": Mesh([device] * SLOTS, ("dp", "tp"), (4, 2))}
    p32 = model.params
    p64 = [{k: v.double() if v.is_floating_point() else v
            for k, v in lp.items()} for lp in p32]
    xb = x[:TP_ROWS]
    want64 = kan_apply(p64, xb.double(), MAX_DEGREE)
    want32 = kan_apply(p32, xb, MAX_DEGREE)
    for name, mesh in meshes.items():
        flags = tp_mod._tp_layer_flags(p32, mesh.shape["tp"], SHAPE[0])
        sharded = shard_params(p32, SHAPE[0], mesh)
        c0 = sharded[0]["coefficients"]
        whole = p32[0]["coefficients"]
        share = [s.untyped_storage().nbytes() / (whole.numel()
                                                 * whole.element_size())
                 for s in c0.parts]
        if share != [1 / mesh.shape["tp"]] * mesh.shape["tp"]:
            raise AssertionError(f"{name}: layer-0 shard bytes {share}")
        err64 = _rel(kan_apply_tp(shard_params(p64, SHAPE[0], mesh),
                                  xb.double(), MAX_DEGREE, mesh), want64)
        err32 = _rel(kan_apply_tp(sharded, xb, MAX_DEGREE, mesh), want32)
        # the trained layer 0's 4704-term sums cancel: the FP32 fold is
        # itself ~1e-4 of max|y| from float64 (15d), so splitting them over
        # slots is held as phase 7 holds float32 runs, within FLOOR_FACTOR
        # x the FP32 fold's own gap to float64
        floor32 = _rel(want32.double(), want64)
        ms = _host_ms_median(lambda: kan_apply_tp(sharded, xb, MAX_DEGREE,
                                                  mesh))
        ms1 = _host_ms_median(lambda: kan_apply(p32, xb, MAX_DEGREE))
        out[f"fwd_{name}"] = {"flags": flags, "rel_err_f64": err64,
                              "rel_err_f32": err32,
                              "fp32_fold_vs_f64": floor32, "ms": ms,
                              "one_slot_ms": ms1,
                              "layer0_shard_bytes_share": share[0]}
        log("tp", mesh=name, rows=TP_ROWS, sharded_layers=flags,
            layer0_features_a_slot=SHAPE[0] // mesh.shape["tp"],
            rel_err_f64=f"{err64:.3e}", bar_f64=1e-10,
            rel_err_f32=f"{err32:.3e}",
            bar_f32=f"{FLOOR_FACTOR * floor32:.3e}",
            fp32_fold_vs_f64=f"{floor32:.3e}",
            within_phase5_bar=err32 <= SLICE_RTOL,
            ms=f"{ms:.3f}", one_slot_ms=f"{ms1:.3f}",
            layer0_shard_bytes_share=share[0], card=f"'{smi}'")
        _hold(f"tp {name} f64", err64, 1e-10)
        _hold(f"tp {name} f32", err32, FLOOR_FACTOR * floor32)

    # 18b: 20 SGD steps on (dp 4, tp 2) in float64, each held to the same
    # step on one slot from the same parameters; a free-running one-slot
    # run beside it shows how far the trajectories drift apart
    mesh = meshes["dp4_tp2"]
    y = torch.nn.functional.one_hot(labels.long(), T).double()
    degrees = [lp["degrees"] for lp in p64]
    train = [{k: v for k, v in lp.items() if k != "degrees"}
             for lp in shard_params(p64, SHAPE[0], mesh)]
    free = [{k: v for k, v in lp.items() if k != "degrees"} for lp in p64]
    step = make_tp_train_step(mesh, MAX_DEGREE)

    def one_slot_step(params, xr, yr):
        leaves = [{k: v.detach().requires_grad_() for k, v in lp.items()}
                  for lp in params]
        full = [dict(lv, degrees=d) for lv, d in zip(leaves, degrees)]
        loss = torch.mean((kan_apply(full, xr, MAX_DEGREE) - yr) ** 2)
        grads = iter(torch.autograd.grad(
            loss, [v for lv in leaves for v in lv.values()]))
        return ([{k: (v - 1e-3 * next(grads)).detach()
                  for k, v in lv.items()} for lv in leaves],
                float(loss.detach()))

    loss_gap, param_gap, tp_s, one_s = 0.0, 0.0, 0.0, 0.0
    for i in range(TP_STEPS):
        rows = slice(i * TP_BATCH, (i + 1) * TP_BATCH)
        xr, yr = x[rows].double(), y[rows]
        start = gather_shards(train)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train, loss = step(train, degrees, xr, yr)
        torch.cuda.synchronize()
        tp_s += time.perf_counter() - t0
        t0 = time.perf_counter()
        ref, l_ref = one_slot_step(start, xr, yr)
        torch.cuda.synchronize()
        one_s += time.perf_counter() - t0
        free, _ = one_slot_step(free, xr, yr)
        loss_gap = max(loss_gap, abs(float(loss) - l_ref)
                       / max(1.0, abs(l_ref)))
        param_gap = max(param_gap, _tree_gap(gather_shards(train), ref))
    drift = _tree_gap(gather_shards(train), free)
    out["sgd_dp4_tp2"] = {"steps": TP_STEPS, "batch": TP_BATCH,
                          "loss_gap": loss_gap, "param_gap": param_gap,
                          "free_run_drift": drift,
                          "ms_per_step": tp_s * 1e3 / TP_STEPS,
                          "one_slot_ms_per_step": one_s * 1e3 / TP_STEPS}
    log("tp", check="sgd_dp4_tp2_f64", steps=TP_STEPS, batch=TP_BATCH,
        loss_gap=f"{loss_gap:.3e}", loss_bar="1e-12 max(1, |loss|)",
        param_gap=f"{param_gap:.3e}", param_bar="1e-10 max(1, max|p|)",
        free_run_drift=f"{drift:.3e}",
        ms_per_step=f"{out['sgd_dp4_tp2']['ms_per_step']:.3f}",
        one_slot_ms_per_step=f"{out['sgd_dp4_tp2']['one_slot_ms_per_step']:.3f}",
        card=f"'{smi}'")
    _hold("tp sgd loss", loss_gap, 1e-12)
    _hold("tp sgd params", param_gap, 1e-10)
    return out, train


def run_mesh_train(device, model_file, x, labels, step_ms: dict,
                   smi: str) -> dict:
    """18c: ``FixedKAN.train(mesh=)`` pure dp and (dp 2, tp 4) from 15c's
    model, one epoch, against the single-slot ``train`` on the card."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    meshes = {"dp8": make_mesh(SLOTS, axis_name="dp",
                               devices=[device] * SLOTS),
              "dp2_tp4": Mesh([device] * SLOTS, ("dp", "tp"), (2, 4))}
    xs, ys = x[:MESH_TRAIN_ROWS], labels[:MESH_TRAIN_ROWS]
    steps = MESH_TRAIN_ROWS // MESH_TRAIN["batch_size"]
    base = {}
    for dtype in (torch.float64, torch.float32):
        runs = {}
        for name, mesh in (("one_slot", None), *meshes.items()):
            kan = FixedKAN.load_model(model_file, device=device)
            kan.params = [{k: v.to(dtype) if v.is_floating_point() else v
                           for k, v in lp.items()} for lp in kan.params]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses = kan.train(xs.to(dtype), ys, mesh=mesh, **MESH_TRAIN)
            torch.cuda.synchronize()
            runs[name] = (np.asarray(losses), kan.params,
                          (time.perf_counter() - t0) * 1e3 / steps)
        base[dtype] = runs["one_slot"]
        base_l, base_p, base_ms = base[dtype]

        def gaps(l, p, ref_l, ref_p):
            """(max relative loss gap, max |coefficient gap|)"""
            return (float(np.max(np.abs(l - ref_l) / np.abs(ref_l))),
                    max(float((a["coefficients"].double()
                               - b["coefficients"].double()).abs().max())
                        for a, b in zip(p, ref_p)))

        coef_scale = max(float(b["coefficients"].abs().max())
                         for b in base_p)
        if dtype == torch.float64:
            bars = (1e-9, 1e-9 * coef_scale)
        else:
            # float32: the JAX test's bars (rtol 1e-5, atol 1e-6) are
            # logged; a 1e-6 absolute bar is an ulp at this model's
            # max|c|, so the run is held as phase 7 holds its float32
            # runs: within FLOOR_FACTOR x the gap between the one-slot
            # run in float32 and in float64 (what float32 rounding alone
            # moves the trajectory by)
            floor = gaps(base_l, base_p, *base[torch.float64][:2])
            bars = (FLOOR_FACTOR * floor[0], FLOOR_FACTOR * floor[1])
        for name in meshes:
            l, p, ms = runs[name]
            loss_rel, coef_abs = gaps(l, p, base_l, base_p)
            row = {"loss_rel": loss_rel, "coef_abs": coef_abs,
                   "coef_scale": coef_scale, "bars": bars,
                   "ms_per_step": ms, "one_slot_ms_per_step": base_ms}
            out[f"{name}_{str(dtype)[6:]}"] = row
            log("mesh_train", mesh=name, dtype=str(dtype)[6:], steps=steps,
                loss=f"{l[-1]:.8f}", loss_rel=f"{loss_rel:.3e}",
                loss_bar=f"{bars[0]:.3e}", coef_abs=f"{coef_abs:.3e}",
                coef_bar=f"{bars[1]:.3e}", coef_scale=f"{coef_scale:.4g}",
                within_jax_test_bars=loss_rel <= 1e-5 and coef_abs <= 1e-6,
                ms_per_step=f"{ms:.3f}", one_slot_ms_per_step=f"{base_ms:.3f}",
                phase7_xla_ms_per_step=f"{step_ms['xla']:.3f}",
                card=f"'{smi}'")
            _hold(f"train {name} {dtype} losses", loss_rel, bars[0])
            _hold(f"train {name} {dtype} coefficients", coef_abs, bars[1])
    kan = FixedKAN.load_model(model_file, device=device)
    try:
        kan.train(xs, ys, mesh=meshes["dp8"], backend="fused_dw",
                  **MESH_TRAIN)
    except ValueError as e:
        if "shard_map" not in str(e):
            raise
    else:
        raise AssertionError("train(mesh=, backend='fused_dw') ran")
    # busy share of the (dp 2, tp 4) float32 step: 8 steps under the
    # profiler, device time over host time
    kan = FixedKAN.load_model(model_file, device=device)
    rows = 8 * MESH_TRAIN["batch_size"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        kan.train(xs[:rows], ys[:rows], mesh=meshes["dp2_tp4"],
                  **MESH_TRAIN)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = device_events(prof)
    busy_us = sum(u for _, u, _ in events)
    out["dp2_tp4_busy_share"] = busy_us / wall_us
    out["dp2_tp4_launches_per_step"] = sum(c for _, _, c in events) / 8
    log("mesh_train", check="fused_dw_with_mesh_raises", raised=True,
        dp2_tp4_busy_share=f"{busy_us / wall_us:.4f}",
        dp2_tp4_device_ms_per_step=f"{busy_us / 8 / 1e3:.4f}",
        dp2_tp4_launches_per_step=out["dp2_tp4_launches_per_step"],
        card=f"'{smi}'")
    return out


def run_mesh_search(device, x, y, smi: str) -> dict:
    """18d: the sharded samplers at the flagship layer 0's QUBO size and
    ``FixedKAN.optimize(mesh=)`` of the flagship on the 10k rows."""
    out = {}
    mesh8 = make_mesh(SLOTS, devices=[device] * SLOTS)
    model = block_qubo(QUBO_FUNCS, DP1, SEED + 18)
    states = ((np.arange(2**DP1)[:, None] >> np.arange(DP1)) & 1
              ).astype(float)
    ground = sum(float(np.min(QuboModel(
        model.h[b * DP1:(b + 1) * DP1],
        model.J[b * DP1:(b + 1) * DP1, b * DP1:(b + 1) * DP1], 0.0
    ).energy(states))) for b in range(QUBO_FUNCS))
    # the tempering samplers' median-anchored cold end does not resolve
    # this instance's finest gaps: they take SA's range, as their
    # docstring says a caller needing the min-scale end does
    sa_range = anneal_sa.default_beta_range(model)
    samplers = {
        "simulated_annealing_sharded": (
            lambda: simulated_annealing_sharded(
                model, mesh8, num_reads=SHARDED_READS,
                num_sweeps=SHARDED_SWEEPS, seed=SEED), SHARDED_READS),
        "parallel_tempering_sharded": (
            lambda: parallel_tempering_sharded(
                model, mesh8, num_chains=PT_CHAINS,
                num_replicas=PT_REPLICAS, num_sweeps=SHARDED_SWEEPS,
                beta_range=sa_range, seed=SEED), PT_CHAINS * PT_REPLICAS),
        "parallel_tempering_mesh_ladder": (
            lambda: parallel_tempering_mesh_ladder(
                model, mesh8, num_chains=PT_CHAINS,
                num_replicas=PT_REPLICAS, num_sweeps=SHARDED_SWEEPS,
                beta_range=sa_range, seed=SEED),
            PT_CHAINS * PT_REPLICAS),
    }
    for name, (run, rows) in samplers.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        samples, energies = run()
        seconds = time.perf_counter() - t0
        e64 = model.energy(samples)
        hits = int(np.sum(np.abs(e64 - ground) <= GROUND_BAR
                          * max(1.0, abs(ground))))
        gap = float(np.min(e64)) - ground
        out[name] = {"rows": samples.shape[0], "gap": gap, "hits": hits,
                     "seconds": seconds}
        log("mesh_search", sampler=name, variables=model.num_variables,
            slots=SLOTS, sweeps=f"{SHARDED_SWEEPS} (cut from 1000)",
            rows=samples.shape[0], rows_expected=rows,
            ground=f"{ground:.12f}", gap=f"{gap:.3e}", hits=hits,
            seconds=f"{seconds:.3f}", card=f"'{smi}'")
        if samples.shape[0] != rows or hits == 0:
            raise AssertionError(f"{name}: {samples.shape}, gap {gap}")
    # launches a sweep: the profiler's cost grows with its events, so
    # one sweep against none
    short = [profiled_launches(lambda k=k: simulated_annealing_sharded(
        model, mesh8, num_reads=SHARDED_READS, num_sweeps=k, seed=SEED))
        for k in (0, 1)]
    per_sweep = short[1][0] - short[0][0]
    out["sa_sharded_launches_per_sweep"] = per_sweep
    out["sa_sharded_device_ms_per_sweep"] = short[1][1] - short[0][1]

    # optimize(mesh=) of the flagship, float32 as phase 15b runs it
    cfg = FixedKANConfig.preset("recommended", SHAPE, MAX_DEGREE,
                                complexity_weight=0.001)
    kans = {}
    for name, kw in (("one_slot_exact", {"solver": "exact"}),
                     ("mesh_exact", {"solver": "exact", "mesh": mesh8}),
                     ("mesh_anneal", {"mesh": mesh8,
                                      "num_sweeps": SEARCH_SWEEPS})):
        kans[name] = FixedKAN(cfg, device=device)
        t0 = time.perf_counter()
        kans[name].optimize(x, y, seed=SEED, **kw)
        torch.cuda.synchronize()
        out[f"{name}_seconds"] = time.perf_counter() - t0
    base = kans["one_slot_exact"]
    fwd_base = base(x)
    for name in ("mesh_exact", "mesh_anneal"):
        kan = kans[name]
        degrees_equal = all(torch.equal(a["degrees"], b["degrees"])
                            for a, b in zip(kan.params, base.params))
        coef_ok = all(torch.allclose(a["coefficients"], b["coefficients"],
                                     rtol=5e-2, atol=2e-2)
                      for a, b in zip(kan.params, base.params))
        coef_gap = max(float((a["coefficients"] - b["coefficients"])
                             .abs().max()) for a, b in zip(kan.params,
                                                           base.params))
        fwd_gap = float((kan(x) - fwd_base).abs().max())
        layers = [{"route": s["route"], "slots": s["slots"],
                   "sharded_sweep": s["route"] == "gram" and s["slots"] > 1,
                   "seconds": s["solve_seconds"] + s["select_seconds"]}
                  for s in kan.last_search_stats]
        out[name] = {"degrees_equal": degrees_equal, "coef_gap": coef_gap,
                     "fwd_gap": fwd_gap, "layers": layers}
        log("mesh_search", search=name, rows=x.shape[0],
            degrees_equal=degrees_equal, coef_gap=f"{coef_gap:.3e}",
            coef_bars="rtol 5e-2 atol 2e-2", fwd_gap=f"{fwd_gap:.3e}",
            fwd_bar=5e-3,
            routes=[l["route"] for l in layers],
            sharded_sweeps=[l["sharded_sweep"] for l in layers],
            s_a_layer=[f"{l['seconds']:.3f}" for l in layers],
            sweeps=SEARCH_SWEEPS if "anneal" in name else "-",
            sa_launches_per_sweep_32x6=per_sweep, card=f"'{smi}'")
        if not (degrees_equal and coef_ok and fwd_gap <= 5e-3):
            raise AssertionError(f"{name}: {out[name]}")
    return out


def run_pp(device, model, x, labels, smi: str) -> dict:
    """18e: the flagship as a lead layer and 3 one-layer stages, on 3
    slots and on (dp 2, pp 3), float64, against one slot."""
    out = {}
    p64 = [{k: v.double() if v.is_floating_point() else v
            for k, v in lp.items()} for lp in model.params]
    y = torch.nn.functional.one_hot(labels.long(), T).double()
    for name, mesh in (("pp3", Mesh([device] * 3, ("pp",))),
                       ("dp2_pp3", Mesh([device] * 6, ("dp", "pp"),
                                        (2, 3)))):
        rows = PP_MICRO * PP_MICRO_ROWS * mesh.shape.get("dp", 1)
        xb, yb = x[:rows].double(), y[:rows]
        lead, stacked = place_pipeline_params(p64, mesh)
        fwd = _rel(kan_apply_pp((lead, stacked), xb, MAX_DEGREE, mesh,
                                microbatches=PP_MICRO),
                   kan_apply(p64, xb, MAX_DEGREE))
        step = make_pp_train_step(mesh, MAX_DEGREE,
                                  microbatches=PP_MICRO)
        lead_t = {k: v for k, v in lead.items() if k != "degrees"}
        st_t = {k: v for k, v in stacked.items() if k != "degrees"}
        degrees = [lp["degrees"] for lp in p64]

        def as_layers(lead_t, st_t):
            """The pipeline's parameters as the layer list, unpadded."""
            full = gather_shards(st_t)
            outs = [len(lp["horizontal_weights"]) for lp in p64[1:]]
            return [lead_t] + [{k: full[k][s, 0][:o] for k in full}
                               for s, o in enumerate(outs)]

        loss_gap, param_gap, pp_s = 0.0, 0.0, 0.0
        for _ in range(2):
            start = as_layers(lead_t, st_t)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (lead_t, st_t), loss = step(lead_t, lead["degrees"], st_t,
                                        stacked["degrees"], xb, yb)
            torch.cuda.synchronize()
            pp_s += time.perf_counter() - t0
            leaves = [{k: v.detach().requires_grad_() for k, v in lp.items()}
                      for lp in start]
            full = [dict(lv, degrees=d) for lv, d in zip(leaves, degrees)]
            l_ref = torch.mean((kan_apply(full, xb, MAX_DEGREE) - yb) ** 2)
            grads = iter(torch.autograd.grad(
                l_ref, [v for lv in leaves for v in lv.values()]))
            ref = [{k: (v - 1e-3 * next(grads)).detach()
                    for k, v in lv.items()} for lv in leaves]
            l_ref = float(l_ref.detach())
            loss_gap = max(loss_gap, abs(float(loss) - l_ref)
                           / max(1.0, abs(l_ref)))
            param_gap = max(param_gap,
                            _tree_gap(as_layers(lead_t, st_t), ref))
        out[name] = {"rows": rows, "fwd_rel_err": fwd, "loss_gap": loss_gap,
                     "param_gap": param_gap, "ms_per_step": pp_s * 1e3 / 2}
        log("pp", mesh=name, stages=3, microbatches=PP_MICRO,
            microbatch_rows=PP_MICRO_ROWS, rows=rows,
            fwd_rel_err=f"{fwd:.3e}", loss_gap=f"{loss_gap:.3e}",
            param_gap=f"{param_gap:.3e}",
            bars="1e-10 max|y| / 1e-12 max(1, |loss|) / 1e-10 max(1, max|p|)",
            ms_per_step=f"{pp_s * 1e3 / 2:.3f}", card=f"'{smi}'")
        _hold(f"pp {name} forward", fwd, 1e-10)
        _hold(f"pp {name} loss", loss_gap, 1e-12)
        _hold(f"pp {name} params", param_gap, 1e-10)
    return out


def run_diagnostics(device, model_file, model, x, tp_params, paths: dict,
                    smi: str) -> dict:
    """18f: analyze_network, the checkpoint helpers, the sparsity metrics,
    the native statevector oracle against the card's ``sim``, and the
    dry run of every multi-device path."""
    out = {}
    m64 = FixedKAN(model.config, device=device)
    m64.params = [{k: v.double() if v.is_floating_point() else v
                   for k, v in lp.items()} for lp in model.params]
    xb = x[:TP_ROWS].double()
    analysis = m64.analyze_network(xb)
    last = analysis[f"layer_{len(SHAPE) - 2}"]["combined_output"]
    out["analyze_rel_err_f64"] = _rel(last, kan_apply(m64.params, xb,
                                                      MAX_DEGREE))
    info = extract_degrees_from_checkpoint(model_file, device=device)
    degrees_equal = all(np.array_equal(l["degrees"],
                                       lp["degrees"].cpu().numpy())
                        for l, lp in zip(info["layers"], model.params))
    stats = compute_model_stats(info)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        pq_path = str(tmp / "market.parquet")
        generate_market_parquet(pq_path, n_rows=SPARSITY_ROWS,
                                n_features=79, seed=SEED)
        t0 = time.perf_counter()
        metrics = compute_sparsity(pq_path)
        sparsity_s = time.perf_counter() - t0
        cols = market_columns(n_rows=SPARSITY_ROWS, n_features=79,
                              seed=SEED)
        feats = [k for k in cols if k.startswith("feature_")]
        want = sum(int(np.isnan(cols[k]).sum()) for k in feats) / (
            len(feats) * SPARSITY_ROWS)
        ckpt = tmp / "tp_params.pt"
        save_pytree(str(ckpt), tp_params)
        back = load_pytree(str(ckpt), target=tp_params)
    bit_equal = all(
        torch.equal(a, b) and a.device == b.device
        for a, b in zip(tree_tensors(back), tree_tensors(tp_params)))
    out.update(extract_degrees_equal=degrees_equal,
               degree_histogram=stats["degree_histogram"],
               sparsity_overall=metrics.overall_sparsity,
               sparsity_expected=want, sparsity_seconds=sparsity_s,
               pytree_bit_equal=bit_equal)
    log("diagnostics", analyze_rel_err_f64=f"{out['analyze_rel_err_f64']:.3e}",
        bar=1e-10, extract_degrees_equal=degrees_equal,
        degree_histogram=stats["degree_histogram"],
        sparsity=f"{metrics.overall_sparsity:.6f}",
        sparsity_expected=f"{want:.6f}", sparsity_rows=SPARSITY_ROWS,
        sparsity_s=f"{sparsity_s:.3f}", pytree_bit_equal=bit_equal,
        card=f"'{smi}'")
    _hold("analyze_network", out["analyze_rel_err_f64"], 1e-10)
    if not (degrees_equal and bit_equal
            and metrics.overall_sparsity == want
            and len(metrics.column_sparsity) == 79):
        raise AssertionError(f"diagnostics: {out}")

    # the native statevector (host C++) against the card's simulator
    a = np.random.default_rng(SEED + 18).uniform(-1, 1, (SV_FABLE_N,
                                                         SV_FABLE_N))
    circ, _ = fable(a)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    psi = simulate(circ, dtype=torch.float64, device=device)
    torch.cuda.synchronize()
    sim_ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    paths["native_oracle_sim"] = counts
    t0 = time.perf_counter()
    ref = statevector_native(circ)
    native_ms = (time.perf_counter() - t0) * 1e3
    err = float(np.max(np.abs(psi.cpu().numpy() - ref)))
    launched = {k: v for k, v in counts.items() if v}
    out.update(native_sv_qubits=circ.num_qubits, native_sv_err=err,
               native_sv_kernels=launched, sim_ms=sim_ms,
               native_ms=native_ms)
    log("diagnostics", check="statevector_native_vs_sim",
        qubits=circ.num_qubits, gates=len(circ.gates), err=f"{err:.3e}",
        bar=1e-12, kernels=launched, sim_ms=f"{sim_ms:.3f}",
        native_host_ms=f"{native_ms:.3f}", card=f"'{smi}'")
    _hold("statevector_native vs sim", err, 1e-12)
    if not launched:
        raise AssertionError("the FABLE run launched no statevector kernel")

    t0 = time.perf_counter()
    dry = dryrun_multichip(SLOTS, devices=[device] * SLOTS)
    out["dryrun"] = {**dry, "seconds": time.perf_counter() - t0}
    return out


def run_multi_device(device, model_file, paths: dict, step_ms: dict,
                     smi: str) -> dict:
    """Phase 18 on 8 slots of the card and 15c's trained flagship."""
    x_np, labels_np, meta = load_digits_784(train=True,
                                            augment_to=SEARCH_ROWS,
                                            seed=SEED)
    x = torch.as_tensor(x_np, dtype=torch.float32, device=device)
    labels = torch.as_tensor(labels_np, device=device)
    model = FixedKAN.load_model(model_file, device=device)
    out = {"data": meta["source"], "rows": int(x.shape[0])}
    t0 = time.perf_counter()
    out["tp"], tp_params = run_tp(device, model, x, labels, smi)
    out["mesh_train"] = run_mesh_train(device, model_file, x, labels,
                                       step_ms, smi)
    y = torch.as_tensor(to_one_hot(labels_np, T), dtype=torch.float32,
                        device=device)
    out["mesh_search"] = run_mesh_search(device, x, y, smi)
    out["pp"] = run_pp(device, model, x, labels, smi)
    out["diagnostics"] = run_diagnostics(device, model_file, model, x,
                                         tp_params, paths, smi)
    out["seconds"] = time.perf_counter() - t0
    log("multi_device", seconds=f"{out['seconds']:.2f}", card=f"'{smi}'")
    return out


def main() -> int:
    device = resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("device", name=f"'{torch.cuda.get_device_name(0)}'",
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda, tf32="off")

    for group, load in (("kernels", _cuda_build.load_library),
                        ("anneal", _cuda_build.load_anneal_library)):
        start = time.perf_counter()
        load()
        ptxas = _cuda_build.ptxas_log_path(group).read_text()
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", ptxas)]
        spills = [m for m in re.findall(r"(\d+) bytes spill stores", ptxas)
                  if m != "0"]
        log("build", seconds=f"{time.perf_counter() - start:.2f}",
            library=_cuda_build.library_path(group).name, kernels=len(regs),
            max_registers=max(regs), kernels_spilling=len(spills))

    errs = {"fused_dw_fwd": check_kernel(device)}
    errs["fused_dw_fwd"] = max(errs["fused_dw_fwd"],
                               check_forward_shapes(device))
    time_kernel(device, smi)
    paths = {}
    with tempfile.TemporaryDirectory() as tmp:
        paths["serve"], _ = run_slice(device, Path(tmp))
        errs.update(check_backward(device))
        for name, err in check_backward_shapes(device).items():
            errs[name] = max(errs[name], err)
        wide_errs = check_wide(device)
        table = time_all(device, smi)
        pass_table = time_passes(pass_cases(device, "dw"), smi)
        train_paths, step_ms = run_training(device, Path(tmp))
        profile_device_time(device, Path(tmp), smi)
    paths.update(train_paths)
    sv_errs = check_statevector_kernels(device)
    quantum_paths, quantum_ms, quantum_calls = run_quantum_slice(device)
    paths.update(quantum_paths)
    sv_table, sv_timed_errs = time_statevector(device, smi)
    ucry_table = time_ucry_launch_shapes(device, smi)
    for name, err in sv_timed_errs.items():
        sv_errs[name] = max(sv_errs[name], err)
    profile_quantum(quantum_calls, smi)
    del quantum_calls
    errs["fused_step"] = check_step_kernel(device)
    for name, err in wide_errs.items():
        errs[name] = max(errs.get(name, 0.0), err)
    headline_ms = run_headline(device, paths)
    step_table = time_step(device, smi)
    run_qlayer_cell(device, paths)
    pass_table.update(time_passes(pass_cases(device, "k5"), smi))
    m3_errs = check_m3_kernels(device)
    check_m3_batch_bits(device)
    for name in M3_KERNELS:
        m3_errs[name] = max(m3_errs[name], wide_errs[name])
    m3_chain_ms = run_m3_chain(device, paths)
    m3_table = time_m3(device, smi, step_table)
    pass_table.update(time_passes(pass_cases(device, "dm"), smi))
    backward_table = time_backwards(device, smi)
    mesh8 = make_mesh(SLOTS, devices=[device] * SLOTS)
    exchange_err = check_exchange_kernel(device)
    sharded_ms = run_sharded_layer(device, mesh8, paths)
    sharded_ms.update(run_sharded_scale(device, mesh8, paths, smi))
    exchange_table, timed_err = time_exchange(device, smi)
    exchange_err = max(exchange_err, timed_err)
    anneal_ms = check_annealers(device, smi)
    s1_err, s1_table = check_blocked_kernel(device, smi)
    s2_err, s2_table = check_polish_kernel(device, smi)
    search = run_structure_search(device, paths, smi)
    with tempfile.TemporaryDirectory() as tmp:
        model_file, flagship = run_flagship(device, Path(tmp), paths, smi)
        int8 = run_int8_serving(device, model_file,
                                flagship["test_accuracy"], paths, smi)
        market = {"search": run_market_search(device, paths, smi),
                  "harness": run_harness(device, paths, smi)}
        multi = run_multi_device(device, model_file, paths, step_ms, smi)

    sources = {
        "fused_dw_fwd": ("csrc/fused_dw_fwd.cu", "ops/fused_layer.py:447"),
        # the backwards' main-path kernel: the tensor-core one
        "fused_dw_bwd": ("csrc/fused_dw_bwd_tc.cu",
                         "ops/fused_layer.py:462"),
        "fused_fwd": ("csrc/fused_dw_fwd.cu", "ops/fused_layer.py:117"),
        "fused_bwd": ("csrc/fused_dw_bwd_tc.cu", "ops/fused_layer.py:143"),
    }
    kernels = []
    for name, (src, tpu) in sources.items():
        t = table[(name, SHAPE[0], T, 4096)]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"qkan_implementation_tpu_torch/{src}",
            "replaces": f"qkan_implementation_tpu/{tpu}",
            "launches": sum(c[name] for c in paths.values()),
            "launches_by_path": {p: c[name] for p, c in paths.items()},
            "max_abs_err": errs[name],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_us": t["bound_ms"] * 1e3,
            "bound_by": t["bound_by"],
            "bound_fp32_ms": t["bound_fp32_ms"],
            "library_ms": t["library_ms"],
            "device_us": t["device_us"],
            "at": f"x[4096,784] @ w2[{DP1 * 784},{T}], 'high', f32: the "
                  "flagship checkpoint's layer 0",
            "at_shapes": {
                f"x[{b},{n}] T {t_dim}": {
                    k: row[k] for k in ("ms", "device_us", "plain_ms",
                                        "bound_ms", "bound_by",
                                        "bound_fp32_ms", "tensor_cores",
                                        "chunk")}
                for (nm, n, t_dim, b), row in table.items() if nm == name},
        })
    # the two fixed-order passes, one kernel: the cross-block sums that the
    # TPU grids carried in dw_ref / dm_ref across their sequential steps
    for name, tpu, head, err in (
            ("fused_bwd_partial_sum", "ops/fused_layer.py:469", DW_HEAD,
             errs["fused_bwd_partial_sum"]),
            ("m3_dm_sum", "experimental/pallas_layer.py:83", DM_HEAD,
             m3_errs["m3_dm_sum"])):
        t = pass_table[head]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "qkan_implementation_tpu_torch/csrc/partial_sum.cu",
            "replaces": f"qkan_implementation_tpu/{tpu}",
            "launches": sum(c[name] for c in paths.values()),
            "launches_by_path": {p: c[name] for p, c in paths.items()
                                 if c[name]},
            "max_abs_err": max(err, *(r["max_abs_err"]
                                      for k, r in pass_table.items()
                                      if k[:2] == head[:2])),
            **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms", "device_us",
                                 "library_device_us")},
            "bound_us": t["bound_ms"] * 1e3,
            "at": head,
            "at_pass_shapes": {k: v for k, v in pass_table.items()
                               if k[:2] == head[:2]},
        })
    for name, (tpu, counters, _) in SV_KERNELS.items():
        t, t21 = sv_table[(name, 27)], sv_table[(name, 21)]
        by_path = {p: sum(c[k] for k in counters) for p, c in paths.items()}
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "qkan_implementation_tpu_torch/csrc/statevector.cu",
            "replaces": f"qkan_implementation_tpu/{tpu}",
            "launches": sum(by_path.values()),
            "launches_by_path": {p: n for p, n in by_path.items() if n},
            "max_abs_err": sv_errs[name],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_us": t["bound_ms"] * 1e3,
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "device_us": t["device_us"],
            "host_us": t["host_us"],
            "library_host_us": t["library_host_us"],
            "library_device_us": t["library_device_us"],
            "at": "psi[2^27] f32 (HBM)",
            "at_21_qubits_l2": {k: t21[k] for k in (
                "ms", "plain_ms", "bound_ms", "library_ms", "device_us",
                "host_us", "library_host_us", "library_device_us")},
        })
        if name == "ucry":
            kernels[-1]["at_launch_shapes"] = ucry_table
        if not kernels[-1]["launches"]:
            raise AssertionError(f"{name} was never launched on a main path")
    t, t0 = step_table["headline"], step_table["layer0_B4096_mse"]
    kernels.append({
        "name": "fused_step",
        "route": "cuda",
        "source": "qkan_implementation_tpu_torch/csrc/fused_dw_bwd.cu",
        "replaces": "qkan_implementation_tpu/ops/fused_layer.py:297",
        "launches": sum(c["fused_step"] for c in paths.values()),
        "launches_by_path": {p: c["fused_step"] for p, c in paths.items()
                             if c["fused_step"]},
        "max_abs_err": errs["fused_step"],
        **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                             "bound_units", "bound_fp32_ms", "library_ms",
                             "device_us", "device_us_call", "pair_ms",
                             "pair_device_us", "torch_ops_ms",
                             "torch_ops_device_us")},
        "bound_us": t["bound_ms"] * 1e3,
        "at": f"x[{HB},{HN}], dp1 {HDEG + 1}, T {HK}, no tanh, 'sumsq', f32",
        "at_layer0_B4096_mse": t0,
        "at_layer0_T32_B4096_mse": step_table["layer0_T32_B4096_mse"],
    })
    head, wide = (f"B{HB}_N{HN}_K{HK}_dp1_{HDEG + 1}",
                  "B{}_N{}_K{}_dp1_{}".format(*M3_WIDE))
    for name, (tpu, *_) in M3_KERNELS.items():
        t = m3_table[(name, head)]
        src = ("qkan_layer_m3_tc.cu" if t["kernel_route"] == "tensor cores"
               else "qkan_layer_m3.cu")
        kernels.append({
            "name": name,
            "route": "cuda",
            # the units the call ran on, from the profiler's kernel names
            # (held to ``m3_tc_plan``); route stays "cuda"
            "kernel_route": t["kernel_route"],
            "source": f"qkan_implementation_tpu_torch/csrc/{src}",
            "replaces": f"qkan_implementation_tpu/{tpu}",
            "launches": sum(c[name] for c in paths.values()),
            "launches_by_path": {p: c[name] for p, c in paths.items()
                                 if c[name]},
            "max_abs_err": m3_errs[name],
            **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "bound_units", "bound_fp32_ms",
                                 "library_ms", "device_us")},
            "bound_us": t["bound_ms"] * 1e3,
            "at": f"x[{HB},{HN}], dp1 {HDEG + 1}, K {HK}, f32",
            f"at_{wide}": m3_table[(name, wide)],
        })
    by_path = {p: c["exchange_ucry"] + c["exchange_h"]
               for p, c in paths.items()}
    t, th = exchange_table["ucry"], exchange_table["h"]
    kernels.append({
        "name": "exchange",
        "route": "cuda",
        "source": "qkan_implementation_tpu_torch/csrc/exchange.cu",
        "replaces": "qkan_implementation_tpu/sim/rdma.py:80",
        "launches": sum(by_path.values()),
        "launches_by_path": {p: n for p, n in by_path.items() if n},
        "max_abs_err": exchange_err,
        **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                             "library_ms", "device_us", "collective_ms",
                             "collective_device_us")},
        "bound_us": t["bound_ms"] * 1e3,
        "at": f"{SLOTS} slots x psi[2^24] f32 (27 qubits), dev_bit 2, ucry; "
              "one exchange = 8 launches",
        "h": {**th, "bound_us": th["bound_ms"] * 1e3},
    })
    by_path = {p: c["anneal_blocked"] for p, c in paths.items()}
    t = s1_table["digits_layer0"]
    kernels.append({
        "name": "anneal_blocked",
        "route": "cuda",
        "source": "qkan_implementation_tpu_torch/csrc/anneal_blocked.cu",
        "replaces": "qkan_implementation_tpu/anneal/sa.py:428",
        "launches": sum(by_path.values()),
        "launches_by_path": {p: n for p, n in by_path.items() if n},
        "max_abs_err": s1_err,
        **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                             "device_us", "us_per_sweep",
                             "device_us_per_sweep")},
        "bound_us": t["bound_ms"] * 1e3,
        "library_ms": None,
        "at": f"one chunk of {t['sweeps']} sweeps, bs {t['bs']}, nb "
              f"{t['nb']}, {t['reads']} reads, f32: digits-search layer 0",
        "at_shapes": s1_table,
    })
    # S2: one library call (two launches) a polish on the card
    by_path = {p: c["anneal_polish"] for p, c in paths.items()}
    t = s2_table["digits_layer0"]
    kernels.append({
        "name": "anneal_polish",
        "route": "cuda",
        "source": "qkan_implementation_tpu_torch/csrc/anneal_blocked.cu",
        "replaces": "qkan_implementation_tpu/anneal/sa.py:990 (numpy, host)",
        "launches": sum(by_path.values()),
        "launches_by_path": {p: n for p, n in by_path.items() if n},
        "energy_rel_gap": s2_err,
        **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                             "device_us", "host_ms", "numpy_ms")},
        "bound_us": t["bound_ms"] * 1e3,
        "library_ms": None,
        "at": f"bs {t['bs']}, nb {t['nb']}, {t['reads']} reads, f32 state: "
              "digits-search layer 0",
        "at_shapes": s2_table,
    })
    for name in [*sources, "fused_bwd_partial_sum", "fused_step",
                 *M3_KERNELS, "m3_dm_sum", "exchange_ucry",
                 "exchange_h", "anneal_blocked", "anneal_polish"]:
        if not any(c[name] for c in paths.values()):
            raise AssertionError(f"{name} was never launched on a main path")
    print(f"train_step_ms {json.dumps(step_ms)} batch={TRAIN_BATCH} "
          f"card='{smi}'", flush=True)
    print(f"quantum_ms {json.dumps(quantum_ms)} card='{smi}'", flush=True)
    print(json.dumps({"headline_step": {
        "path_ms": headline_ms, "steps": HSTEPS, "batch": HB, **{
            f"{shape}_{k}": v for shape, row in step_table.items()
            for k, v in row.items() if k.endswith(("ms", "_us"))},
        "card": smi}}), flush=True)
    print(json.dumps({"m3_layer": {
        "chain_ms_per_step": m3_chain_ms / HSTEPS, "steps": HSTEPS,
        "batch": HB, **{k: m3_table[k] for k in (
            "m3_step_from_w", "m3_step_from_m3", "m3_step_both_args")},
        "card": smi}}), flush=True)
    print(json.dumps({"backwards_one_call": {**backward_table,
                                             "card": smi}}), flush=True)
    print(json.dumps({"sharded": {**sharded_ms, "slots": SLOTS,
                                  "card": smi}}), flush=True)
    print(json.dumps({"structure_search": {
        "annealers": anneal_ms, **search, "flagship": flagship,
        "card": smi}}), flush=True)
    print(json.dumps({"int8_serving": {**int8, "card": smi}}), flush=True)
    print(json.dumps({"market": {**market, "card": smi}}), flush=True)
    print(json.dumps({"multi_device": {**multi, "card": smi}}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
