"""Smoke run of the torch port's FixedKAN serving path on one CUDA card.

    python3 chip_smoke.py

Phases, each reported on its own line:

1. device: resolve ``cuda`` (raises without a card), print the card's
   name and power limit, turn TF32 off for matmuls and cuDNN;
2. build: compile the package's CUDA kernels from ``csrc/`` with nvcc;
3. kernel vs plain: the degree-wise layer kernel against its plain torch
   version on the card, at the flagship layer shapes;
4. times: kernel and plain, median of CUDA-event-timed calls at B=4096;
5. the slice: a flagship-width [784,32,16,16,10] checkpoint with random
   weights is loaded, put behind ``BatchedPredictor`` and the HTTP server,
   and every answer is held against the FP32 ``'xla'`` backend on the
   card; the kernel's launch count must equal 4 layers x forwards.

The last line is ``{"ok": true, "device": {...}}``; the line before it is
the kernels' JSON record.  Any failed check raises and the script exits
non-zero without that line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.request
from dataclasses import asdict
from pathlib import Path

import numpy as np
import torch

from qkan_implementation_tpu_torch.models import FixedKAN, FixedKANConfig
from qkan_implementation_tpu_torch.models.fixed_kan import kan_apply
from qkan_implementation_tpu_torch.ops import _cuda_build
from qkan_implementation_tpu_torch.ops.fused_layer import (
    kan_layer_fused_dw,
    kan_layer_fused_dw_reference,
)
from qkan_implementation_tpu_torch.serving import BatchedPredictor, serve
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
BARS = {"high": (1e-4, 1e-5), "bf16": (1e-4, 1e-5)}
SLICE_RTOL = 1e-4


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


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


def layer_inputs(rng, b, n, tanh, precision, device):
    lo, hi = (-2.0, 2.0) if tanh else (-0.95, 0.95)
    x = torch.from_numpy(rng.uniform(lo, hi, (b, n)).astype(np.float32))
    w2 = torch.from_numpy(
        rng.normal(0, 1 / np.sqrt(DP1 * n), (DP1 * n, T)).astype(np.float32)
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


def run_slice(device, workdir: Path) -> tuple[int, dict]:
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
    kan_layer_fused_dw.launches = 0
    forwards = 0
    predictor.warmup()
    forwards += len(predictor.buckets)
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
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    launches = kan_layer_fused_dw.launches
    expected = (len(SHAPE) - 1) * forwards
    log("slice", forwards=forwards, launches=launches, expected=expected)
    if launches != expected:
        raise AssertionError(f"kernel launches {launches} != {expected}")

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
    return launches, stats


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

    start = time.perf_counter()
    _cuda_build.load_library()
    log("build", seconds=f"{time.perf_counter() - start:.2f}",
        library=_cuda_build.library_path().name)

    max_err = check_kernel(device)
    times = time_kernel(device, smi)
    with tempfile.TemporaryDirectory() as tmp:
        launches, _ = run_slice(device, Path(tmp))

    k_ms, p_ms = times[(784, "high")]
    print(json.dumps({"kernels": [{
        "name": "fused_dw_fwd",
        "route": "cuda",
        "source": "qkan_implementation_tpu_torch/csrc/fused_dw_fwd.cu",
        "replaces": "qkan_implementation_tpu/ops/fused_layer.py:447",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
