"""Time the redesigned K5 (the fused train step) and K9 (the diagonal
multiply) against their versions at commit 0bac587, on the same inputs,
in one process on one CUDA card:

    python tools/step_diag_vs_old.py [--out PATH.json]

K5: ``csrc/fused_dw_bwd.cu`` and ``csrc/partial_sum.cu`` are compiled
three times: as the package builds them ('new'), with
``-DQKAN_STEP_TC=0`` ('old': every shape takes the CUDA-core
``fused_step_kernel`` on K2's layout, the step as it was at 0bac587),
and with ``-DQKAN_STEP_TIMING`` ('timed': the new kernel with thread 0's
clock64() cycles of each phase of a tile).  K9: the earlier
``diag_kernel`` (scalar loads in a grid-stride loop capped at 8 blocks
of 256 threads an SM) is kept below as it was, beside the package's
``qkan_diag_mult``; and the 16-byte designs that were weighed for it (1,
2, 4 or 8 vectors a thread, with and without the streaming hints
``__ldcs`` / ``__stcs``; the package's is 1, none) are timed beside
``torch.mul`` by device µs (f32, shared d).

Each version is first held to the plain version (K5: dW within 1e-4
max|dW| + 1e-5 and the loss within rtol 1e-4, twice with the same bits;
K9: equal to ``psi * d`` bit for bit).  Then the versions of a case are
timed in turns: median CUDA-event ms of one call through the same
wrapper, device µs a call from torch.profiler, and (K9) host µs a call
and ``torch.mul``'s three numbers; then K9's wrapper is taken apart into
its host pieces (checks, allocation, the ctypes call with the launch)
beside ``torch.mul``.  Prints one line a (case, version), the phase
split of the new K5, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from qkan_implementation_tpu_torch.experimental.pallas_layer import (  # noqa: E402
    weights_to_m3,
)
from qkan_implementation_tpu_torch.ops import _cuda_build as cb  # noqa: E402
from qkan_implementation_tpu_torch.ops.fused_layer import (  # noqa: E402
    _step_scales,
    kan_train_step_fused_reference,
)
from qkan_implementation_tpu_torch.sim import pallas_kernels as pk  # noqa: E402

OLD_DIAG_SRC = r"""
#include <cuda_runtime.h>

constexpr int THREADS = 256;

inline int stream_grid(long long total, int threads, int per_sm = 8) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess) {
    sms = 132;
  }
  const long long want = (total + threads - 1) / threads;
  const long long cap = (long long)sms * per_sm;
  return (int)(want < cap ? want : cap);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
diag_kernel(const T* __restrict__ psi, const T* __restrict__ d,
            T* __restrict__ out, long long total, int log_dim,
            long long diag_stride) {
  const long long mask = (1LL << log_dim) - 1;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += step) {
    const long long b = idx >> log_dim;
    out[idx] = psi[idx] * d[b * diag_stride + (idx & mask)];
  }
}

extern "C" int old_diag_mult(const void* psi, const void* d, void* out,
                             long long batch, int log_dim,
                             long long diag_stride, int is_f64,
                             void* stream) {
  const long long total = batch << log_dim;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_f64) {
    diag_kernel<double><<<stream_grid(total, THREADS), THREADS, 0, st>>>(
        (const double*)psi, (const double*)d, (double*)out, total, log_dim,
        diag_stride);
  } else {
    diag_kernel<float><<<stream_grid(total, THREADS), THREADS, 0, st>>>(
        (const float*)psi, (const float*)d, (float*)out, total, log_dim,
        diag_stride);
  }
  return (int)cudaGetLastError();
}
"""

VARIANT_SRC = r"""
#include <cuda_runtime.h>

// psi * d over float4s, U vectors a thread, HINTS: __ldcs / __stcs
template <int U, bool HINTS>
__global__ void __launch_bounds__(256)
diag_variant_kernel(const float4* __restrict__ psi, const float* __restrict__ d,
                    float4* __restrict__ out, long long items, int log_dim) {
  const long long mask = (1LL << log_dim) - 1;
  const long long first = (long long)blockIdx.x * (256 * U) + threadIdx.x;
  float4 p[U], q[U];
#pragma unroll
  for (int j = 0; j < U; ++j) {
    const long long v = first + (long long)j * 256;
    if (v < items) {
      const float4* dv = reinterpret_cast<const float4*>(d + ((v * 4) & mask));
      p[j] = HINTS ? __ldcs(psi + v) : psi[v];
      q[j] = *dv;
    }
  }
#pragma unroll
  for (int j = 0; j < U; ++j) {
    const long long v = first + (long long)j * 256;
    if (v < items) {
      const float4 r = make_float4(p[j].x * q[j].x, p[j].y * q[j].y,
                                   p[j].z * q[j].z, p[j].w * q[j].w);
      if (HINTS) {
        __stcs(out + v, r);
      } else {
        out[v] = r;
      }
    }
  }
}

template <int U, bool HINTS>
int run(const void* psi, const void* d, void* out, long long n, int log_dim,
        void* stream) {
  const long long items = n / 4, blocks = (items + 256 * U - 1) / (256 * U);
  diag_variant_kernel<U, HINTS><<<(unsigned)blocks, 256, 0,
                                  (cudaStream_t)stream>>>(
      (const float4*)psi, (const float*)d, (float4*)out, items, log_dim);
  return (int)cudaGetLastError();
}

extern "C" int diag_variant(int k, const void* psi, const void* d, void* out,
                            long long n, int log_dim, void* stream) {
  switch (k) {
    case 0: return run<1, false>(psi, d, out, n, log_dim, stream);
    case 1: return run<2, false>(psi, d, out, n, log_dim, stream);
    case 2: return run<4, false>(psi, d, out, n, log_dim, stream);
    case 3: return run<8, false>(psi, d, out, n, log_dim, stream);
    case 4: return run<1, true>(psi, d, out, n, log_dim, stream);
    case 5: return run<4, true>(psi, d, out, n, log_dim, stream);
  }
  return (int)cudaErrorInvalidValue;
}
"""
VARIANTS = ("u1", "u2", "u4", "u8", "u1_hints", "u4_hints")

# K5 builds: name -> extra nvcc flags
STEP_BUILDS = {"old": ["-DQKAN_STEP_TC=0"], "timed": ["-DQKAN_STEP_TIMING"]}
PHASES = ("x_wait", "basis", "forward_g", "dw", "start_end")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, as chip_smoke.py's bound()
FP32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
SEED = 10


def build(workdir: Path) -> dict:
    """The K5 libraries of STEP_BUILDS, the earlier K9 and its variants,
    compiled at once."""
    nvcc = cb.find_nvcc()
    (workdir / "old_diag.cu").write_text(OLD_DIAG_SRC)
    (workdir / "diag_variants.cu").write_text(VARIANT_SRC)
    flags = [*cb.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
             "-shared"]
    cmds = {name: [nvcc, *flags, "-o", str(workdir / f"{name}.so"),
                   str(workdir / f"{name}.cu")]
            for name in ("old_diag", "diag_variants")}
    for name, extra in STEP_BUILDS.items():
        cmds[name] = [nvcc, *flags, *extra, "-I", str(cb.CSRC_DIR), "-o",
                      str(workdir / f"{name}.so"),
                      str(cb.CSRC_DIR / "fused_dw_bwd.cu"),
                      str(cb.CSRC_DIR / "partial_sum.cu")]
    cb._run_all(list(cmds.values()))
    p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
    libs = {}
    for name in cmds:
        lib = ctypes.CDLL(str(workdir / f"{name}.so"))
        if name == "old_diag":
            lib.old_diag_mult.argtypes = [p, p, p, ll, i, ll, i, p]
        elif name == "diag_variants":
            lib.diag_variant.argtypes = [i, p, p, p, ll, i, p]
        else:
            lib.qkan_fused_step_workspace_bytes.argtypes = [i, i, i, i]
            lib.qkan_fused_step_workspace_bytes.restype = ll
            lib.qkan_fused_step.argtypes = [p, p, p, p, p, ll, i, i, i, i, i,
                                            i, f, f, p, p]
        if name == "timed":
            lib.qkan_step_phase_cycles.argtypes = [
                ctypes.POINTER(ctypes.c_ulonglong)]
        libs[name] = lib
    libs["new"] = cb.load_library()
    return libs


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def step_call(lib, x, w2, dp1, y, loss, tanh):
    """One train step through ``lib``'s ``qkan_fused_step``, as the
    package's wrapper makes it: (loss, dW)."""
    b, n = x.shape
    t_dim = w2.shape[1]
    ws_bytes = lib.qkan_fused_step_workspace_bytes(b, n, dp1, t_dim)
    ws = torch.empty(ws_bytes, dtype=torch.uint8, device=x.device)
    loss_out = torch.empty((), dtype=torch.float32, device=x.device)
    dw = torch.empty((dp1 * n, t_dim), dtype=torch.float32, device=x.device)
    g_scale, loss_scale = _step_scales(b, t_dim, loss)
    _check(lib.qkan_fused_step(
        x.data_ptr(), w2.data_ptr(), None if y is None else y.data_ptr(),
        loss_out.data_ptr(), ws.data_ptr(), ws_bytes, b, n, dp1, t_dim,
        int(x.dtype == torch.bfloat16), int(tanh), g_scale, loss_scale,
        dw.data_ptr(), _stream()), "qkan_fused_step")
    return loss_out, dw


def step_cases(device) -> dict:
    """name -> (args of the step, bound µs by bytes, FP32, 3xTF32)."""
    rng = np.random.default_rng(SEED)
    cases = {}
    x = torch.from_numpy(rng.uniform(-1, 1, (262144, 16)).astype(np.float32))
    w = torch.from_numpy(rng.uniform(-1, 1, (8, 256)).astype(np.float32))
    w2 = weights_to_m3(w, 16, 16).reshape(-1, 16).contiguous()
    cases["headline"] = (x.to(device), w2.to(device), 8, None, "sumsq", False)
    cases["headline_bf16_x"] = (x.to(device, torch.bfloat16), w2.to(device),
                                8, None, "sumsq", False)
    b, n, dp1, t_dim = 4096, 784, 6, 10
    x = torch.from_numpy(rng.uniform(-2, 2, (b, n)).astype(np.float32))
    w2 = torch.from_numpy(rng.normal(0, 1 / np.sqrt(dp1 * n), (dp1 * n, t_dim))
                          .astype(np.float32))
    y = torch.from_numpy(rng.normal(size=(b, t_dim)).astype(np.float32))
    cases["layer0_B4096_mse"] = (x.to(device), w2.to(device), dp1,
                                 y.to(device), "mse", True)
    out = {}
    for name, args in cases.items():
        x, w2, dp1, y = args[:4]
        b, n = x.shape
        t_dim = w2.shape[1]
        moved = (x.element_size() * b * n + 4 * 2 * dp1 * n * t_dim + 4
                 + (4 * b * t_dim if y is not None else 0))
        flops = 2 * 2.0 * b * n * (dp1 - 1) * t_dim
        out[name] = (args, moved / HBM_BYTES_PER_S * 1e6,
                     flops / FP32_FLOP_PER_S * 1e6,
                     3 * flops / TF32_FLOP_PER_S * 1e6)
    return out


def device_us(fn, calls: int = 20) -> dict:
    """Device µs a call of ``fn`` by kernel (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        by = {}
        for ev in prof.key_averages():
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = getattr(ev, "self_device_time_total", None)
            us = float(ev.self_cuda_time_total if us is None else us)
            if us > 0:
                by[ev.key] = by.get(ev.key, 0.0) + us / calls
        if by:
            return by
    return {}


def event_ms(fns: dict, reps: int = 40, warm: int = 5) -> dict:
    """Median CUDA-event ms of one call of each, all called in turns."""
    names = list(fns)
    for _ in range(warm):
        for f in fns.values():
            f()
    torch.cuda.synchronize()
    times = {k: [] for k in names}
    for r in range(reps):
        order = names[r % len(names):] + names[:r % len(names)]
        for k in order:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fns[k]()
            end.record()
            end.synchronize()
            times[k].append(start.elapsed_time(end))
    return {k: float(np.median(v)) for k, v in times.items()}


def host_us(fns: dict, reps: int = 40) -> dict:
    """Median host µs from the call to its return, on an idle card, in
    turns."""
    names = list(fns)
    times = {k: [] for k in names}
    for r in range(reps):
        for k in names[r % len(names):] + names[:r % len(names)]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fns[k]()
            times[k].append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return {k: float(np.median(v)) for k, v in times.items()}


def run_steps(libs, smi: str) -> dict:
    table = {}
    for tag, (args, b_bytes, b_fp32, b_tf32) in step_cases("cuda").items():
        x, w2, dp1, y, loss, tanh = args
        want_loss, want_dw = kan_train_step_fused_reference(*args)
        fns = {}
        for name in ("old", "new"):
            lib = libs[name]

            def call(lib=lib):
                return step_call(lib, x, w2, dp1, y, loss, tanh)

            (l1, d1), (l2, d2) = call(), call()
            torch.cuda.synchronize()
            err = float((d1 - want_dw).abs().max())
            bar = 1e-4 * float(want_dw.abs().max()) + 1e-5
            rel = abs(float(l1) - float(want_loss)) / abs(float(want_loss))
            if not (err <= bar and rel <= 1e-4 and torch.equal(l1, l2)
                    and torch.equal(d1, d2)):
                raise AssertionError(f"{tag} {name}: dW {err} > {bar} or "
                                     f"loss {rel} or bits differ")
            fns[name] = call
        ms = event_ms(fns)
        row = {"bound_us_bytes": b_bytes, "bound_us_fp32": b_fp32,
               "bound_us_3xtf32": b_tf32, "versions": {}}
        for name, fn in fns.items():
            by = device_us(fn)
            step_us = sum(v for k, v in by.items() if "fused_step_kernel" in k)
            row["versions"][name] = {
                "ms": ms[name], "step_kernel_us": step_us or None,
                "call_device_us": sum(by.values()) or None}
            print(f"[step] case={tag} version={name} ms={ms[name]:.4f} "
                  f"step_kernel_us={step_us:.3f} "
                  f"call_device_us={sum(by.values()):.3f} "
                  f"bound_us bytes={b_bytes:.3f} fp32={b_fp32:.3f} "
                  f"3xtf32={b_tf32:.3f} card='{smi}'", flush=True)
        if tag.startswith("headline"):
            buf = (ctypes.c_ulonglong * 5)()
            _check(libs["timed"].qkan_step_phase_cycles(buf), "reset")
            step_call(libs["timed"], x, w2, dp1, y, loss, tanh)
            torch.cuda.synchronize()
            _check(libs["timed"].qkan_step_phase_cycles(buf), "read")
            total = sum(buf)
            row["new_phase_share"] = {p: buf[k] / total
                                      for k, p in enumerate(PHASES)}
            print(f"[step] case={tag} version=new phases " + " ".join(
                f"{p}={buf[k] / total:.3f}" for k, p in enumerate(PHASES)),
                flush=True)
        table[tag] = row
    return table


def run_diag(libs, smi: str) -> dict:
    rng = np.random.default_rng(SEED + 1)
    table = {}
    for q in (21, 27):
        n = 2**q
        psi = torch.from_numpy(rng.standard_normal(n, dtype=np.float32)).cuda()
        d = torch.from_numpy(rng.uniform(-1, 1, n).astype(np.float32)).cuda()
        out = torch.empty_like(psi)

        def old():
            _check(libs["old_diag"].old_diag_mult(
                psi.data_ptr(), d.data_ptr(), out.data_ptr(), 1, q, 0, 0,
                _stream()), "old_diag_mult")
            return out

        fns = {"old": old, "new": lambda: pk.diag_mult_pallas(psi, d),
               "torch_mul": lambda: torch.mul(psi, d)}
        want = psi * d
        for name, fn in fns.items():
            got = fn()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"diag 2^{q} {name}: not psi * d")
        ms = event_ms(fns)
        hs = host_us(fns)
        row = {"bound_us": 12.0 * n / HBM_BYTES_PER_S * 1e6, "versions": {}}
        for name, fn in fns.items():
            dev = sum(device_us(fn).values()) or None
            row["versions"][name] = {"ms": ms[name], "device_us": dev,
                                     "host_us": hs[name]}
            print(f"[diag] state=2^{q} f32 version={name} ms={ms[name]:.4f} "
                  f"device_us={dev:.3f} host_us={hs[name]:.2f} "
                  f"bound_us={row['bound_us']:.3f} card='{smi}'", flush=True)
        variants = {}
        for k, name in enumerate(VARIANTS):
            def var(k=k):
                _check(libs["diag_variants"].diag_variant(
                    k, psi.data_ptr(), d.data_ptr(), out.data_ptr(), n, q,
                    _stream()), "diag_variant")
                return out
            if not torch.equal(var(), want):
                raise AssertionError(f"diag variant {name}: not psi * d")
            variants[name] = sum(device_us(var).values()) or None
        variants["torch_mul"] = row["versions"]["torch_mul"]["device_us"]
        row["variants_device_us"] = variants
        print(f"[diag] state=2^{q} f32 variants device_us " + " ".join(
            f"{k}={v:.3f}" for k, v in variants.items()) + f" card='{smi}'",
            flush=True)
        table[f"2^{q}"] = row
    return table


def diag_host_split(smi: str) -> dict:
    """Host µs a call of K9's wrapper and of its pieces at 21 qubits (the
    main path's shape) beside ``torch.mul``'s: the median of 30 loops of
    20 calls each, the card synchronised between loops."""
    n = 2**21
    psi = torch.randn(n, device="cuda")
    d = torch.rand(n, device="cuda")
    out = torch.empty_like(psi)
    lib = pk._library()
    stream = torch._C._cuda_getCurrentRawStream

    def checks():
        pk._no_backward("k9", psi, d)
        pk._check_state(psi, "k9")
        pk._log2(n, "k9")
        return pk._rows(d, psi, n, "k9")

    pieces = {
        "wrapper": lambda: pk.diag_mult_pallas(psi, d),
        "checks": checks,
        "allocation": lambda: torch.empty_like(psi),
        "ctypes_call_and_launch": lambda: lib.qkan_diag_mult(
            psi.data_ptr(), d.data_ptr(), out.data_ptr(), 1, 21, 0, 0,
            stream(psi.get_device())),
        "torch_mul": lambda: torch.mul(psi, d),
    }
    split = {}
    for name, fn in pieces.items():
        for _ in range(50):
            fn()
        times = []
        for _ in range(30):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                fn()
            times.append((time.perf_counter() - t0) / 20 * 1e6)
        torch.cuda.synchronize()
        split[name] = float(np.median(times))
        print(f"[diag_host] state=2^21 f32 piece={name} "
              f"host_us={split[name]:.2f} card='{smi}'", flush=True)
    return split


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "not read"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = card()
    print(smi, flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(Path(tmp))
        result = {"card": smi, "step": run_steps(libs, smi),
                  "diag": run_diag(libs, smi),
                  "diag_host_split": diag_host_split(smi)}
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
