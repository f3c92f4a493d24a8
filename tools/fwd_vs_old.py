"""Time the forward kernels K1/K3 (``csrc/fused_dw_fwd.cu``) old beside
new, on the same inputs, in one process on one CUDA card:

    python tools/fwd_vs_old.py [--out PATH.json] [--reps N] [--ablate]

``fused_dw_fwd.cu`` and ``partial_sum.cu`` are compiled three times beside
the package's build (BUILDS): with ``-DQKAN_FWD_TC=0`` ('old': the
CUDA-core kernel of commit 8d4856a wherever it takes the shape, dp1 <= 32
and T <= 64), and as two text substitutions on the source, 'tc' (the
rule returns the tensor-core kernel at every shape) and 'timed' (the
package's rule with thread 0's clock64() cycles of each phase of the
tensor-core kernel, summed over its blocks, read by an added C entry:
printed as shares where the rule takes the tensor cores).
'new' is the package's library, whose rule (``fused_fwd_plan``) picks one
of the two by the sizes.  All go through the same C entries.

Shapes, dp1 6 (max_degree 5), at B 64 and 4096: the four layers of a
FixedKAN [784, 32, 16, 16, 10] whose layers map in -> the next width,
(in, T) = (784, 32), (32, 16), (16, 16), (16, 10); the flagship
checkpoint's own layers, which map every layer to the target width
(JAX ``fixed_kan.py``: [B, in] -> [B, target_dim]), (784, 10) and
(10, 10); and a wide shape past the old kernel's limits, x[1024, 64],
dp1 34, T 96 (new and 'tc' only).

Each version is first held to the plain version on the card ('high' f32
x, tanh on: max|kernel - plain| <= 1e-4 max|plain| + 1e-5, the bar of
tests/test_torch_cuda_kernels.py; 'bf16' and the v1 entry on a bf16 x
for the new one), twice with the same bits.  Then per (shape, version),
'high' f32: CUDA-event median ms of one call (versions in turns), device
µs a call from torch.profiler (every kernel of the call: the forward and,
past one feature split, the fixed-order pass), host µs a call (call to
return on an idle card), and the bound: bytes (x, w2, out once) over
3.35 TB/s against 2 B in (dp1-1) T flops over 67 TFLOP/s (FP32) and as
three TF32 passes over 495 TFLOP/s (3xTF32).  Prints one line a (shape,
version) and the card's ``nvidia-smi`` name and power limit.

``--ablate`` instead times variants of the tensor-core kernel's source,
each a text substitution on ``fused_dw_fwd.cu`` (ABLATIONS), beside the
package's build at the flagship's layer 0 (784 -> 10 and 784 -> 32, B 64
and 4096), device µs a call: 'no_products' and 'no_basis' drop the
mma.sync passes or the basis build (their outputs are wrong: they only
weigh a phase), 'x_early' issues the next feature chunk's x as soon as
this chunk's is read, 'w_in_products' issues the next W chunk's copies
after the barrier that opens the products (both held to the plain
version first).
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

from qkan_implementation_tpu_torch.ops import _cuda_build as cb  # noqa: E402
from qkan_implementation_tpu_torch.ops.fused_layer import (  # noqa: E402
    fused_fwd_plan,
    kan_layer_fused_dw_reference,
    kan_layer_fused_reference,
)

PHASES = ("start", "basis", "wait_w_and_basis", "products", "barrier_end")
VERSIONS = ("old", "tc", "new")
DP1 = 6
SHAPES = [(b, n, DP1, t) for n, t in ((784, 32), (32, 16), (16, 16), (16, 10),
                                      (784, 10), (10, 10))
          for b in (64, 4096)] + [(1024, 64, 34, 96)]
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, as chip_smoke.py's bound()
FP32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
BAR = (1e-4, 1e-5)
SEED = 11


def substituted(subs: list, what: str) -> str:
    """``fused_dw_fwd.cu`` with each (old, new) of ``subs`` replaced."""
    text = (cb.CSRC_DIR / "fused_dw_fwd.cu").read_text()
    for old, new in subs:
        if text.count(old) != 1:
            raise RuntimeError(f"{what}: source changed")
        text = text.replace(old, new)
    return text


def nvcc_cmds(workdir: Path, variants: dict) -> list:
    """One nvcc command a variant name -> (substitutions, flags), each
    source written to ``workdir``."""
    nvcc = cb.find_nvcc()
    flags = [*cb.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
             "-shared"]
    cmds = []
    for name, (subs, extra) in variants.items():
        src = workdir / f"{name}.cu"
        src.write_text(substituted(subs, name))
        cmds.append([nvcc, *flags, *extra, "-I", str(cb.CSRC_DIR), "-o",
                     str(workdir / f"{name}.so"), str(src),
                     str(cb.CSRC_DIR / "partial_sum.cu")])
    return cmds


def build(workdir: Path) -> dict:
    """The builds of BUILDS at once, and the package's library."""
    cb._run_all(nvcc_cmds(workdir, BUILDS))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    libs = {}
    for name in BUILDS:
        lib = ctypes.CDLL(str(workdir / f"{name}.so"))
        lib.qkan_fused_dw_fwd.argtypes = [p, p, p, p, ll, i, i, i, i, i, i, i,
                                          p]
        lib.qkan_fused_fwd.argtypes = [p, p, p, p, ll, i, i, i, i, i, i, p]
        for entry in ("qkan_fused_dw_fwd", "qkan_fused_fwd"):
            getattr(lib, entry).restype = i
        lib.qkan_fused_fwd_workspace_bytes.argtypes = [i, i, i, i]
        lib.qkan_fused_fwd_workspace_bytes.restype = ll
        lib.qkan_fused_fwd_tensor_cores.argtypes = [i, i, i, i]
        lib.qkan_fused_fwd_tensor_cores.restype = i
        if name == "timed":
            lib.qkan_fwd_phase_cycles.argtypes = [
                ctypes.POINTER(ctypes.c_ulonglong)]
        libs[name] = lib
    libs["new"] = cb.load_library()
    return libs


def fwd_call(lib, x, w2, dp1, mode: str):
    """One forward through ``lib``'s C entry, as the package's wrapper
    makes it ('high', 'bf16' or 'v1'): out [B, T] f32."""
    b, n = x.shape
    t_dim = w2.shape[1]
    ws_bytes = lib.qkan_fused_fwd_workspace_bytes(b, n, dp1, t_dim)
    ws = (torch.empty(ws_bytes, dtype=torch.uint8, device=x.device)
          if ws_bytes else None)
    out = torch.empty((b, t_dim), dtype=torch.float32, device=x.device)
    head = (x.data_ptr(), w2.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(), ws_bytes, b, n, dp1, t_dim,
            int(x.dtype == torch.bfloat16))
    stream = torch.cuda.current_stream().cuda_stream
    if mode == "v1":
        err = lib.qkan_fused_fwd(*head, 1, stream)
    else:
        err = lib.qkan_fused_dw_fwd(*head, int(mode == "bf16"), 1, stream)
    if err != 0:
        raise RuntimeError(f"forward ({mode}): CUDA error {err}")
    return out


def inputs(rng, b, n, dp1, t_dim, device):
    x = torch.from_numpy(rng.uniform(-2, 2, (b, n)).astype(np.float32))
    w2 = torch.from_numpy(rng.normal(0, 1 / np.sqrt(dp1 * n), (dp1 * n, t_dim))
                          .astype(np.float32))
    return x.to(device), w2.to(device)


def held(got, want, what: str) -> float:
    err = float((got - want).abs().max())
    bar = BAR[0] * float(want.abs().max()) + BAR[1]
    if not (bool(torch.isfinite(got).all()) and err <= bar):
        raise AssertionError(f"{what}: {err} > {bar}")
    return err


def bounds_us(b, n, dp1, t_dim) -> dict:
    nbytes = 4.0 * (b * n + dp1 * n * t_dim + b * t_dim)
    flops = 2.0 * b * n * (dp1 - 1) * t_dim
    t_b = nbytes / HBM_BYTES_PER_S * 1e6
    fp32, tf32 = flops / FP32_FLOP_PER_S * 1e6, 3 * flops / TF32_FLOP_PER_S * 1e6
    return {"bound_us": max(t_b, fp32),
            "bound_by": "bytes" if t_b >= fp32 else "operations",
            "bytes_us": t_b, "fp32_us": fp32, "tf32x3_us": tf32,
            "bound_tc_us": max(t_b, tf32)}


def event_ms(fns: dict, reps: int) -> dict:
    """Median CUDA-event ms a call of each fn, the fns in turns."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    times = {k: [] for k in fns}
    names = list(fns)
    for r in range(reps):
        for k in (names if r % 2 == 0 else names[::-1]):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fns[k]()
            end.record()
            end.synchronize()
            times[k].append(start.elapsed_time(end))
    return {k: float(np.median(v)) for k, v in times.items()}


def host_us(fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return float(np.median(times))


def device_us(fn, calls: int = 20):
    """Device µs a call (every kernel), or None where the profiler shows
    no device time in three windows running."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        total, kernels = 0.0, {}
        for ev in prof.key_averages():
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = ev.self_cuda_time_total
            total += float(us)
            kernels[ev.key[:48]] = float(us) / calls
        if total:
            return total / calls, kernels
    return None, {}


_MMA = """          mma_3x<EXACT_A, EXACT_B>(o[0][n], o[FSETS > 1 ? 1 : 0][n],
                                   o[FSETS - 1][n], a, b_frag<EXACT_B>(bv));"""
_BUILD = "    for (int j = 0; j < dg; ++j) {\n      const bool live"
_TANH_END = """        cur[q] = t;
      }
    }
"""
_X_LATE = """      // the next feature chunk's x is in flight during these products
      if (s + 1 < steps) QKAN_LOAD_X(fci)
"""
_W_TOP = ("    if (s + 1 < steps) QKAN_LOAD_W(s + 1, wring + ((s + 1) & 1) * kb "
          "* WS)\n")
_WAIT = """    if (s + 1 < steps) {
      qkan::cp_async_wait<1>();
    } else {
      qkan::cp_async_wait<0>();
    }
    __syncthreads();  // the basis and W of step s are in
"""
# the 'timed' build: thread 0's clock64() cycles of each phase, summed over
# the blocks, into qkan_fwd_cycles: 0 the block's start (W_0's colsum, the
# first loads), 1 the basis (with the next W chunk's copies issued), 2
# waiting for W and the other warps' basis, 3 the products, 4 the
# products' barrier and the block's end
_MARK = """#define QKAN_FWD_MARK(i)                       \\
  if (threadIdx.x == 0) {                      \\
    const long long now = clock64();           \\
    cyc[i] += (unsigned long long)(now - last); \\
    last = now;                                \\
  }
"""
_TC_KERNEL = ("template <typename XT, int NT, bool ROUND, bool W0R>\n"
              "__global__ void __launch_bounds__(FTH, 2)\n")
_REGS = "  float xr[8], tt[8], cur[8], prev[8];\n"
_LOOP = "  int g = 0, fci = fc_begin;  // degree chunk and feature chunk of step s\n"
_WAIT1 = "    if (s + 1 < steps) {\n      qkan::cp_async_wait<1>();\n"
_IN = "    __syncthreads();  // the basis and W of step s are in\n"
_DONE = ("    __syncthreads();  // step s's readers are done with its basis "
         "and stage\n")
_END = """          out[(size_t)b * T + c] = csum[cl] + prod;
        }
      }
  }
}
"""
TIMING = [
    (_TC_KERNEL, "__device__ unsigned long long qkan_fwd_cycles[5];\n"
     + _MARK + _TC_KERNEL),
    (_REGS, "  unsigned long long cyc[5] = {0, 0, 0, 0, 0};\n"
     "  long long last = clock64();\n" + _REGS),
    (_LOOP, _LOOP + "  QKAN_FWD_MARK(0)\n"),
    (_WAIT1, "    QKAN_FWD_MARK(1)\n" + _WAIT1),
    (_IN, _IN + "    QKAN_FWD_MARK(2)\n"),
    (_DONE, "    QKAN_FWD_MARK(3)\n" + _DONE + "    QKAN_FWD_MARK(4)\n"),
    (_END, _END[:-2] + """  QKAN_FWD_MARK(4)
  if (threadIdx.x == 0) {
    for (int e = 0; e < 5; ++e) atomicAdd(&qkan_fwd_cycles[e], cyc[e]);
  }
}
"""),
    ("// Name of a CUDA error code", """// the phase cycles, read and reset
extern "C" int qkan_fwd_phase_cycles(unsigned long long* out) {
  cudaError_t err =
      cudaMemcpyFromSymbol(out, qkan_fwd_cycles, sizeof(qkan_fwd_cycles));
  if (err != cudaSuccess) return (int)err;
  const unsigned long long zero[5] = {0, 0, 0, 0, 0};
  return (int)cudaMemcpyToSymbol(qkan_fwd_cycles, zero, sizeof(zero));
}

// Name of a CUDA error code"""),
]
# name -> (substitutions, nvcc flags): 'old' under the flag the source
# keeps for it, 'tc' with the rule sending every shape to the tensor cores
BUILDS = {
    "old": ([], ["-DQKAN_FWD_TC=0"]),
    "tc": ([("  return !(cc_takes && in <= CC_MAX_IN);\n",
             "  return true;\n")], []),
    "timed": (TIMING, []),
}
# name -> (substitutions, whether the output is right)
ABLATIONS = {
    "no_products": ([(_MMA, "          o[0][n][0] += bv.x * a[0].x + bv.y;")],
                    False),
    "no_basis": ([(_BUILD, _BUILD.replace("j < dg", "j < 0 * dg"))], False),
    "x_early": ([(_TANH_END, _TANH_END[:-6] + """      if (fci + 1 < fc_end) QKAN_LOAD_X(fci + 1)
    }
"""), (_X_LATE, "")], True),
    "w_in_products": ([(_W_TOP, ""), (_WAIT, """    qkan::cp_async_wait<0>();
    __syncthreads();  // the basis and W of step s are in
    if (s + 1 < steps) QKAN_LOAD_W(s + 1, wring + ((s + 1) & 1) * kb * WS)
""")], True),
}


def ablate(smi: str) -> list:
    """The ABLATIONS beside the package's build: device µs a call."""
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        cb._run_all(nvcc_cmds(work, {name: (subs, []) for name, (subs, _)
                                     in ABLATIONS.items()}))
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        libs = {"new": cb.load_library()}
        for name in ABLATIONS:
            lib = ctypes.CDLL(str(work / f"{name}.so"))
            lib.qkan_fused_dw_fwd.argtypes = [p, p, p, p, ll, i, i, i, i, i,
                                              i, i, p]
            lib.qkan_fused_dw_fwd.restype = i
            lib.qkan_fused_fwd_workspace_bytes.argtypes = [i, i, i, i]
            lib.qkan_fused_fwd_workspace_bytes.restype = ll
            libs[name] = lib
        rng = np.random.default_rng(SEED + 1)
        for b, n, dp1, t_dim in [(b, 784, DP1, t) for t in (10, 32)
                                 for b in (64, 4096)]:
            x, w2 = inputs(rng, b, n, dp1, t_dim, torch.device("cuda"))
            want = kan_layer_fused_dw_reference(x, w2, dp1, True, "high")
            for name, lib in libs.items():
                fn = (lambda lib=lib, x=x, w2=w2, dp1=dp1:
                      fwd_call(lib, x, w2, dp1, "high"))
                if name == "new" or ABLATIONS[name][1]:
                    held(fn(), want, f"{name} x[{b},{n}] T {t_dim}")
                dev, _ = device_us(fn)
                rows.append(dict(shape=f"x[{b},{n}] dp1 {dp1} T {t_dim}",
                                 variant=name, device_us=dev, card=smi))
                print(f"[ablate] shape={rows[-1]['shape']} variant={name} "
                      f"device_us={'not measured' if dev is None else f'{dev:.3f}'} "
                      f"card='{smi}'", flush=True)
    return rows


def phase_shares(lib, x, w2, dp1, calls: int = 10) -> dict:
    """Each phase's share of thread 0's cycles of the tensor-core kernel
    (the timing build), over ``calls`` calls."""
    cycles = (ctypes.c_ulonglong * len(PHASES))()
    fwd_call(lib, x, w2, dp1, "high")
    torch.cuda.synchronize()
    if lib.qkan_fwd_phase_cycles(cycles) != 0:  # reset after the warm call
        raise RuntimeError("qkan_fwd_phase_cycles failed")
    for _ in range(calls):
        fwd_call(lib, x, w2, dp1, "high")
    torch.cuda.synchronize()
    if lib.qkan_fwd_phase_cycles(cycles) != 0:
        raise RuntimeError("qkan_fwd_phase_cycles failed")
    total = float(sum(cycles)) or 1.0
    return {k: c / total for k, c in zip(PHASES, cycles)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--reps", type=int, default=40)
    ap.add_argument("--ablate", action="store_true",
                    help="time the ABLATIONS instead (module docstring)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fwd_vs_old: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    if args.ablate:
        rows = ablate(smi)
        if args.out is not None:
            args.out.parent.mkdir(parents=True, exist_ok=True)
            args.out.write_text(json.dumps(rows, indent=1))
        return 0
    device = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        libs = build(Path(tmp))
        print(f"[build] seconds={time.perf_counter() - t0:.2f}", flush=True)
        rng = np.random.default_rng(SEED)
        rows = []
        for b, n, dp1, t_dim in SHAPES:
            x, w2 = inputs(rng, b, n, dp1, t_dim, device)
            want = kan_layer_fused_dw_reference(x, w2, dp1, True, "high")
            tc_rule, splits, _ = fused_fwd_plan(b, n, dp1, t_dim)
            versions = [v for v in VERSIONS if v != "old"
                        or not libs["old"].qkan_fused_fwd_tensor_cores(
                            b, n, dp1, t_dim)]
            fns, errs = {}, {}
            for v in versions:
                fn = (lambda lib=libs[v], x=x, w2=w2, dp1=dp1:
                      fwd_call(lib, x, w2, dp1, "high"))
                got, again = fn(), fn()
                torch.cuda.synchronize()
                if not torch.equal(got, again):
                    raise AssertionError(f"{v} {b},{n},{t_dim}: not the "
                                         "same bits twice")
                errs[v] = held(got, want, f"{v} x[{b},{n}] T {t_dim}")
                fns[v] = fn
            # the new build's other modes, held to their plain versions
            xb = x.to(torch.bfloat16)
            held(fwd_call(libs["new"], x, w2, dp1, "bf16"),
                 kan_layer_fused_dw_reference(x, w2, dp1, True, "bf16"),
                 f"new bf16 x[{b},{n}]")
            held(fwd_call(libs["new"], xb, w2, dp1, "v1"),
                 kan_layer_fused_reference(xb, w2, dp1, True),
                 f"new v1 bf16 x x[{b},{n}]")
            ms = event_ms(fns, args.reps)
            bound = bounds_us(b, n, dp1, t_dim)
            phases = phase_shares(libs["timed"], x, w2, dp1) if tc_rule \
                else None
            for v in versions:
                dev, kernels = device_us(fns[v])
                row = dict(shape=f"x[{b},{n}] dp1 {dp1} T {t_dim}",
                           version=v, max_abs_err=errs[v], event_ms=ms[v],
                           device_us=dev,
                           host_us=host_us(fns[v], args.reps),
                           rule_tensor_cores=tc_rule, splits=splits,
                           kernels=kernels, phase_shares=phases, **bound,
                           card=smi)
                rows.append(row)
                print(f"[fwd] shape={row['shape']} version={v} "
                      f"device_us={'not measured' if dev is None else f'{dev:.3f}'} "
                      f"event_ms={ms[v]:.4f} host_us={row['host_us']:.2f} "
                      f"bound_us={bound['bound_us']:.3f} "
                      f"({bound['bound_by']}; 3xTF32 {bound['bound_tc_us']:.3f}) "
                      f"max_abs_err={errs[v]:.3e} rule_tc={tc_rule} "
                      f"splits={splits} card='{smi}'", flush=True)
            if phases:
                print(f"[phases] shape={rows[-1]['shape']} " + " ".join(
                    f"{k}={v:.3f}" for k, v in phases.items()), flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(rows, indent=1))
    print(json.dumps({"fwd_vs_old": [
        {k: r[k] for k in ("shape", "version", "device_us", "event_ms",
                           "host_us", "bound_us", "bound_tc_us")}
        for r in rows], "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
