"""Time the fused-layer backward K2/K4 (``csrc/fused_dw_bwd.cu`` and
``csrc/fused_dw_bwd_tc.cu``) old beside new, on the same inputs, in one
process on one CUDA card:

    python tools/bwd_vs_old.py [--out PATH.json] [--reps N] [--ablate]

The backward's sources and ``partial_sum.cu`` are compiled twice beside
the package's build: with ``-DQKAN_BWD_TC=0`` ('old': the CUDA-core kernel
at every shape, as before the tensor-core kernel), and with
``-DQKAN_BWD_TIMING`` ('timed': the tensor-core kernel with thread 0's
clock64() cycles of each phase of a tile, summed over its blocks,
printed as shares: waiting for the tile's copies, the basis, the dW
product, the dx product with its epilogue, the block's start and end).
'new' is the package's library, whose rule (``fused_bwd_plan``) takes the
tensor cores at every shape below.  All go through the same C entries.

Shapes, dp1 6 (max_degree 5), at B 64 and 4096: the flagship
checkpoint's layers (a FixedKAN layer maps [B, in] to [B, target_dim]),
(in, T) = (784, 10) and (10, 10), and the four layers of a [784, 32, 16,
16, 10] whose layers map to the next width, (784, 32), (32, 16), (16,
16), (16, 10): chip_smoke.py's LAYER_SHAPES.

Each version is first held to the plain version on the card, K2 ('high')
and K4 (the v1 entry), f32 x, tanh on: dx and dW each within 1e-4 of
their max + 1e-5 (the bar of tests/test_torch_cuda_kernels.py), twice with
the same bits, and old and new within the same bar of each other.  Then
per (shape, version), K2 'high': CUDA-event median ms of one call (the
backward without its dW pass, as chip_smoke.py phase 6b times it; the
versions and the plain version in turns), device µs a call from
torch.profiler (every kernel of the call) and host µs a call, beside the
bound: bytes (x and g read, dx written, w2 read and dW written once) over
3.35 TB/s against the two contractions, 4 B in (dp1-1) T flops, over 67
TFLOP/s (FP32 CUDA cores) and as three TF32 passes over 495 TFLOP/s
(3xTF32, the tensor cores).  Prints one line a (shape, version) with the
card's ``nvidia-smi`` name and power limit.

``--ablate`` instead times variants of the new kernel's sources (text
substitutions, ABLATIONS) beside the package's build at the flagship's
layer 0 (784 -> 10 and 784 -> 32, B 64 and 4096), device µs a call:
'one_block' lifts the register cap of two blocks an SM; 'no_dx' drops
the dx product and epilogue, 'no_dw' the dW product, 'no_tanh' the tanh
of the basis build and 'no_copy_wait' the wait for a tile's copies (their
results are wrong: they only weigh a phase); 'generic' runs dp1 6 on the
kernel built for any dp1 instead of the one with dp1 6 compiled in.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
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
    fused_bwd_plan,
    kan_layer_fused_bwd_reference,
    kan_layer_fused_dw_bwd_reference,
)

DP1 = 6
LAYER_SHAPES = [(784, 10), (10, 10), (784, 32), (32, 16), (16, 16),
                (16, 10)]
SHAPES = [(b, n, DP1, t) for n, t in LAYER_SHAPES for b in (64, 4096)]
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, as chip_smoke.py's bound()
FP32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
BAR = (1e-4, 1e-5)
SEED = 12
SOURCES = ("fused_dw_bwd.cu", "fused_dw_bwd_tc.cu", "partial_sum.cu")
PHASES = ("wait", "basis", "dw_product", "dx_product", "start_end")

_DX = "    if (want_dx) {\n      const float* ga"
_DW = ("            mma_3x<false, false>(acc[d][m], acc[d][m], acc[d][m], "
       "a[m], b);")
_TANH = """        cur.x = tanhf(cur.x);
        cur.y = tanhf(cur.y);
        cur.z = tanhf(cur.z);
        cur.w = tanhf(cur.w);
"""
_BOUNDS = "__launch_bounds__(BT_THREADS, NT == 8 ? 1 : 2)"
_WAIT = "    qkan::cp_async_wait<0>();  // this thread's copies of tile j"
_FAST = """  if (dp1 == 6 && p.nt == 2) QKAN_BT(2, 5);
  if (dp1 == 6 && p.nt == 4) QKAN_BT(4, 5);
"""
# name -> ({file: [(old, new)]}, whether the results are right)
ABLATIONS = {
    "no_dx": ({"fused_dw_bwd_tc.cu": [(_DX, _DX.replace("want_dx",
                                                       "want_dx < 0"))]},
              False),
    "no_dw": ({"fused_dw_bwd_tc.cu": [(_DW, "            acc[d][m][0] += "
                                       "a[m][0].x * b.x;")]}, False),
    "no_tanh": ({"fused_dw_bwd_tc.cu": [(_TANH, "")]}, False),
    "one_block": ({"fused_dw_bwd_tc.cu": [(_BOUNDS, _BOUNDS.replace(
        "NT == 8 ? 1 : 2", "1"))]}, True),
    "no_copy_wait": ({"fused_dw_bwd_tc.cu": [(_WAIT, _WAIT.replace(
        "<0>", "<1>"))]}, False),
    "generic": ({"fused_dw_bwd_tc.cu": [(_FAST, "")]}, True),
}


def build_variants(workdir: Path, variants: dict) -> None:
    """Build each variant name -> (subs, nvcc flags): the package's csrc/
    copied to ``workdir/name`` with ``subs`` ({file: [(old, new)]})
    applied, the backward's sources and the pass compiled (one nvcc
    process a source, all at once) and linked into ``workdir/name.so``."""
    nvcc = cb.find_nvcc()
    compiles, links = [], []
    for name, (subs, flags) in variants.items():
        src_dir = workdir / name
        shutil.copytree(cb.CSRC_DIR, src_dir)
        for fname, pairs in subs.items():
            path = src_dir / fname
            text = path.read_text()
            for old, new in pairs:
                if text.count(old) != 1:
                    raise RuntimeError(f"{name}: {fname} changed")
                text = text.replace(old, new)
            path.write_text(text)
        objs = [str(src_dir / f"{Path(s).stem}.o") for s in SOURCES]
        compiles += [[nvcc, *cb.ARCH_FLAGS, "-std=c++17", "-O3",
                      "-Xcompiler", "-fPIC", *flags, "-c", "-o", o,
                      str(src_dir / s)] for s, o in zip(SOURCES, objs)]
        links.append([nvcc, *cb.LINK_FLAGS, "-o",
                      str(workdir / f"{name}.so"), *objs])
    cb._run_all(compiles)
    cb._run_all(links)


def load(path: Path) -> ctypes.CDLL:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib = ctypes.CDLL(str(path))
    lib.qkan_fused_bwd_workspace_bytes.argtypes = [i] * 7
    lib.qkan_fused_bwd_workspace_bytes.restype = ll
    lib.qkan_fused_bwd_tensor_cores.argtypes = [i] * 5
    lib.qkan_fused_bwd_tensor_cores.restype = i
    lib.qkan_fused_dw_bwd.argtypes = [p, p, p, p, p, ll, i, i, i, i, i, i, i,
                                      i, p, p]
    lib.qkan_fused_bwd.argtypes = [p, p, p, p, p, ll, i, i, i, i, i, i, i, p,
                                   p]
    for entry in ("qkan_fused_dw_bwd", "qkan_fused_bwd"):
        getattr(lib, entry).restype = i
    if hasattr(lib, "qkan_bwd_phase_cycles"):
        lib.qkan_bwd_phase_cycles.argtypes = [
            ctypes.POINTER(ctypes.c_ulonglong)]
    return lib


def phase_shares(lib, x, w2, g, dp1, calls: int = 10) -> dict:
    """Each phase's share of thread 0's cycles of the tensor-core kernel
    (the timing build), over ``calls`` calls."""
    cycles = (ctypes.c_ulonglong * len(PHASES))()
    bwd_call(lib, x, w2, g, dp1, False)
    torch.cuda.synchronize()
    if lib.qkan_bwd_phase_cycles(cycles) != 0:  # reset after the warm call
        raise RuntimeError("qkan_bwd_phase_cycles failed")
    for _ in range(calls):
        bwd_call(lib, x, w2, g, dp1, False)
    torch.cuda.synchronize()
    if lib.qkan_bwd_phase_cycles(cycles) != 0:
        raise RuntimeError("qkan_bwd_phase_cycles failed")
    total = float(sum(cycles)) or 1.0
    return {k: c / total for k, c in zip(PHASES, cycles)}


def bwd_call(lib, x, w2, g, dp1, v1: bool, finish: bool = False):
    """One backward through ``lib``'s C entry, as the package's wrapper
    makes it (f32 x, 'high', tanh on): (dx, dW) with ``finish`` (the pass
    in the same call), else (dx, the workspace)."""
    b, n = x.shape
    t_dim = w2.shape[1]
    ws_bytes = lib.qkan_fused_bwd_workspace_bytes(b, n, dp1, t_dim, 1, 0, 0)
    ws = torch.empty(ws_bytes, dtype=torch.uint8, device=x.device)
    dx = torch.empty_like(x)
    dw = (torch.empty((dp1 * n, t_dim), dtype=torch.float32, device=x.device)
          if finish else None)
    head = (x.data_ptr(), w2.data_ptr(), g.data_ptr(), dx.data_ptr(),
            ws.data_ptr(), ws_bytes, b, n, dp1, t_dim, 0)
    tail = (1, 1, None if dw is None else dw.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    err = (lib.qkan_fused_bwd(*head, *tail) if v1
           else lib.qkan_fused_dw_bwd(*head, 0, *tail))
    if err != 0:
        raise RuntimeError(f"backward: CUDA error {err}")
    return dx, (dw if finish else ws)


def inputs(rng, b, n, dp1, t_dim, device):
    x = torch.from_numpy(rng.uniform(-2, 2, (b, n)).astype(np.float32))
    w2 = torch.from_numpy(rng.normal(0, 1 / np.sqrt(dp1 * n), (dp1 * n, t_dim))
                          .astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(b, t_dim)).astype(np.float32))
    return x.to(device), w2.to(device), g.to(device)


def held(got, want, what: str) -> float:
    err = float((got - want).abs().max())
    bar = BAR[0] * float(want.abs().max()) + BAR[1]
    if not (bool(torch.isfinite(got).all()) and err <= bar):
        raise AssertionError(f"{what}: {err} > {bar}")
    return err


def bounds_us(b, n, dp1, t_dim) -> dict:
    nbytes = 4.0 * (2 * b * n + b * t_dim + 2 * dp1 * n * t_dim)
    flops = 4.0 * b * n * (dp1 - 1) * t_dim
    t_b = nbytes / HBM_BYTES_PER_S * 1e6
    fp32, tf32 = flops / FP32_FLOP_PER_S * 1e6, 3 * flops / TF32_FLOP_PER_S * 1e6
    return {"bound_fp32_us": max(t_b, fp32),
            "bound_tc_us": max(t_b, tf32),
            "bound_tc_by": "bytes" if t_b >= tf32 else "operations",
            "bytes_us": t_b, "fp32_us": fp32, "tf32x3_us": tf32}


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


def fmt(us) -> str:
    return "not measured" if us is None else f"{us:.3f}"


def ablate(smi: str) -> list:
    """The ABLATIONS beside the package's build: device µs a call."""
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        build_variants(work, {name: (subs, []) for name, (subs, _)
                              in ABLATIONS.items()})
        libs = {"new": cb.load_library(),
                **{name: load(work / f"{name}.so") for name in ABLATIONS}}
        rng = np.random.default_rng(SEED + 1)
        for b, n, dp1, t_dim in [(b, 784, DP1, t) for t in (10, 32)
                                 for b in (64, 4096)]:
            x, w2, g = inputs(rng, b, n, dp1, t_dim, torch.device("cuda"))
            want_dx, want_dw = kan_layer_fused_dw_bwd_reference(x, w2, g,
                                                                dp1)
            for name, lib in libs.items():
                fn = (lambda lib=lib, x=x, w2=w2, g=g, dp1=dp1:
                      bwd_call(lib, x, w2, g, dp1, False))
                if name == "new" or ABLATIONS[name][1]:
                    dx, dw = bwd_call(lib, x, w2, g, dp1, False, True)
                    held(dx, want_dx, f"{name} dx x[{b},{n}] T {t_dim}")
                    held(dw, want_dw, f"{name} dW x[{b},{n}] T {t_dim}")
                dev, _ = device_us(fn)
                rows.append(dict(shape=f"x[{b},{n}] dp1 {dp1} T {t_dim}",
                                 variant=name, device_us=dev, card=smi))
                print(f"[ablate] shape={rows[-1]['shape']} variant={name} "
                      f"device_us={fmt(dev)} card='{smi}'", flush=True)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--reps", type=int, default=40)
    ap.add_argument("--ablate", action="store_true",
                    help="time the ABLATIONS instead (module docstring)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bwd_vs_old: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    if args.ablate:
        rows = ablate(smi)
    else:
        rows = compare(smi, args.reps)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(rows, indent=1))
    print(json.dumps({"bwd_vs_old" if not args.ablate else "bwd_ablate": [
        {k: r[k] for k in r if k not in ("kernels",)} for r in rows],
        "card": smi}), flush=True)
    return 0


def compare(smi: str, reps: int) -> list:
    device = torch.device("cuda")
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        work = Path(tmp)
        build_variants(work, {"old": ({}, ["-DQKAN_BWD_TC=0"]),
                              "timed": ({}, ["-DQKAN_BWD_TIMING"])})
        libs = {"old": load(work / "old.so"), "new": cb.load_library()}
        timed = load(work / "timed.so")
        print(f"[build] seconds={time.perf_counter() - t0:.2f}", flush=True)
        if libs["old"].qkan_fused_bwd_tensor_cores(784, DP1, 10, 0, 0):
            raise AssertionError("the old build took the tensor cores")
        rng = np.random.default_rng(SEED)
        for b, n, dp1, t_dim in SHAPES:
            x, w2, g = inputs(rng, b, n, dp1, t_dim, device)
            tc, fc, _, _, nrb = fused_bwd_plan(b, n, dp1, t_dim)
            if not libs["new"].qkan_fused_bwd_tensor_cores(n, dp1, t_dim, 0,
                                                           0) == int(tc):
                raise AssertionError("the new build's route is not the "
                                     "plan's")
            where = f"x[{b},{n}] dp1 {dp1} T {t_dim}"
            errs = {}
            for v1, ref in ((False, kan_layer_fused_dw_bwd_reference),
                            (True, kan_layer_fused_bwd_reference)):
                want_dx, want_dw = ref(x, w2, g, dp1)
                got = {}
                for v, lib in libs.items():
                    dx, dw = bwd_call(lib, x, w2, g, dp1, v1, True)
                    dx2, dw2 = bwd_call(lib, x, w2, g, dp1, v1, True)
                    torch.cuda.synchronize()
                    if not (torch.equal(dx, dx2) and torch.equal(dw, dw2)):
                        raise AssertionError(f"{v} {where}: not the same "
                                             "bits twice")
                    errs[(v, v1)] = max(
                        held(dx, want_dx, f"{v} v1={v1} dx {where}"),
                        held(dw, want_dw, f"{v} v1={v1} dW {where}"))
                    got[v] = (dx, dw)
                held(got["new"][0], got["old"][0], f"new vs old dx {where}")
                held(got["new"][1], got["old"][1], f"new vs old dW {where}")
            fns = {v: (lambda lib=lib, x=x, w2=w2, g=g, dp1=dp1:
                       bwd_call(lib, x, w2, g, dp1, False))
                   for v, lib in libs.items()}
            fns["plain"] = (lambda x=x, w2=w2, g=g, dp1=dp1:
                            kan_layer_fused_dw_bwd_reference(x, w2, g, dp1))
            ms = event_ms(fns, reps)
            bound = bounds_us(b, n, dp1, t_dim)
            phases = phase_shares(timed, x, w2, g, dp1) if tc else None
            for v in libs:
                dev, kernels = device_us(fns[v])
                row = dict(shape=where, version=v,
                           max_abs_err=max(errs[(v, False)], errs[(v, True)]),
                           event_ms=ms[v], plain_ms=ms["plain"],
                           device_us=dev, host_us=host_us(fns[v], reps),
                           rule_tensor_cores=tc, feature_chunk=fc,
                           row_blocks=nrb, kernels=kernels, **bound,
                           phase_shares=phases if v == "new" else None,
                           card=smi)
                rows.append(row)
                print(f"[bwd] shape={where} version={v} "
                      f"device_us={fmt(dev)} event_ms={ms[v]:.4f} "
                      f"plain_ms={ms['plain']:.4f} "
                      f"host_us={row['host_us']:.2f} "
                      f"bound_us={bound['bound_tc_us']:.3f} "
                      f"({bound['bound_tc_by']}, 3xTF32; FP32 "
                      f"{bound['bound_fp32_us']:.3f}) "
                      f"max_abs_err={row['max_abs_err']:.3e} rule_tc={tc} "
                      f"fc={fc} nrb={nrb} card='{smi}'", flush=True)
            if phases:
                print(f"[phases] shape={where} " + " ".join(
                    f"{k}={v:.3f}" for k, v in phases.items()), flush=True)
    return rows


if __name__ == "__main__":
    sys.exit(main())
