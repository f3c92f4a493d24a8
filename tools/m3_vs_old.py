"""Time K12, K13 and K14 (the batched QKAN layer over M3: the forward,
the backward with dx and the weight-only backward) old beside new, on the
same inputs, in one process on one CUDA card:

    python tools/m3_vs_old.py [--out PATH.json] [--reps N] [--ablate]
                              [--parent-csrc DIR]

The M3 layer's sources (``csrc/qkan_layer_m3.cu``, ``qkan_layer_m3_tc.cu``)
and ``partial_sum.cu`` are compiled a second time with ``-DQKAN_M3_TC=0``
('old': the CUDA-core kernels at every shape) beside the package's
library ('new', whose rule, ``m3_tc_plan``, sends both shapes below to
the tensor-core kernels, all three).  Both go through the same C entries.

Shapes, f32 x in [-1, 1]: the headline layer x[262144, 16], dp1 8, K 16
(``bench.py``'s and chip_smoke.py phase 13's), and x[4096, 16], dp1 8,
K 128 (phase 13's N16 K128).

Each version is first held to the plain version on the card (out, dx and
dM within 1e-4 of their max + 1e-5, chip_smoke.py's BARS['high']), twice
with the same bits, and old and new within the same bar of each other.
Then per (shape, kernel, version): CUDA-event median ms of one wrapper
call (old, new and the plain version in turns; the backward without its
dM pass, as chip_smoke.py phase 13c times it), device µs a call from
torch.profiler (the kernel alone) and host µs a call, beside the bound:
the bytes (x and out, or x and g, and M3 or dM once; K13: x, g, dx, M3
and dM) over 3.35 TB/s against the contractions' flops (2 B N (dp1 - 1) K
each, K13 two of them) over 67 TFLOP/s (FP32 CUDA cores) and as three
TF32 passes over 495 TFLOP/s (3xTF32 on the tensor cores).  One line a
row with the card's ``nvidia-smi`` name and power limit, then one JSON
line.

``--ablate`` instead times variants of the new kernels' sources beside
the package's build, device µs a call at both shapes: 'no_store' drops
K12's stores of out, 'no_g_split' takes K14's (and K13's dM) g fragments
as TF32 (no split, no lo pass), 'no_mma' drops K12's products and the dM
products of K13 and K14, 'no_dx_mma' K13's dx products, 'no_dx_store'
K13's stores of dx, 'no_dx' all of K13's dx work after its M3^T staging
(the results of those are wrong: they only weigh a part), and 'ring1'
builds the warps' cp.async rings with one stage (``M3T_RING = 1`` in
``m3_tc.cuh``: a warp waits for each stage's copies before it computes).

``--parent-csrc DIR`` also builds DIR's sources (a csrc directory of an
earlier commit, e.g. from ``git archive``) and holds this tree's f32 K12
and K14 and its bf16-x K12, K13 and K14 (both shapes) to that build's
bits.  The f32 K13 is left out: on the tensor cores it is a new sum (its
dx in mma fragments, its dM K14's partials), not an earlier commit's
bits.  Then it times chip_smoke.py 13b's step in both arguments at the
headline (the fold, K12, K13 and the dM pass, through the package's
wrappers) with this tree's library and with that build, in turns: device
µs a call (every kernel) and CUDA-event ms.
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
from qkan_implementation_tpu_torch.experimental import (  # noqa: E402
    pallas_layer as pl,
)

SHAPES = [(262144, 16, 16, 8), (4096, 16, 128, 8)]  # B, N, K, dp1
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, as chip_smoke.py's bound()
FP32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
BAR = (1e-4, 1e-5)
SEED = 13
SOURCES = ("qkan_layer_m3.cu", "qkan_layer_m3_tc.cu", "partial_sum.cu")

_STORE = "              *reinterpret_cast<float2*>(o) = make_float2(v0, v1);"
_G_SPLIT = "      a_frag<false>(a, ga[0], ga[8], ga[4 * M3T_GS], ga[4 * M3T_GS + 8]);"
_MMA_FWD = """            mma_3x<false, false>(acc[0][m][n], acc[SETS > 1 ? 1 : 0][m][n],
                                 acc[SETS - 1][m][n], a[m], b);"""
_MMA_BWD = """          mma_3x<false, false>(acc[jd], acc[jd], acc[jd], a,
                               b_frag<false>(make_float2(c0, c1)));"""
_MMA_BWD_G = _MMA_BWD.replace("<false, false>", "<true, false>")
_MMA_DX = """            mma_3x<false, false>(cd, cd, cd, a[0], bq[jd * 64]);
            mma_3x<false, false>(cd, cd, cd, a[1], bq[jd * 64 + 32]);"""
_DX_STORE = """                *reinterpret_cast<float2*>(o) =
                    make_float2(dt[2 * half], dt[2 * half + 1]);"""
_DX_SUM_STORE = "          if (row < r_end && f < N) dx[row * N + f] = sum;"
_DX = """    if (DX) {
      // dx of the chunk's rows"""
_RING = "constexpr int M3T_RING = 2;"
# name -> ({file: [(old, new)]}, nvcc flags)
ABLATIONS = {
    "no_store": ({"qkan_layer_m3_tc.cu": [
        (_STORE, "              if (v0 == 12345.f) *o = v1;")]}, []),
    "no_g_split": ({"qkan_layer_m3_tc.cu": [
        (_G_SPLIT, _G_SPLIT.replace("a_frag<false>", "a_frag<true>")),
        (_MMA_BWD, _MMA_BWD_G)]}, []),
    "no_mma": ({"qkan_layer_m3_tc.cu": [
        (_MMA_FWD, "            acc[0][m][n][0] += a[m][0].x * b.x;"),
        (_MMA_BWD, "          acc[jd][0] += a[0].x * c0 + a[1].x * c1;")]},
        []),
    "no_dx_mma": ({"qkan_layer_m3_tc.cu": [
        (_MMA_DX, "            cd[0] = a[0][0].x * bq[jd * 64].x;")]}, []),
    "no_dx_store": ({"qkan_layer_m3_tc.cu": [
        (_DX_STORE, "                if (dt[0] == 12345.f) *o = dt[1];"),
        (_DX_SUM_STORE, "          if (sum == 12345.f) dx[row * N + f] = 0;")
    ]}, []),
    "no_dx": ({"qkan_layer_m3_tc.cu": [
        (_DX, _DX.replace("if (DX)", "if (DX && N < 0)"))]}, []),
    "ring1": ({"m3_tc.cuh": [(_RING, _RING.replace("= 2;", "= 1;"))]}, []),
}


def build_variants(workdir: Path, variants: dict) -> None:
    """Build each variant name -> (source dir, subs, nvcc flags, sources):
    the source dir copied to ``workdir/name`` with ``subs`` ({file: [(old,
    new)]}) applied, the sources compiled (one nvcc process a source, all
    at once) and linked into ``workdir/name.so``."""
    nvcc = cb.find_nvcc()
    compiles, links = [], []
    for name, (src, subs, flags, sources) in variants.items():
        src_dir = workdir / name
        shutil.copytree(src, src_dir)
        for fname, pairs in subs.items():
            path = src_dir / fname
            text = path.read_text()
            for old, new in pairs:
                if text.count(old) != 1:
                    raise RuntimeError(f"{name}: {fname} changed")
                text = text.replace(old, new)
            path.write_text(text)
        objs = [str(src_dir / f"{Path(s).stem}.o") for s in sources]
        compiles += [[nvcc, *cb.ARCH_FLAGS, "-std=c++17", "-O3",
                      "-Xcompiler", "-fPIC", *flags, "-c", "-o", o,
                      str(src_dir / s)] for s, o in zip(sources, objs)]
        links.append([nvcc, *cb.LINK_FLAGS, "-o",
                      str(workdir / f"{name}.so"), *objs])
    cb._run_all(compiles)
    cb._run_all(links)


def load(path: Path) -> ctypes.CDLL:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib = ctypes.CDLL(str(path))
    lib.qkan_m3_bwd_blocks.argtypes = [ll, i, i, i, i]
    lib.qkan_m3_bwd_blocks.restype = i
    lib.qkan_m3_fwd.argtypes = [p, p, p, p, ll, ll, i, i, i, i, p]
    lib.qkan_m3_fwd.restype = i
    lib.qkan_m3_bwd.argtypes = [p, p, p, p, p, ll, ll, i, i, i, i, i, p, p]
    lib.qkan_m3_bwd.restype = i
    if hasattr(lib, "qkan_m3_tc_plan"):
        lib.qkan_m3_tc_plan.argtypes = [i, i, i, i, i, ctypes.POINTER(ll)]
        lib.qkan_m3_tc_plan.restype = i
    return lib


def fwd_call(lib, x, m3):
    """K12 through ``lib``'s C entry, one launch (no carry): out."""
    b, n = x.shape
    dp1, _, k = m3.shape
    out = torch.empty((b, k), dtype=x.dtype, device=x.device)
    err = lib.qkan_m3_fwd(x.data_ptr(), m3.data_ptr(), out.data_ptr(), None,
                          0, b, n, dp1, k, int(x.dtype == torch.bfloat16),
                          torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"qkan_m3_fwd: CUDA error {err}")
    return out


def bwd_call(lib, x, m3, g, want_dx: bool, finish: bool = False):
    """K13 (``want_dx``) or K14 through ``lib``'s C entry, as the package's
    ``_bwd_pass`` makes it: (dx or None, dM with ``finish`` else the
    partials)."""
    b, n = x.shape
    dp1, _, k = m3.shape
    nblk = lib.qkan_m3_bwd_blocks(b, n, dp1, k, int(want_dx))
    part = torch.empty(nblk * dp1 * n * k, dtype=torch.float32,
                       device=x.device)
    dx = torch.empty_like(x) if want_dx else None
    dm = (torch.empty((dp1, n, k), dtype=torch.float32, device=x.device)
          if finish else None)
    err = lib.qkan_m3_bwd(
        x.data_ptr(), m3.data_ptr(), g.data_ptr(),
        None if dx is None else dx.data_ptr(), part.data_ptr(),
        part.numel() * 4, b, n, dp1, k, int(x.dtype == torch.bfloat16),
        int(want_dx), None if dm is None else dm.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"qkan_m3_bwd: CUDA error {err}")
    return dx, (dm if finish else part)


def inputs(rng, b, n, k, dp1, device, x_dtype=torch.float32):
    x = torch.from_numpy(rng.uniform(-1, 1, (b, n)).astype(np.float32))
    m3 = torch.from_numpy(rng.normal(0, 1 / np.sqrt(dp1 * n), (dp1, n, k))
                          .astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(b, k)).astype(np.float32))
    return x.to(device, x_dtype), m3.to(device), g.to(device, x_dtype)


def held(got, want, what: str) -> float:
    err = float((got.float() - want.float()).abs().max())
    bar = BAR[0] * float(want.float().abs().max()) + BAR[1]
    if not (bool(torch.isfinite(got).all()) and err <= bar):
        raise AssertionError(f"{what}: {err} > {bar}")
    return err


def bounds_us(b, n, k, dp1, kern: str) -> dict:
    """The bound of ``kern`` at this shape: K13 moves dx and dM too and
    runs two contractions."""
    two = kern == "K13"
    nbytes = 4.0 * ((1 + two) * b * n + b * k + (1 + two) * dp1 * n * k)
    flops = 2.0 * b * n * (dp1 - 1) * k * (1 + two)
    t_b = nbytes / HBM_BYTES_PER_S * 1e6
    fp32, tf32 = flops / FP32_FLOP_PER_S * 1e6, 3 * flops / TF32_FLOP_PER_S * 1e6
    return {"bound_tc_us": max(t_b, tf32),
            "bound_tc_by": "bytes" if t_b >= tf32 else "operations",
            "bound_fp32_us": max(t_b, fp32),
            "bound_fp32_by": "bytes" if t_b >= fp32 else "operations",
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
    """Device µs a call (every kernel) and by kernel, or (None, {}) where
    three windows running show no device time or lose launches (a kernel
    seen a number of times that is no multiple of the calls: one window
    kept 2 of 20 launches of the CUDA-core K13)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        total, kernels, whole = 0.0, {}, True
        for ev in prof.key_averages():
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = ev.self_cuda_time_total
            total += float(us)
            kernels[ev.key[:60]] = float(us) / calls
            whole = whole and ev.count % calls == 0
        if total and whole:
            return total / calls, kernels
    return None, {}


def fmt(us) -> str:
    return "not measured" if us is None else f"{us:.3f}"


def kernel_fns(lib, x, m3, g) -> dict:
    return {"K12": lambda: fwd_call(lib, x, m3),
            "K13": lambda: bwd_call(lib, x, m3, g, True),
            "K14": lambda: bwd_call(lib, x, m3, g, False)}


def compare(smi: str, reps: int) -> list:
    device = torch.device("cuda")
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        work = Path(tmp)
        build_variants(work, {"old": (cb.CSRC_DIR, {}, ["-DQKAN_M3_TC=0"],
                                      SOURCES)})
        libs = {"old": load(work / "old.so"), "new": cb.load_library()}
        print(f"[build] seconds={time.perf_counter() - t0:.2f}", flush=True)
        rng = np.random.default_rng(SEED)
        for b, n, k, dp1 in SHAPES:
            x, m3, g = inputs(rng, b, n, k, dp1, device)
            where = f"x[{b},{n}] dp1 {dp1} K {k}"
            plans = {kind: pl.m3_tc_plan(n, dp1, k, kind)
                     for kind in (0, 1, 2)}
            for kind, plan in plans.items():
                if pl.library_m3_tc_plan(n, dp1, k, kind) != plan:
                    raise AssertionError(f"{where}: the library's plan is "
                                         "not the mirror's")
                if not plan.ok:
                    raise AssertionError(f"{where}: kind {kind} is not on "
                                         "the tensor cores")
            want_out = pl.qkan_layer_fused_reference(x, m3)
            want_dx, want_dm = pl.qkan_layer_fused_bwd_reference(x, m3, g,
                                                                 True)
            errs, got = {}, {}
            for v, lib in libs.items():
                def run(lib=lib):
                    dx, dm13 = bwd_call(lib, x, m3, g, True, True)
                    return (fwd_call(lib, x, m3), dx, dm13,
                            bwd_call(lib, x, m3, g, False, True)[1])
                first, again = run(), run()
                torch.cuda.synchronize()
                if not all(torch.equal(a, c) for a, c in zip(first, again)):
                    raise AssertionError(f"{v} {where}: not the same bits "
                                         "twice")
                out, dx, dm13, dm = first
                errs[v] = {"K12": held(out, want_out, f"{v} out {where}"),
                           "K13": max(held(dx, want_dx, f"{v} dx {where}"),
                                      held(dm13, want_dm,
                                           f"{v} K13 dM {where}")),
                           "K14": held(dm, want_dm, f"{v} dM {where}")}
                got[v] = first
            for what, a, c in zip(("out", "dx", "K13 dM", "dM"), got["new"],
                                  got["old"]):
                held(a, c, f"new vs old {what} {where}")
            fns = {v: kernel_fns(lib, x, m3, g) for v, lib in libs.items()}
            plain = {
                "K12": lambda x=x, m3=m3: pl.qkan_layer_fused_reference(x, m3),
                "K13": lambda x=x, m3=m3, g=g:
                    pl.qkan_layer_fused_bwd_reference(x, m3, g, True),
                "K14": lambda x=x, m3=m3, g=g:
                    pl.qkan_layer_fused_bwd_reference(x, m3, g, False),
            }
            for kern in ("K12", "K13", "K14"):
                bound = bounds_us(b, n, k, dp1, kern)
                ms = event_ms({"old": fns["old"][kern],
                               "new": fns["new"][kern],
                               "plain": plain[kern]}, reps)
                for v in libs:
                    dev, kernels = device_us(fns[v][kern])
                    row = dict(kernel=kern, shape=where, version=v,
                               max_abs_err=errs[v][kern], event_ms=ms[v],
                               plain_ms=ms["plain"], device_us=dev,
                               host_us=host_us(fns[v][kern], reps),
                               tensor_cores=v == "new", kernels=kernels,
                               card=smi, **bound)
                    rows.append(row)
                    print(f"[{kern}] shape={where} version={v} "
                          f"device_us={fmt(dev)} event_ms={ms[v]:.4f} "
                          f"plain_ms={ms['plain']:.4f} "
                          f"host_us={row['host_us']:.1f} "
                          f"bound_tc_us={bound['bound_tc_us']:.3f} "
                          f"({bound['bound_tc_by']}) "
                          f"bound_fp32_us={bound['bound_fp32_us']:.3f} "
                          f"({bound['bound_fp32_by']}) "
                          f"max_abs_err={errs[v][kern]:.3e} card='{smi}'",
                          flush=True)
    return rows


def ablate(smi: str) -> list:
    """The ABLATIONS beside the package's build: device µs a call."""
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        build_variants(work, {name: (cb.CSRC_DIR, subs, flags, SOURCES)
                              for name, (subs, flags) in ABLATIONS.items()})
        libs = {"new": cb.load_library(),
                **{name: load(work / f"{name}.so") for name in ABLATIONS}}
        rng = np.random.default_rng(SEED + 1)
        for b, n, k, dp1 in SHAPES:
            x, m3, g = inputs(rng, b, n, k, dp1, torch.device("cuda"))
            where = f"x[{b},{n}] dp1 {dp1} K {k}"
            want_out = pl.qkan_layer_fused_reference(x, m3)
            want_dx, want_dm = pl.qkan_layer_fused_bwd_reference(x, m3, g,
                                                                 True)
            for name, lib in libs.items():
                if name in ("new", "ring1"):  # variants that stay right
                    held(fwd_call(lib, x, m3), want_out, f"{name} {where}")
                    held(bwd_call(lib, x, m3, g, False, True)[1], want_dm,
                         f"{name} {where}")
                    dx, dm13 = bwd_call(lib, x, m3, g, True, True)
                    held(dx, want_dx, f"{name} dx {where}")
                    held(dm13, want_dm, f"{name} K13 dM {where}")
                for kern, fn in kernel_fns(lib, x, m3, g).items():
                    dev, _ = device_us(fn)
                    rows.append(dict(kernel=kern, shape=where, variant=name,
                                     device_us=dev, card=smi))
                    print(f"[ablate] kernel={kern} shape={where} "
                          f"variant={name} device_us={fmt(dev)} "
                          f"card='{smi}'", flush=True)
    return rows


def parent_bits(smi: str, parent: Path) -> list:
    """This tree's f32 K12 / K14 and bf16-x K12 / K13 / K14 against the
    bits of the build of ``parent``'s sources."""
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        sources = tuple(sorted(f.name for f in parent.glob("*.cu")))
        build_variants(work, {"parent": (parent, {}, [], sources)})
        libs = {"parent": load(work / "parent.so"), "new": cb.load_library()}
        rng = np.random.default_rng(SEED + 2)
        cases = [(*s, torch.float32, ("K12", "K14")) for s in SHAPES]
        cases += [(*s, torch.bfloat16, ("K12", "K13", "K14")) for s in SHAPES]
        for b, n, k, dp1, dtype, kerns in cases:
            x, m3, g = inputs(rng, b, n, k, dp1, torch.device("cuda"), dtype)
            calls = {"K12": lambda lib: fwd_call(lib, x, m3),
                     "K13": lambda lib: bwd_call(lib, x, m3, g, True, True),
                     "K14": lambda lib: bwd_call(lib, x, m3, g, False, True)}
            for kern in kerns:
                a, c = calls[kern](libs["new"]), calls[kern](libs["parent"])
                torch.cuda.synchronize()
                a = a if isinstance(a, tuple) else (a,)
                c = c if isinstance(c, tuple) else (c,)
                same = all((u is None and w is None) or torch.equal(u, w)
                           for u, w in zip(a, c))
                where = f"x[{b},{n}] dp1 {dp1} K {k} {str(dtype)[6:]}"
                rows.append(dict(kernel=kern, shape=where,
                                 parent_bits=same, card=smi))
                print(f"[parent] kernel={kern} shape={where} "
                      f"same_bits_as_parent={same}", flush=True)
                if not same:
                    raise AssertionError(f"{kern} {where}: not the parent's "
                                         "bits")
        rows += both_args_step(smi, work / "parent.so")
    return rows


def both_args_step(smi: str, parent_so: Path) -> list:
    """chip_smoke.py 13b's step in both arguments at the headline through
    the package's wrappers, with this tree's library and with the
    library at ``parent_so`` (loaded with the package's declarations, so
    the same wrappers call it), in turns."""
    from qkan_implementation_tpu_torch.experimental.pallas_layer import (
        qkan_layer_forward_batched_fused,
    )

    new = cb.load_library()
    saved_build = cb.build
    cb._lib, cb.build = None, lambda: parent_so
    try:
        parent = cb.load_library()
    finally:
        cb._lib, cb.build = new, saved_build
    b, n, k, dp1 = SHAPES[0]
    rng = np.random.default_rng(SEED + 3)
    x = torch.from_numpy(rng.uniform(-1, 1, (b, n)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((dp1, n * k)) * 0.3)
                         .astype(np.float32))
    x, w = x.cuda(), w.cuda()

    def step(lib):
        def run():
            cb._lib = lib
            try:
                xl = x.clone().requires_grad_()
                wl = w.clone().requires_grad_()
                out = qkan_layer_forward_batched_fused(xl, wl, n, k)
                return torch.autograd.grad(torch.sum(out**2), [xl, wl])
            finally:
                cb._lib = new
        return run

    fns = {"new": step(new), "parent": step(parent)}
    (gx, gw), (px, pw) = fns["new"](), fns["parent"]()
    torch.cuda.synchronize()
    held(gx, px, "both-arguments dx, new vs parent")
    held(gw, pw, "both-arguments dW, new vs parent")
    ms = event_ms(fns, 30)
    rows = []
    for v in ("new", "parent", "parent", "new"):
        dev, kernels = device_us(fns[v])
        rows.append(dict(step="both_args", shape=f"x[{b},{n}] dp1 {dp1} "
                         f"K {k}", version=v, device_us=dev,
                         event_ms=ms[v], kernels=kernels, card=smi))
        print(f"[step] both_args version={v} device_us={fmt(dev)} "
              f"event_ms={ms[v]:.4f} card='{smi}'", flush=True)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--reps", type=int, default=40)
    ap.add_argument("--ablate", action="store_true",
                    help="time the ABLATIONS instead (module docstring)")
    ap.add_argument("--parent-csrc", type=Path, default=None,
                    help="also hold the f32 K12 / K14 and the bf16-x route "
                    "to the bits of this csrc directory's build")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("m3_vs_old: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    rows = ablate(smi) if args.ablate else compare(smi, args.reps)
    if args.parent_csrc is not None:
        rows += parent_bits(smi, args.parent_csrc)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(rows, indent=1))
    print(json.dumps({"m3_ablate" if args.ablate else "m3_vs_old": [
        {k: r[k] for k in r if k != "kernels"} for r in rows],
        "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
