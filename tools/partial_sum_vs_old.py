"""Time the fixed-order partial-sum pass (``csrc/partial_sum.cu``) against
the one-thread-an-output kernels it replaced, on the same partials, on one
CUDA card:

    python tools/partial_sum_vs_old.py [--out PATH.json]

The old kernels (``m3_dm_sum_kernel`` of ``csrc/qkan_layer_m3.cu`` and
``fused_bwd_partial_sum_kernel`` of ``csrc/fused_dw_bwd.cu`` at commit
0bc7646, with their launch grids) are kept below as they were.  The new
pass is compiled from ``csrc/partial_sum.cu`` twice: as the package builds
it ('new': one thread an output up to 32 partials, the segmented form
past them) and with the segmented form at every count of partials
('segmented', ``-DQKAN_PS_SMALL_NBLK=0``).  The partials are real:
the workspace of a backward (K2 at the flagship's layer 0, B 4096; the
train step's four layers at B 64), the K5 headline step's, and K14's dM
partials at the M3 headline and at N16 K128 B 4096.

Each kernel is first held bit for bit to the plain sum in its own order
(``fixed_order_sum_reference`` with its segment count; the old kernels
sum in block order, one segment).  Then each is timed beside
``torch.sum(part, dim=0)``: device µs a launch (torch.profiler) and the
median CUDA-event ms of one call, all kernels of a case called in turns.
Prints one line a (case, kernel) and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from qkan_implementation_tpu_torch.experimental import pallas_layer as pl  # noqa: E402
from qkan_implementation_tpu_torch.ops import _cuda_build as cb  # noqa: E402
from qkan_implementation_tpu_torch.ops.fused_layer import (  # noqa: E402
    _bwd_pass,
    _step_pass,
    fixed_order_sum_reference,
    fused_bwd_workspace_partials,
)

OLD_SRC = r"""
#include <cuda_runtime.h>

// dm[i] = sum over blocks of part[blk][i], in block order
__global__ void __launch_bounds__(256)
m3_dm_sum_kernel(const float* __restrict__ part, float* __restrict__ dm,
                 int nblk, long long per) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < per; i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int b = 0; b < nblk; ++b) s += part[(size_t)b * per + i];
    dm[i] = s;
  }
}

// The fixed-order pass: dw[d, i, c] = sum over row blocks of the partials,
// in row-block order.  dW_0 rows all take the colsum(g) sum.
__global__ void fused_bwd_partial_sum_kernel(const float* __restrict__ part,
                                             const float* __restrict__ gpart,
                                             float* __restrict__ dw, int nrb,
                                             int in, int dp1, int T) {
  const size_t per_d = (size_t)in * T;
  const size_t total = (size_t)dp1 * per_d;
  const size_t stride = (size_t)(dp1 - 1) * per_d;  // one row block's share
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (size_t)gridDim.x * blockDim.x) {
    const size_t d = idx / per_d;
    const size_t rem = idx - d * per_d;
    float s = 0.f;
    if (d == 0) {
      const size_t c = rem % T;
      for (int rb = 0; rb < nrb; ++rb) s += gpart[(size_t)rb * T + c];
    } else {
      const float* p = part + (d - 1) * per_d + rem;
      for (int rb = 0; rb < nrb; ++rb) s += p[(size_t)rb * stride];
    }
    dw[idx] = s;
  }
}

extern "C" int old_dm_sum(const void* part, void* dm, int nblk,
                          long long per, void* stream) {
  long long blocks = (per + 255) / 256;
  if (blocks > 132 * 16) blocks = 132 * 16;
  m3_dm_sum_kernel<<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(
      (const float*)part, (float*)dm, nblk, per);
  return (int)cudaGetLastError();
}

extern "C" int old_dw_sum(const void* part, const void* gpart, void* dw,
                          int nrb, int in, int dp1, int T, void* stream) {
  const size_t total = (size_t)dp1 * in * T;
  size_t blocks = (total + 255) / 256;
  if (blocks > 132 * 16) blocks = 132 * 16;
  fused_bwd_partial_sum_kernel<<<(unsigned)blocks, 256, 0,
                                 (cudaStream_t)stream>>>(
      (const float*)part, (const float*)gpart, (float*)dw, nrb, in, dp1, T);
  return (int)cudaGetLastError();
}
"""

NEW_SRC = r"""
#include "qkan_common.cuh"

extern "C" int ps_segments(int nblk, long long per) {
  return qkan::partial_sum_segments(nblk, per);
}

extern "C" int ps_launch(const void* part, long long per, int nblk, void* out,
                         const void* gpart, int T, int rows, void* out_b,
                         void* stream) {
  return (int)qkan::partial_sum((const float*)part, per, nblk, (float*)out,
                                (const float*)gpart, T, rows, (float*)out_b,
                                (cudaStream_t)stream);
}
"""

# builds of the new pass: name -> QKAN_PS_SMALL_NBLK
RULES = {"new": 32, "segmented": 0}

SHAPE = [784, 32, 16, 16, 10]  # the flagship FixedKAN
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, as chip_smoke.py's bound()
FP32_FLOP_PER_S = 67e12
DP1 = 6
TRAIN_BATCH = 64


def build(workdir: Path) -> dict:
    """The old kernels' library and one library a rule, compiled at once."""
    nvcc = cb.find_nvcc()
    (workdir / "old.cu").write_text(OLD_SRC)
    (workdir / "launch.cu").write_text(NEW_SRC)
    flags = [*cb.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
             "-shared"]
    cmds = {"old": [nvcc, *flags, "-o", str(workdir / "old.so"),
                    str(workdir / "old.cu")]}
    for name, small in RULES.items():
        cmds[name] = [
            nvcc, *flags, f"-DQKAN_PS_SMALL_NBLK={small}",
            "-I", str(cb.CSRC_DIR), "-o", str(workdir / f"{name}.so"),
            str(cb.CSRC_DIR / "partial_sum.cu"), str(workdir / "launch.cu"),
        ]
    cb._run_all(list(cmds.values()))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    libs = {}
    for name in cmds:
        lib = ctypes.CDLL(str(workdir / f"{name}.so"))
        if name == "old":
            lib.old_dm_sum.argtypes = [p, p, i, ll, p]
            lib.old_dw_sum.argtypes = [p, p, p, i, i, i, i, p]
        else:
            lib.ps_segments.argtypes = [i, ll]
            lib.ps_segments.restype = i
            lib.ps_launch.argtypes = [p, ll, i, p, p, i, i, p, p]
        libs[name] = lib
    return libs


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def dm_case(rng, b, n, k, dp1):
    """K14's dM partials [nblk, dp1*N*K] at (B, N, K, dp1)."""
    x = torch.from_numpy(rng.uniform(-1, 1, (b, n)).astype(np.float32))
    m3 = torch.from_numpy(rng.normal(0, 0.1, (dp1, n, k)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(b, k)).astype(np.float32))
    _, part, _ = pl._bwd_pass(x.cuda(), m3.cuda(), g.cuda(), False)
    return part.reshape(part.shape[0], -1), None, None


def dw_case(rng, b, n, dp1, t_dim, want_dx, step=False):
    """A workspace's dW_d partials [nrb, (dp1-1)*in*T] and colsum(g)
    partials [nrb, T]: K2's (``step`` False) or K5's."""
    x = torch.from_numpy(rng.uniform(-2, 2, (b, n)).astype(np.float32)).cuda()
    w2 = torch.from_numpy(rng.normal(0, 1 / np.sqrt(dp1 * n), (dp1 * n, t_dim))
                          .astype(np.float32)).cuda()
    if step:
        _, ws, _ = _step_pass(x, w2, dp1, None, "sumsq", False)
    else:
        g = torch.from_numpy(rng.normal(size=(b, t_dim)).astype(np.float32))
        ws = _bwd_pass("qkan_fused_dw_bwd", x, w2, g.cuda(), dp1, True, (0,),
                       want_dx)[1]
    part, gpart = fused_bwd_workspace_partials(ws, b, n, dp1, t_dim,
                                               step=step)
    return part, gpart, (n, dp1, t_dim)


def cases(rng) -> dict:
    out = {
        "dM_headline": dm_case(rng, 262144, 16, 16, 8),
        "dM_N16_K128_B4096": dm_case(rng, 4096, 16, 128, 8),
        "dW_layer0_B4096": dw_case(rng, 4096, SHAPE[0], DP1, SHAPE[-1], True),
        "dW_k5_headline": dw_case(rng, 262144, 16, 8, 16, False, step=True),
    }
    for layer, (n, t_dim) in enumerate(zip(SHAPE[:-1], SHAPE[1:])):
        out[f"dW_train_layer{layer}_B64"] = dw_case(
            rng, TRAIN_BATCH, n, DP1, t_dim, layer > 0)
    return out


def calls_of(libs, part, gpart, dims):
    """name -> (call returning the sums, plain sums in its own order)."""
    nblk, per = part.shape
    calls = {}
    if gpart is None:
        out = torch.empty(per, device="cuda")

        def old():
            _check(libs["old"].old_dm_sum(part.data_ptr(), out.data_ptr(),
                                          nblk, per, _stream()), "old")
            return out

        calls["old"] = (old, lambda: fixed_order_sum_reference(part, 1))
        for name in RULES:
            lib = libs[name]
            seg = lib.ps_segments(nblk, per)
            o = torch.empty(per, device="cuda")

            def new(lib=lib, o=o, name=name):
                _check(lib.ps_launch(part.data_ptr(), per, nblk, o.data_ptr(),
                                     None, 0, 0, None, _stream()), name)
                return o

            calls[name] = (new, lambda seg=seg: fixed_order_sum_reference(
                part, seg))
        return calls, {n: (libs[n].ps_segments(nblk, per)) for n in RULES}
    n, dp1, t_dim = dims
    dw = torch.empty((dp1 * n, t_dim), device="cuda")

    def plain(seg):
        return torch.cat([
            fixed_order_sum_reference(gpart, seg).expand(n, -1),
            fixed_order_sum_reference(part, seg).view(-1, t_dim)])

    def old():
        _check(libs["old"].old_dw_sum(part.data_ptr(), gpart.data_ptr(),
                                      dw.data_ptr(), nblk, n, dp1, t_dim,
                                      _stream()), "old")
        return dw

    calls["old"] = (old, lambda: plain(1))
    for name in RULES:
        lib = libs[name]
        seg = lib.ps_segments(nblk, per)
        o = torch.empty((dp1 * n, t_dim), device="cuda")

        def new(lib=lib, o=o, name=name):
            _check(lib.ps_launch(part.data_ptr(), per, nblk,
                                 o[n:].data_ptr(), gpart.data_ptr(), t_dim,
                                 n, o.data_ptr(), _stream()), name)
            return o

        calls[name] = (new, lambda seg=seg: plain(seg))
    return calls, {n_: libs[n_].ps_segments(nblk, per) for n_ in RULES}


def device_us(fn, calls: int = 20) -> float | None:
    """Mean device µs a call of ``fn`` over ``calls`` calls."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        total = 0.0
        for ev in prof.key_averages():
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = getattr(ev, "self_device_time_total", None)
            total += float(ev.self_cuda_time_total if us is None else us)
        if total > 0:
            return total / calls
    return None


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


def bound_us(part, gpart, dims) -> tuple[float, str]:
    """Least µs of the pass on one H100: the partials read once and the
    sums written once over the HBM rate, or one add a partial over the
    FP32 rate, the larger."""
    nblk, per = part.shape
    if gpart is None:
        moved, adds = 4.0 * (nblk * per + per), float(nblk * per)
    else:
        n, dp1, t_dim = dims
        moved = 4.0 * (nblk * (per + t_dim) + dp1 * n * t_dim)
        adds = float(nblk * (per + t_dim))
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, adds / FP32_FLOP_PER_S
    return ((t_bytes * 1e6, "bytes") if t_bytes >= t_ops
            else (t_ops * 1e6, "operations"))


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
    rng = np.random.default_rng(9)
    table = {}
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(Path(tmp))
        for tag, (part, gpart, dims) in cases(rng).items():
            fns, segs = calls_of(libs, part, gpart, dims)
            for name, (fn, plain) in fns.items():
                got, again, want = fn().clone(), fn().clone(), plain()
                torch.cuda.synchronize()
                if not (torch.equal(got, want) and torch.equal(got, again)):
                    raise AssertionError(f"{tag} {name}: not the bits of the "
                                         "plain sum in its order")
            timed = {k: f for k, (f, _) in fns.items()}
            timed["torch_sum"] = lambda part=part: torch.sum(part, dim=0)
            ms = event_ms(timed)
            nblk, per = part.shape
            b_us, b_by = bound_us(part, gpart, dims)
            table[tag] = {"nblk": nblk, "per": per, "segments": segs,
                          "bound_us": b_us, "bound_by": b_by, "kernels": {}}
            for k, f in timed.items():
                dev = device_us(f)
                table[tag]["kernels"][k] = {"device_us": dev, "ms": ms[k]}
                print(f"[time] case={tag} nblk={nblk} per={per} kernel={k} "
                      f"segments={segs.get(k, 1 if k == 'old' else '-')} "
                      f"device_us={'not measured' if dev is None else f'{dev:.3f}'} "
                      f"ms={ms[k]:.4f} bound_us={b_us:.3f} bound_by={b_by} "
                      f"card='{smi}'", flush=True)
    result = {"card": smi, "cases": table}
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
