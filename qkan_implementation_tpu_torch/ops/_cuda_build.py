"""Build the package's CUDA kernels with nvcc and load them with ctypes.

The sources are the package's own ``csrc/*.cu`` (with the shared
``csrc/*.cuh``), compiled at first use into shared libraries with a
plain C interface: the block-diagonal annealer's sweeps and polish
(``ANNEAL_SOURCES``) into a small library of their own
(``load_anneal_library``), so a structure search waits for that build
alone, and every other source into the kernels' library
(``load_library``).  Each source compiles in its own nvcc process, all
started together, and one more links them:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -Xptxas -v -c -o <name>.o csrc/<name>.cu   (each)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared
         -o _build/libqkan_<group>_<hash>.so *.o

A library lands in ``qkan_implementation_tpu_torch/_build/``, named by
its group (``kernels`` or ``anneal``) and a hash of its sources, the
headers and the flags, so an edited source builds anew and an unchanged
one is loaded from disk.  ptxas's register and spill report of the build
is kept beside it (``ptxas_<group>_<hash>.log``).  Nothing here runs at
import time: the CPU-only test machine has no nvcc and never calls
``load_library``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (
    *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v", "-c",
)
LINK_FLAGS = (*ARCH_FLAGS, "-shared")

# sources built into the annealer's own library, not the kernels'
ANNEAL_SOURCES = ("anneal_blocked.cu",)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_anneal_lib: ctypes.CDLL | None = None


def find_nvcc() -> str:
    """Path of nvcc: ``$CUDA_HOME/bin``, then ``PATH``, then /usr/local/cuda."""
    candidates = []
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            candidates.append(Path(os.environ[var]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin):"
        " the CUDA kernels of qkan_implementation_tpu_torch cannot be built"
    )


def _sources(group: str = "kernels") -> list[Path]:
    """The ``.cu`` files of a library: ``ANNEAL_SOURCES`` for "anneal",
    every other one for "kernels"."""
    if group == "anneal":
        srcs = [CSRC_DIR / name for name in ANNEAL_SOURCES]
    else:
        srcs = [s for s in sorted(CSRC_DIR.glob("*.cu"))
                if s.name not in ANNEAL_SOURCES]
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    return srcs


def library_path(group: str = "kernels") -> Path:
    """Where the library for the group's current sources and flags lives."""
    h = hashlib.sha256()
    for src in sorted([*_sources(group), *CSRC_DIR.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    return BUILD_DIR / f"libqkan_{group}_{h.hexdigest()[:16]}.so"


def ptxas_log_path(group: str = "kernels") -> Path:
    """ptxas's report (registers, shared memory, spills) of the build."""
    lib = library_path(group)
    return lib.with_name(lib.stem.replace("libqkan_", "ptxas_") + ".log")


def _run_all(cmds: list[list[str]]) -> list[str]:
    """Run the commands at once; raise with the first failure's output."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True)
        for c in cmds
    ]
    outs = [p.communicate() for p in procs]
    for cmd, p, (out, err) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({p.returncode}):\n{' '.join(cmd)}\n{out}{err}"
            )
    return [out + err for out, err in outs]


def build(group: str = "kernels") -> Path:
    """Compile the group's sources unless its library is already on disk."""
    out = library_path(group)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in _sources(group)]
        logs = _run_all([
            [nvcc, *COMPILE_FLAGS, "-o", str(o), str(src)]
            for src, o in zip(_sources(group), objs)
        ])
        # link under a temporary name, then rename: a concurrent process
        # never loads a half-written library
        lib_tmp = Path(tmp) / out.name
        _run_all([[nvcc, *LINK_FLAGS, "-o", str(lib_tmp), *map(str, objs)]])
        ptxas_log_path(group).write_text("".join(logs))
        os.replace(lib_tmp, out)
    return out


def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare the C entries."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            # the forwards take a workspace (or null) for their feature
            # splits' partials
            lib.qkan_fused_dw_fwd.argtypes = [
                p, p, p, p, ll, i, i, i, i, i, i, i, p,
            ]
            lib.qkan_fused_fwd.argtypes = [
                p, p, p, p, ll, i, i, i, i, i, i, p,
            ]
            lib.qkan_fused_fwd_workspace_bytes.argtypes = [i, i, i, i]
            lib.qkan_fused_fwd_workspace_bytes.restype = ll
            lib.qkan_fused_fwd_tensor_cores.argtypes = [i, i, i, i]
            lib.qkan_fused_fwd_tensor_cores.restype = i
            lib.qkan_fused_fwd_splits.argtypes = [i, i, i, i]
            lib.qkan_fused_fwd_splits.restype = i
            lib.qkan_fused_bwd_col_slices.argtypes = [i]
            lib.qkan_fused_bwd_col_slices.restype = i
            # the backward's route, layout and launches take x's dtype and
            # the mode (x_is_bf16, round_bf16) after the sizes
            lib.qkan_fused_bwd_workspace_bytes.argtypes = [i] * 7
            lib.qkan_fused_bwd_workspace_bytes.restype = ll
            lib.qkan_fused_bwd_row_blocks.argtypes = [i] * 6
            lib.qkan_fused_bwd_row_blocks.restype = i
            lib.qkan_fused_bwd_launches.argtypes = [i] * 5
            lib.qkan_fused_bwd_launches.restype = i
            lib.qkan_fused_bwd_tensor_cores.argtypes = [i] * 5
            lib.qkan_fused_bwd_tensor_cores.restype = i
            lib.qkan_fused_bwd_feature_chunk.argtypes = [i] * 5
            lib.qkan_fused_bwd_feature_chunk.restype = i
            # the backwards and the step take dw (or null) before the
            # stream: given it, they launch the fixed-order pass too
            lib.qkan_fused_dw_bwd.argtypes = [
                p, p, p, p, p, ll, i, i, i, i, i, i, i, i, p, p,
            ]
            lib.qkan_fused_bwd.argtypes = [
                p, p, p, p, p, ll, i, i, i, i, i, i, i, p, p,
            ]
            lib.qkan_fused_bwd_partial_sum.argtypes = [
                p, ll, p, i, i, i, i, i, i, i, p,
            ]
            lib.qkan_fused_step_workspace_bytes.argtypes = [i, i, i, i]
            lib.qkan_fused_step_workspace_bytes.restype = ll
            f = ctypes.c_float
            lib.qkan_fused_step.argtypes = [
                p, p, p, p, p, ll, i, i, i, i, i, i, f, f, p, p,
            ]
            lib.qkan_fused_step_row_blocks.argtypes = [i, i, i, i]
            lib.qkan_fused_step_row_blocks.restype = i
            lib.qkan_fused_step_tensor_cores.argtypes = [i, i, i]
            lib.qkan_fused_step_tensor_cores.restype = i
            lib.qkan_fused_step_col_slice.argtypes = [i, i, i]
            lib.qkan_fused_step_col_slice.restype = i
            lib.qkan_fused_step_partial_sum.argtypes = [
                p, ll, p, i, i, i, i, p,
            ]
            # the fixed-order partial-sum pass (csrc/partial_sum.cu)
            lib.qkan_partial_sum_segments.argtypes = [i, ll]
            lib.qkan_partial_sum_segments.restype = i
            # statevector kernels (csrc/statevector.cu)
            lib.qkan_ucry_cs.argtypes = [p, p, p, p, ll, i, ll, i, i, p]
            lib.qkan_ucry.argtypes = [p, p, p, ll, i, ll, i, i, p]
            lib.qkan_diag_mult.argtypes = [p, p, p, ll, i, ll, i, p]
            lib.qkan_h_pair.argtypes = [p, p, ll, i, i, p]
            # the batched QKAN layer over M3 (csrc/qkan_layer_m3.cu)
            lib.qkan_m3_smem_bytes.argtypes = [i, i, i, i]
            lib.qkan_m3_smem_bytes.restype = ll
            lib.qkan_m3_smem_limit.argtypes = []
            lib.qkan_m3_smem_limit.restype = ll
            lib.qkan_m3_bwd_blocks.argtypes = [ll, i, i, i, i]
            lib.qkan_m3_bwd_blocks.restype = i
            lib.qkan_m3_slice_n.argtypes = [i, i, i, i]
            lib.qkan_m3_slice_n.restype = i
            lib.qkan_m3_slice_k.argtypes = [i, i, i, i]
            lib.qkan_m3_slice_k.restype = i
            lib.qkan_m3_launches.argtypes = [i, i, i, i]
            lib.qkan_m3_launches.restype = ll
            lib.qkan_m3_carry_bytes.argtypes = [ll, i, i, i, i]
            lib.qkan_m3_carry_bytes.restype = ll
            lib.qkan_m3_fwd.argtypes = [p, p, p, p, ll, ll, i, i, i, i, p]
            lib.qkan_m3_bwd.argtypes = [p, p, p, p, p, ll, ll, i, i, i, i,
                                        i, p, p]
            lib.qkan_m3_dm_sum.argtypes = [p, p, i, ll, p]
            lib.qkan_m3_tc_plan.argtypes = [i, i, i, i, i,
                                            ctypes.POINTER(ll)]
            lib.qkan_m3_tc_plan.restype = i
            # the global-qubit exchange with its 2x2 (csrc/exchange.cu)
            lib.qkan_exchange_ucry.argtypes = [p, p, p, p, p, ll, i, i, p]
            lib.qkan_exchange_h.argtypes = [p, p, p, ll, i, i, p]
            for entry in ("qkan_fused_dw_fwd", "qkan_fused_fwd",
                          "qkan_fused_dw_bwd", "qkan_fused_bwd",
                          "qkan_fused_bwd_partial_sum", "qkan_fused_step",
                          "qkan_fused_step_partial_sum",
                          "qkan_ucry_cs", "qkan_ucry", "qkan_diag_mult",
                          "qkan_h_pair", "qkan_m3_fwd", "qkan_m3_bwd",
                          "qkan_m3_dm_sum", "qkan_exchange_ucry",
                          "qkan_exchange_h"):
                getattr(lib, entry).restype = i
            lib.qkan_cuda_error_string.argtypes = [i]
            lib.qkan_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def load_anneal_library() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare the C entries of
    the annealer's library (``csrc/anneal_blocked.cu``: its sweeps and its
    one-hot polish)."""
    global _anneal_lib
    with _lock:
        if _anneal_lib is None:
            lib = ctypes.CDLL(str(build("anneal")))
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.qkan_anneal_blocked_sweeps.argtypes = [
                p, p, p, p, p, i, i, ll, i, i, p,
            ]
            lib.qkan_anneal_blocked_sweeps.restype = i
            lib.qkan_anneal_polish_blocked.argtypes = [
                p, p, p, p, p, i, ll, i, i, p,
            ]
            lib.qkan_anneal_polish_blocked.restype = i
            lib.qkan_cuda_error_string.argtypes = [i]
            lib.qkan_cuda_error_string.restype = ctypes.c_char_p
            _anneal_lib = lib
    return _anneal_lib


def raise_on_error(lib: ctypes.CDLL, err: int, name: str) -> None:
    """Raise if a C entry returned a CUDA error (0 is success)."""
    if err != 0:
        msg = lib.qkan_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({err})")


# server threads launch concurrently: the counts' read-modify-write is locked
_LAUNCHES_LOCK = threading.Lock()


def count_launches(owner, attr: str, n: int = 1) -> None:
    """Add ``n`` to the count ``owner.attr``: a kernel's launches, or
    another number of the program's work (``solve_qubo.calls``,
    ``solve_qubo.sweeps``)."""
    with _LAUNCHES_LOCK:
        setattr(owner, attr, getattr(owner, attr) + n)
