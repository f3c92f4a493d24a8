"""Build the package's CUDA kernels with nvcc and load them with ctypes.

The sources are the package's own ``csrc/*.cu`` (with the shared
``csrc/*.cuh``), compiled at first use into one shared library with a
plain C interface.  Each source compiles in its own nvcc process, all
started together, and one more links them:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -Xptxas -v -c -o <name>.o csrc/<name>.cu   (each)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared
         -o _build/libqkan_kernels_<hash>.so *.o

The library lands in ``qkan_implementation_tpu_torch/_build/``, named by a
hash of the sources and flags, so an edited source builds anew and an
unchanged one is loaded from disk.  ptxas's register and spill report of
the build is kept beside it (``ptxas_<hash>.log``).  Nothing here runs at
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

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


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


def _sources() -> list[Path]:
    srcs = sorted(CSRC_DIR.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    return srcs


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256()
    for src in sorted([*CSRC_DIR.glob("*.cu"), *CSRC_DIR.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    return BUILD_DIR / f"libqkan_kernels_{h.hexdigest()[:16]}.so"


def ptxas_log_path() -> Path:
    """ptxas's report (registers, shared memory, spills) of the build."""
    return library_path().with_name(
        library_path().stem.replace("libqkan_kernels", "ptxas") + ".log"
    )


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


def build() -> Path:
    """Compile ``csrc/*.cu`` unless the library is already on disk."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in _sources()]
        logs = _run_all([
            [nvcc, *COMPILE_FLAGS, "-o", str(o), str(src)]
            for src, o in zip(_sources(), objs)
        ])
        # link under a temporary name, then rename: a concurrent process
        # never loads a half-written library
        lib_tmp = Path(tmp) / out.name
        _run_all([[nvcc, *LINK_FLAGS, "-o", str(lib_tmp), *map(str, objs)]])
        ptxas_log_path().write_text("".join(logs))
        os.replace(lib_tmp, out)
    return out


def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare the C entries."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.qkan_fused_dw_fwd.argtypes = [
                p, p, p, i, i, i, i, i, i, i, p,
            ]
            lib.qkan_fused_fwd.argtypes = [p, p, p, i, i, i, i, i, i, p]
            lib.qkan_fused_bwd_workspace_bytes.argtypes = [i, i, i, i, i]
            lib.qkan_fused_bwd_workspace_bytes.restype = ll
            lib.qkan_fused_bwd_row_blocks.argtypes = [i, i, i, i]
            lib.qkan_fused_bwd_row_blocks.restype = i
            lib.qkan_fused_bwd_launches.argtypes = [i, i]
            lib.qkan_fused_bwd_launches.restype = i
            lib.qkan_fused_dw_bwd.argtypes = [
                p, p, p, p, p, ll, i, i, i, i, i, i, i, i, p,
            ]
            lib.qkan_fused_bwd.argtypes = [
                p, p, p, p, p, ll, i, i, i, i, i, i, i, p,
            ]
            lib.qkan_fused_bwd_partial_sum.argtypes = [
                p, ll, p, i, i, i, i, i, p,
            ]
            lib.qkan_fused_step_workspace_bytes.argtypes = [i, i, i, i]
            lib.qkan_fused_step_workspace_bytes.restype = ll
            f = ctypes.c_float
            lib.qkan_fused_step.argtypes = [
                p, p, p, p, p, ll, i, i, i, i, i, i, f, f, p,
            ]
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
            lib.qkan_m3_fwd.argtypes = [p, p, p, ll, i, i, i, i, p]
            lib.qkan_m3_bwd.argtypes = [p, p, p, p, p, ll, ll, i, i, i, i,
                                        i, p]
            lib.qkan_m3_dm_sum.argtypes = [p, p, i, ll, p]
            # the global-qubit exchange with its 2x2 (csrc/exchange.cu)
            lib.qkan_exchange_ucry.argtypes = [p, p, p, p, p, ll, i, i, p]
            lib.qkan_exchange_h.argtypes = [p, p, p, ll, i, i, p]
            for entry in ("qkan_fused_dw_fwd", "qkan_fused_fwd",
                          "qkan_fused_dw_bwd", "qkan_fused_bwd",
                          "qkan_fused_bwd_partial_sum", "qkan_fused_step",
                          "qkan_ucry_cs", "qkan_ucry", "qkan_diag_mult",
                          "qkan_h_pair", "qkan_m3_fwd", "qkan_m3_bwd",
                          "qkan_m3_dm_sum", "qkan_exchange_ucry",
                          "qkan_exchange_h"):
                getattr(lib, entry).restype = i
            lib.qkan_cuda_error_string.argtypes = [i]
            lib.qkan_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def raise_on_error(lib: ctypes.CDLL, err: int, name: str) -> None:
    """Raise if a C entry returned a CUDA error (0 is success)."""
    if err != 0:
        msg = lib.qkan_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({err})")


# server threads launch concurrently: the counts' read-modify-write is locked
_LAUNCHES_LOCK = threading.Lock()


def count_launches(owner, attr: str, n: int = 1) -> None:
    """Add ``n`` to the launch count ``owner.attr``."""
    with _LAUNCHES_LOCK:
        setattr(owner, attr, getattr(owner, attr) + n)
