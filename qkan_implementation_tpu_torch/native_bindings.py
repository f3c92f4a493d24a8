"""ctypes bindings to the C++ annealer (``native/qkan_native.cpp``).

Counterpart of the annealer half of ``qkan_implementation_tpu.
native_bindings``: the C++ simulated annealer, brute-force minimiser and
energy evaluator, the host-side oracles of the port's annealer on the
card (the role neal's C++ sampler plays for the reference).  The shared
library is built from the repository's ``native/qkan_native.cpp`` with g++
at first use, into the port's git-ignored ``_build/`` (never into
``native/``); the same source and flags as the JAX package's build, so
both bindings return the same bits.

The source's circuit and statevector entries (``qkan_optimize_circuit``,
``qkan_circuit_depth``, ``qkan_sv_run``) are not bound here yet
(ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent.parent / "native" / "qkan_native.cpp"
_BUILD_DIR = Path(__file__).resolve().parent / "_build"
_LIB_PATH = _BUILD_DIR / "libqkan_native.so"
_CXXFLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]
_lib = None
_lock = threading.Lock()


class NativeUnavailable(RuntimeError):
    pass


def _build() -> None:
    if not _SRC.exists():
        raise NativeUnavailable(f"source not found: {_SRC}")
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build beside the target and rename, so a concurrent loader never
    # opens a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        try:
            proc = subprocess.run(
                ["g++", *_CXXFLAGS, "-o", tmp, str(_SRC)],
                capture_output=True, text=True,
            )
        except FileNotFoundError as e:
            raise NativeUnavailable(f"g++ not found: {e}") from e
        if proc.returncode != 0:
            raise NativeUnavailable(f"g++ failed:\n{proc.stderr}")
        os.replace(tmp, _LIB_PATH)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_native():
    """Load (building if needed) the native library; raises
    NativeUnavailable when no toolchain is present."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not _LIB_PATH.exists():
            _build()
        lib = ctypes.CDLL(str(_LIB_PATH))
        dp = ctypes.POINTER(ctypes.c_double)
        lib.qkan_anneal.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, dp, dp,
            ctypes.c_double, ctypes.c_double, ctypes.c_uint64, dp, dp,
        ]
        lib.qkan_anneal.restype = None
        lib.qkan_brute_force.argtypes = [ctypes.c_int, dp, dp, dp]
        lib.qkan_brute_force.restype = ctypes.c_double
        lib.qkan_energies.argtypes = [
            ctypes.c_int, ctypes.c_int, dp, dp, dp, dp,
        ]
        lib.qkan_energies.restype = None
        _lib = lib
        return lib


def native_available() -> bool:
    try:
        load_native()
        return True
    except NativeUnavailable:
        return False


def _as_c(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _model_arrays(model):
    return (np.ascontiguousarray(model.h, dtype=np.float64),
            np.ascontiguousarray(model.J, dtype=np.float64))


def anneal_native(
    model,
    num_reads: int = 1000,
    num_sweeps: int = 1000,
    beta_range: tuple[float, float] | None = None,
    seed: int = 0,
):
    """C++ simulated annealing; same signature/semantics as
    ``anneal.sa.simulated_annealing`` (energies include the model offset)."""
    from qkan_implementation_tpu_torch.anneal.sa import default_beta_range

    lib = load_native()
    if beta_range is None:
        beta_range = default_beta_range(model)
    if beta_range[0] <= 0 or beta_range[1] <= 0:
        # the C++ schedule would compute 0 * inf = NaN betas and silently
        # return quench samples
        raise ValueError(f"beta_range must be positive, got {beta_range}")
    n = model.num_variables
    h, J = _model_arrays(model)
    samples = np.zeros((num_reads, n), dtype=np.float64)
    energies = np.zeros(num_reads, dtype=np.float64)
    lib.qkan_anneal(
        n, num_reads, num_sweeps, _as_c(h), _as_c(J),
        float(beta_range[0]), float(beta_range[1]), int(seed) & (2**64 - 1),
        _as_c(samples), _as_c(energies),
    )
    return samples, energies + model.offset


def brute_force_native(model):
    """Exact minimum via the C++ enumerator (n <= 30)."""
    lib = load_native()
    n = model.num_variables
    if n > 30:
        raise ValueError("brute force limited to 30 variables")
    h, J = _model_arrays(model)
    sample = np.zeros(n, dtype=np.float64)
    e = lib.qkan_brute_force(n, _as_c(h), _as_c(J), _as_c(sample))
    return sample, float(e) + model.offset


def energies_native(model, samples: np.ndarray) -> np.ndarray:
    """E(s) of each row of ``samples`` by the C++ evaluator, offset
    included."""
    lib = load_native()
    samples = np.ascontiguousarray(np.atleast_2d(samples), dtype=np.float64)
    h, J = _model_arrays(model)
    out = np.zeros(samples.shape[0], dtype=np.float64)
    lib.qkan_energies(
        model.num_variables, samples.shape[0], _as_c(h), _as_c(J),
        _as_c(samples), _as_c(out),
    )
    return out + model.offset
