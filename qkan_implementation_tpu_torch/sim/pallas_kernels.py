"""CUDA counterparts of the TPU's streaming statevector kernels.

Counterpart of ``qkan_implementation_tpu.sim.pallas_kernels`` (the name is
kept so a reader finds the pair).  The dominant gate of a FABLE
block-encoding simulation is the uniformly-controlled Ry on the most
significant qubit: the state splits as psi = [2, M] and the update is one
elementwise stream,

    new0[c] = cos(theta[c]/2) * psi0[c] - sin(theta[c]/2) * psi1[c]
    new1[c] = sin(theta[c]/2) * psi0[c] + cos(theta[c]/2) * psi1[c].

The kernels (``csrc/statevector.cu``) are hand-written CUDA for Hopper:

- ``ucry_msb_cs_pallas_pair`` / ``ucry_msb_cs_pallas``: the rotation from
  precomputed c = cos(theta/2), s = sin(theta/2) (K6, serving K7);
- ``ucry_msb_pallas``: the same with sincos(theta/2) in the kernel (K8),
  the route of differentiable angles;
- ``diag_mult_pallas``: psi * diag (K9);
- ``h_gate_pallas``: a Hadamard on any qubit (K10).

Each runs on a CPU tensor as its plain torch version (``*_reference``,
written as the JAX package's XLA path writes the math) and on a CUDA
tensor as its kernel, with no fallback: a CUDA tensor of a dtype the
kernel does not take (anything but float32/float64) raises.  The TPU
functions' ``interpret`` argument is gone: the device of the tensor
decides, and the CPU path is the plain version, not an emulated kernel.
The TPU's tile rules are gone too: any power-of-two size and any qubit.

States may carry leading batch axes, psi [..., 2^q].  Angles (c, s,
theta, diag) are either [M], shared by the batch, or [..., M] with the
state's leading axes, one row per state; either way one launch covers the
batch.  ``ucry_msb_pallas`` and ``ucry_msb_cs_pallas_pair`` (and
``ucry_msb_cs_pallas``) are differentiable with the TPU functions' VJPs:
dpsi is the kernel run backwards (at -theta, or at (c, -s)), and
dtheta = (g1*y0 - g0*y1)/2 with y the saved output, dc = g0*p0 + g1*p1,
ds = g1*p0 - g0*p1 with p the saved input -- elementwise torch ops, as the
JAX package computes them outside its kernels -- summed over the batch
where the angles are shared.  ``diag_mult_pallas`` and ``h_gate_pallas``
have no backward (nor have the TPU kernels): a CUDA call that needs one
raises.

Launch counts: each function keeps ``.launches`` (and the differentiable
ones ``.bwd_launches``), raised by one where its kernel launched without
error, never at size 0.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from qkan_implementation_tpu_torch.ops._cuda_build import (
    count_launches,
    raise_on_error,
)
from qkan_implementation_tpu_torch.utils.platform import (
    tensor_device_type as _device_of,
)

_KERNEL_DTYPES = (torch.float32, torch.float64)
_INV_SQRT2 = 0.7071067811865476


def _log2(n: int, what: str) -> int:
    if n < 1 or n & (n - 1):
        raise ValueError(f"{what} must be a power of two, got {n}")
    return n.bit_length() - 1


def _halves(psi: torch.Tensor, m: int):
    """psi0, psi1 of the [..., 2, m] view."""
    v = psi.reshape(*psi.shape[:-1], 2, m)
    return v[..., 0, :], v[..., 1, :]


def _reduce_to(grad: torch.Tensor, param: torch.Tensor) -> torch.Tensor:
    """A cotangent of per-state rows summed to ``param``'s shape (shared
    angles collect the whole batch's) in ``param``'s dtype."""
    if param.dim() == 1 and grad.dim() > 1:
        grad = grad.reshape(-1, grad.shape[-1]).sum(dim=0)
    return grad.to(param.dtype)


# -- plain versions ---------------------------------------------------------


def ucry_msb_cs_reference(psi, cos_half, sin_half):
    """Plain torch K6/K7: the two halves of the [2, M] view rotated and
    stacked back."""
    m = cos_half.shape[-1]
    p0, p1 = _halves(psi, m)
    c = cos_half.to(psi.dtype)
    s = sin_half.to(psi.dtype)
    out = torch.stack([c * p0 - s * p1, s * p0 + c * p1], dim=-2)
    return out.reshape(psi.shape)


def ucry_msb_reference(psi, thetas):
    """Plain torch K8: cos/sin(theta/2) in psi's dtype, then K6's math."""
    half = thetas.to(psi.dtype) * 0.5
    return ucry_msb_cs_reference(psi, torch.cos(half), torch.sin(half))


def diag_mult_reference(psi, diag):
    """Plain torch K9."""
    return psi * diag.to(psi.dtype)


def h_gate_reference(psi, qubit: int):
    """Plain torch K10: the [outer, 2, inner] view, inner = 2^qubit."""
    inner = 2**qubit
    v = psi.reshape(-1, 2, inner)
    a, b = v[:, 0, :], v[:, 1, :]
    out = torch.stack([(a + b) * _INV_SQRT2, (a - b) * _INV_SQRT2], dim=1)
    return out.reshape(psi.shape)


# -- CUDA launches ------------------------------------------------------------


def _check_state(psi: torch.Tensor, name: str) -> torch.Tensor:
    if psi.dtype not in _KERNEL_DTYPES:
        raise ValueError(
            f"{name}: the kernel takes a float32 or float64 state, got "
            f"{psi.dtype}"
        )
    return psi.contiguous()


def _rows(param: torch.Tensor, psi: torch.Tensor, m: int, name: str):
    """(param as a contiguous tensor in psi's dtype, its batch stride):
    [m] is shared (stride 0), [..., m] with psi's leading axes has one
    row per state (stride m)."""
    if param.device != psi.device:
        raise ValueError(f"{name}: on {param.device}, the state on {psi.device}")
    if param.shape[-1] != m:
        raise ValueError(f"{name}: last axis {param.shape[-1]}, expected {m}")
    if param.dim() == 1:
        stride = 0
    elif tuple(param.shape[:-1]) == tuple(psi.shape[:-1]):
        stride = m
    else:
        raise ValueError(
            f"{name}: shape {tuple(param.shape)} is neither [{m}] nor the "
            f"state's leading axes {tuple(psi.shape[:-1])} + [{m}]"
        )
    return param.to(psi.dtype).contiguous(), stride


def _library():
    from qkan_implementation_tpu_torch.ops._cuda_build import load_library

    return load_library()


def _launch(entry: str, psi, out, args: tuple, owner, attr: str):
    """Call one C entry on psi's device and stream, raise on its error and
    count the launch."""
    lib = _library()
    with torch.cuda.device(psi.device):
        stream = torch.cuda.current_stream(psi.device).cuda_stream
        err = getattr(lib, entry)(*args, int(psi.dtype == torch.float64),
                                  stream)
    raise_on_error(lib, err, entry)
    count_launches(owner, attr)
    return out


def _ucry_pair_launch(entry, psi, params, inverse, owner, attr):
    """qkan_ucry_cs (params = (c, s)) or qkan_ucry (params = (theta,))."""
    psi = _check_state(psi, entry)
    m = params[0].shape[-1]
    log_half = _log2(m, f"{entry}: M")
    if psi.shape[-1] != 2 * m:
        raise ValueError(
            f"{entry}: state of {psi.shape[-1]} amplitudes, angles for {m}"
        )
    rows = [_rows(p, psi, m, entry) for p in params]
    if len({stride for _, stride in rows}) != 1:
        raise ValueError(f"{entry}: cos and sin must both be shared or both "
                         "per state")
    out = torch.empty_like(psi)
    batch = psi.numel() // (2 * m)
    if batch == 0:
        return out
    ptrs = [p.data_ptr() for p, _ in rows]
    return _launch(entry, psi, out,
                   (psi.data_ptr(), *ptrs, out.data_ptr(), batch, log_half,
                    rows[0][1], int(inverse)), owner, attr)


# -- K6 (and K7): rotation from precomputed cos/sin ------------------------------


def _ucry_cs_apply(psi, c, s, inverse: bool, owner, attr: str):
    if _device_of(psi) == "cpu":
        return ucry_msb_cs_reference(psi, c, -s if inverse else s)
    return _ucry_pair_launch("qkan_ucry_cs", psi, (c, s), inverse, owner, attr)


class _UcryCS(torch.autograd.Function):
    @staticmethod
    def forward(ctx, psi, cos_half, sin_half, owner):
        ctx.save_for_backward(psi, cos_half, sin_half)
        ctx.owner = owner
        return _ucry_cs_apply(psi, cos_half, sin_half, False, owner,
                              "launches")

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        psi, c, s = ctx.saved_tensors
        want_psi, want_c, want_s = ctx.needs_input_grad[:3]
        dpsi = dc = ds = None
        if want_psi:
            dpsi = _ucry_cs_apply(g, c, s, True, ctx.owner, "bwd_launches")
        if want_c or want_s:
            m = c.shape[-1]
            g0, g1 = _halves(g, m)
            p0, p1 = _halves(psi, m)
            if want_c:
                dc = _reduce_to(g0 * p0 + g1 * p1, c)
            if want_s:
                ds = _reduce_to(g1 * p0 - g0 * p1, s)
        return dpsi, dc, ds, None


def _ucry_cs(psi, cos_half, sin_half, owner):
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (psi, cos_half, sin_half)
    ):
        return _UcryCS.apply(psi, cos_half, sin_half, owner)
    return _ucry_cs_apply(psi, cos_half, sin_half, False, owner, "launches")


def ucry_msb_cs_pallas_pair(psi, cos_half, sin_half):
    """MSB multiplexed Ry from precomputed cos/sin(theta/2) (K6).

    ``psi`` [..., 2M] float32/float64; ``cos_half``, ``sin_half`` [M] or
    [..., M].  Differentiable in all three.  The static-angle route of
    ``simulate`` and the rotation of ``simulate_fable_runtime``.  Counts
    ``.launches`` and ``.bwd_launches``.
    """
    return _ucry_cs(psi, cos_half, sin_half, ucry_msb_cs_pallas_pair)


ucry_msb_cs_pallas_pair.launches = 0
ucry_msb_cs_pallas_pair.bwd_launches = 0


def ucry_msb_cs_pallas(psi, cos_half, sin_half):
    """The TPU's pre-sliced variant (K7).  On the card it is K6's kernel,
    which reads both halves in place, so the two differ only in their
    counts (``.launches``, ``.bwd_launches``)."""
    return _ucry_cs(psi, cos_half, sin_half, ucry_msb_cs_pallas)


ucry_msb_cs_pallas.launches = 0
ucry_msb_cs_pallas.bwd_launches = 0


# -- K8: rotation with the trig in the kernel ------------------------------------


def _ucry_apply(psi, thetas, inverse: bool, attr: str):
    if _device_of(psi) == "cpu":
        return ucry_msb_reference(psi, -thetas if inverse else thetas)
    return _ucry_pair_launch("qkan_ucry", psi, (thetas,), inverse,
                             ucry_msb_pallas, attr)


class _Ucry(torch.autograd.Function):
    @staticmethod
    def forward(ctx, psi, thetas):
        out = _ucry_apply(psi, thetas, False, "launches")
        ctx.save_for_backward(out, thetas)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        out, thetas = ctx.saved_tensors
        want_psi, want_theta = ctx.needs_input_grad
        dpsi = dtheta = None
        if want_psi:
            dpsi = _ucry_apply(g, thetas, True, "bwd_launches")
        if want_theta:
            m = thetas.shape[-1]
            g0, g1 = _halves(g, m)
            y0, y1 = _halves(out, m)
            dtheta = _reduce_to(0.5 * (g1 * y0 - g0 * y1), thetas)
        return dpsi, dtheta


def ucry_msb_pallas(psi, thetas):
    """MSB multiplexed Ry with cos/sin(theta/2) taken in the kernel (K8).

    ``psi`` [..., 2M] float32/float64; ``thetas`` [M] or [..., M] (cast to
    psi's dtype).  Differentiable in both: the traced-angle route of
    ``simulate`` and so the quantum layer's forward and gradient.  Counts
    ``.launches`` (forward) and ``.bwd_launches`` (the psi-cotangent).
    """
    if torch.is_grad_enabled() and (psi.requires_grad or thetas.requires_grad):
        return _Ucry.apply(psi, thetas)
    return _ucry_apply(psi, thetas, False, "launches")


ucry_msb_pallas.launches = 0
ucry_msb_pallas.bwd_launches = 0


# -- K9, K10 ------------------------------------------------------------------------


def _no_backward(name: str, *tensors) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward on the card (the TPU kernel has none "
            "either); use the plain version or simulate(backend='xla')"
        )


def diag_mult_pallas(psi, diag):
    """Elementwise diagonal-gate multiply over the full statevector (K9).

    ``psi`` [..., n], ``diag`` [n] or [..., n].  Counts ``.launches``.
    """
    if _device_of(psi) == "cpu":
        return diag_mult_reference(psi, diag)
    _no_backward("diag_mult_pallas", psi, diag)
    psi = _check_state(psi, "qkan_diag_mult")
    n = psi.shape[-1]
    log_dim = _log2(n, "qkan_diag_mult: state size")
    d, stride = _rows(diag, psi, n, "qkan_diag_mult")
    out = torch.empty_like(psi)
    batch = psi.numel() // n
    if batch == 0:
        return out
    return _launch("qkan_diag_mult", psi, out,
                   (psi.data_ptr(), d.data_ptr(), out.data_ptr(), batch,
                    log_dim, stride), diag_mult_pallas, "launches")


diag_mult_pallas.launches = 0


def h_gate_pallas(psi, qubit: int):
    """Hadamard on any qubit of ``psi`` [..., 2^q] over the
    [outer, 2, inner] view, inner = 2^qubit, in one pass (K10).  Counts
    ``.launches``."""
    n = psi.shape[-1]
    _log2(n, "h_gate_pallas: state size")
    if qubit < 0 or 2 ** (qubit + 1) > n:
        raise ValueError(f"qubit {qubit} out of range for {n} amplitudes")
    if _device_of(psi) == "cpu":
        return h_gate_reference(psi, qubit)
    _no_backward("h_gate_pallas", psi)
    psi = _check_state(psi, "qkan_h_pair")
    out = torch.empty_like(psi)
    outer = psi.numel() // 2 ** (qubit + 1)
    if outer == 0:
        return out
    return _launch("qkan_h_pair", psi, out,
                   (psi.data_ptr(), out.data_ptr(), outer, qubit),
                   h_gate_pallas, "launches")


h_gate_pallas.launches = 0


def simulate_fable_pallas(a: np.ndarray, psi0: torch.Tensor | None = None,
                          device="cuda"):
    """Simulate a FABLE block-encoding circuit gate by gate on the kernels.

    Builds ``fable(a)`` (H on the row register, the fused ucry, the
    register swap, H again) and runs every ucry on K8 and every H on K10
    (a complex state takes the plain gate ops there); the swaps take the
    plain gate ops.  The state is float32 |0...0> on
    ``device`` unless ``psi0`` is given (then its device).  Returns
    ``(psi, alpha)``: the final statevector and the FABLE subnormalization.
    """
    from qkan_implementation_tpu_torch.encoding.fable import fable
    from qkan_implementation_tpu_torch.sim.statevector import (
        _pallas_eligible,
        apply_gate,
        zero_state,
    )

    circ, alpha = fable(a)
    q = circ.num_qubits
    psi = zero_state(q, torch.float32, device) if psi0 is None else psi0
    for gate in circ.gates:
        if _pallas_eligible(gate, q, psi.dtype):
            thetas = torch.as_tensor(np.asarray(gate.params), dtype=psi.dtype,
                                     device=psi.device)
            psi = ucry_msb_pallas(psi, thetas)
        elif gate.name == "h" and psi.dtype in _KERNEL_DTYPES:
            psi = h_gate_pallas(psi, gate.qubits[0])
        else:
            psi = apply_gate(psi, gate, q)
    return psi, alpha
