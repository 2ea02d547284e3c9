"""K6: the per-node phase multiply of the rfft + ``use_pallas`` route in one
hand-written CUDA kernel, and its plain PyTorch version.

Counterpart of ``boltzfft/pallas_kernels.py``'s ``alpha_multiply`` ->
``_alpha_multiply_kernel``.  :func:`alpha_multiply` dispatches on the device
of ``f_hat``: a CUDA tensor runs the kernel of ``csrc/alpha_multiply.cu`` (or
raises), a CPU tensor runs :func:`alpha_multiply_reference`.  Any other
device raises.

Both compute, for B nodes with separable phases ``ax`` (B, N) and
``ayz`` (B, M2) (the y and z-half factors combined) and a flattened half
spectrum ``f_hat`` (N, M2):

* ``a1f[b, i, m] = ax[b, i] * (ayz[b, m] * f_hat[i, m])``;
* ``a2f[b, i, m] = conj(ax[b, i]) * (conj(ayz[b, m]) * f_hat[i, m])``,

in the JAX kernel's order of multiplication, every product and sum rounded
on its own, so on the card the kernel and the plain version agree bitwise.
JAX passes (re, im) planes because Pallas on a TPU has no complex type; the
port passes complex tensors, the layout ``torch.fft`` reads and writes.
"""

from __future__ import annotations

import torch

#: Launches of the CUDA kernel (one per :func:`alpha_multiply` call on CUDA).
LAUNCHES = 0
#: Calls of the plain PyTorch version.
REFERENCE_CALLS = 0


def alpha_multiply(ax: torch.Tensor, ayz: torch.Tensor, f_hat: torch.Tensor):
    """``(a1f, a2f)``, each complex (B, N, M2), from ``ax`` (B, N), ``ayz``
    (B, M2) and ``f_hat`` (N, M2), all complex of one dtype."""
    if f_hat.device.type == "cuda":
        return _alpha_multiply_cuda(ax, ayz, f_hat)
    if f_hat.device.type == "cpu":
        return alpha_multiply_reference(ax, ayz, f_hat)
    raise ValueError(f"alpha_multiply: no kernel for device {f_hat.device}")


def alpha_multiply_reference(ax, ayz, f_hat):
    """Plain PyTorch version: the kernel's real arithmetic as separate
    elementwise ops on (re, im) planes."""
    global REFERENCE_CALLS
    REFERENCE_CALLS += 1
    fr, fi = f_hat.real[None], f_hat.imag[None]  # (1, N, M2)
    yr, yi = ayz.real[:, None, :], ayz.imag[:, None, :]  # (B, 1, M2)
    xr, xi = ax.real[:, :, None], ax.imag[:, :, None]  # (B, N, 1)
    m1r = yr * fr - yi * fi
    m1i = yr * fi + yi * fr
    m2r = yr * fr + yi * fi
    m2i = yr * fi - yi * fr
    a1f = torch.complex(xr * m1r - xi * m1i, xr * m1i + xi * m1r)
    a2f = torch.complex(xr * m2r + xi * m2i, xr * m2i - xi * m2r)
    return a1f, a2f


def _alpha_multiply_cuda(ax, ayz, f_hat):
    global LAUNCHES
    from .._build import load_library

    cd = f_hat.dtype
    if cd not in (torch.complex64, torch.complex128):
        raise TypeError(f"alpha_multiply: complex64/complex128 only, got {cd}")
    if f_hat.dim() != 2 or ax.dim() != 2 or ayz.dim() != 2:
        raise ValueError("alpha_multiply: ax (B, N), ayz (B, M2), f_hat (N, M2)")
    n, m2 = f_hat.shape
    b = ax.shape[0]
    if tuple(ax.shape) != (b, n) or tuple(ayz.shape) != (b, m2):
        raise ValueError(
            f"alpha_multiply: shapes ax {tuple(ax.shape)}, ayz {tuple(ayz.shape)}"
            f" do not fit f_hat {tuple(f_hat.shape)}")
    if b > 65535:
        raise ValueError(f"alpha_multiply: {b} nodes exceed one launch (gridDim.y <= 65535)")
    dev = f_hat.device
    for t in (ax, ayz):
        if t.device != dev or t.dtype != cd:
            raise ValueError(f"alpha_multiply: every input must be {cd} on {dev}")
    ins = [t.contiguous() for t in (ax, ayz, f_hat)]
    a1f = torch.empty((b, n, m2), dtype=cd, device=dev)
    a2f = torch.empty_like(a1f)
    lib = load_library()
    entry = lib.bfft_alpha_multiply_f64 if cd == torch.complex128 else lib.bfft_alpha_multiply_f32
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = entry(*[t.data_ptr() for t in ins], a1f.data_ptr(), a2f.data_ptr(),
                   b, n, m2, stream)
    if rc != 0:
        raise RuntimeError(f"alpha_multiply: CUDA kernel failed with cudaError {rc}")
    LAUNCHES += 1
    return a1f, a2f
