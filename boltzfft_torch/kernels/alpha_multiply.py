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
port passes complex tensors, the layout ``torch.fft`` reads and writes.  On
CUDA the two results are the halves of one (2, B, N, M2) buffer.
:func:`plan` (pure Python, cached) picks the kernel's launch: the vector
width, the block size and the nodes a thread walks (one, but for more than
65535 nodes).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

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


#: Threads a block (``csrc/alpha_multiply.cu`` takes at most 256).
THREADS = 256
#: The most node blocks one launch takes (the grid's y limit).
MAX_NODE_BLOCKS = 65535


class Plan(NamedTuple):
    """The kernel's launch: ``vec`` complex values a thread (2 in float
    where M2 is even and the loaded operands 16-byte aligned, else 1),
    ``threads`` a block, ``nb`` nodes a thread walks, and the grid's
    ``xblocks`` x ``node_blocks``."""

    vec: int
    threads: int
    nb: int
    xblocks: int
    node_blocks: int


@functools.lru_cache(maxsize=None)
def plan(b: int, n: int, m2: int, itemsize: int, aligned: bool) -> Plan:
    """The launch for B nodes of an (N, M2) spectrum of complex values of
    ``itemsize`` bytes: one node a thread (measured fastest at the route's
    chunks: a thread that walked 2-16 nodes wrote as many nodes' rows at
    once and lost up to 9%), more only where B passes
    :data:`MAX_NODE_BLOCKS`."""
    vec = 2 if itemsize == 8 and m2 % 2 == 0 and aligned else 1
    nb = 1
    while -(-b // nb) > MAX_NODE_BLOCKS:
        nb *= 2
    return Plan(vec, THREADS, nb, -(-(n * m2 // vec) // THREADS), -(-b // nb))


_ENTRIES: dict = {}


def _entry(cd: torch.dtype):
    """The library's entry point for complex dtype ``cd``, resolved once."""
    fn = _ENTRIES.get(cd)
    if fn is None:
        from .._build import load_library

        lib = load_library()
        fn = _ENTRIES[cd] = (lib.bfft_alpha_multiply_f64 if cd == torch.complex128
                             else lib.bfft_alpha_multiply_f32)
    return fn


def _alpha_multiply_cuda(ax, ayz, f_hat):
    global LAUNCHES
    from .._build import on_device

    cd = f_hat.dtype
    if cd not in (torch.complex64, torch.complex128):
        raise TypeError(f"alpha_multiply: complex64/complex128 only, got {cd}")
    if f_hat.dim() != 2 or ax.dim() != 2 or ayz.dim() != 2:
        raise ValueError("alpha_multiply: ax (B, N), ayz (B, M2), f_hat (N, M2)")
    n, m2 = f_hat.shape
    b = ax.shape[0]
    if ax.shape != (b, n) or ayz.shape != (b, m2):
        raise ValueError(
            f"alpha_multiply: shapes ax {tuple(ax.shape)}, ayz {tuple(ayz.shape)}"
            f" do not fit f_hat {tuple(f_hat.shape)}")
    dev = f_hat.device
    if ax.device != dev or ayz.device != dev or ax.dtype != cd or ayz.dtype != cd:
        raise ValueError(f"alpha_multiply: every input must be {cd} on {dev}")
    ax, ayz, f_hat = ax.contiguous(), ayz.contiguous(), f_hat.contiguous()
    aligned = (ayz.data_ptr() | f_hat.data_ptr()) % 16 == 0
    p = plan(b, n, m2, f_hat.element_size(), aligned)
    out = torch.empty((2, b, n, m2), dtype=cd, device=dev)
    with on_device(dev):
        rc = _entry(cd)(ax.data_ptr(), ayz.data_ptr(), f_hat.data_ptr(), out.data_ptr(),
                        b, n, m2, p.vec, p.threads, p.nb,
                        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"alpha_multiply: CUDA kernel failed with cudaError {rc}")
    LAUNCHES += 1
    return out[0], out[1]
