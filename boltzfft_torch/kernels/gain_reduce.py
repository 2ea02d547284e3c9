"""K5: the weighted node reduction of the rfft + ``use_pallas`` route in one
hand-written CUDA kernel, and its plain PyTorch version.

Counterpart of ``boltzfft/pallas_kernels.py``'s ``gain_reduce`` ->
``_gain_reduce_kernel``.  :func:`gain_reduce` dispatches on the device of
``h``: a CUDA tensor runs the kernel of ``csrc/gain_reduce.cu`` (or raises),
a CPU tensor runs :func:`gain_reduce_reference`.  Any other device raises.

Both compute ``out[l] = sum_b gain_w[b] * beta1(rho[b], |l|) * h[b, l]`` with
``beta1 = 4 pi b_gamma sin(a) / a``, ``a = pi rho |l| / (2L) + eps``, as
``(amp * gain_w) * sin(a) / a``, nodes summed in order into one running sum.
The JAX kernel sums each block of ``node_block`` nodes from zero and adds
that to its output, so its result moves with ``node_block`` by rounding; the
port's kernel is bitwise the same for every ``node_block``, which sets only
how many (rho, gain_w) pairs a thread block stages per pass.
"""

from __future__ import annotations

import math

import torch

#: Launches of the CUDA kernel (one per :func:`gain_reduce` call on CUDA).
LAUNCHES = 0
#: Calls of the plain PyTorch version.
REFERENCE_CALLS = 0


def gain_reduce(h, rho, gain_w, norm_l, *, length: float, b_gamma: float,
                node_block: int = 8) -> torch.Tensor:
    """The reduction over the node axis of ``h`` (B, M) complex; ``rho``,
    ``gain_w`` (B,) and ``norm_l`` (M,) real.  Returns complex (M,)."""
    args = (h, rho, gain_w, norm_l)
    kw = dict(length=length, b_gamma=b_gamma, node_block=node_block)
    if h.device.type == "cuda":
        return _gain_reduce_cuda(*args, **kw)
    if h.device.type == "cpu":
        return gain_reduce_reference(*args, **kw)
    raise ValueError(f"gain_reduce: no kernel for device {h.device}")


def node_weights(rho, gain_w, norm_l, *, length: float, b_gamma: float, dtype):
    """The (B, M) weights ``gain_w[b] * beta1(rho[b], |l|)`` as the kernel
    forms them (``amp * gain_w`` first)."""
    eps = float(torch.finfo(dtype).eps)
    arg = (math.pi / (2.0 * length) * rho.to(dtype))[:, None] * norm_l.to(dtype)[None] + eps
    return (4.0 * math.pi * b_gamma * gain_w.to(dtype))[:, None] * torch.sin(arg) / arg


def gain_reduce_reference(h, rho, gain_w, norm_l, *, length: float, b_gamma: float,
                          node_block: int = 8) -> torch.Tensor:
    """Plain PyTorch version: the weights of all nodes at once, then one
    running sum over the nodes in order (``node_block`` is the kernel's
    staging size and does not enter the result)."""
    global REFERENCE_CALLS
    REFERENCE_CALLS += 1
    rd = torch.float64 if h.dtype == torch.complex128 else torch.float32
    w = node_weights(rho, gain_w, norm_l, length=length, b_gamma=b_gamma, dtype=rd)
    acc = torch.zeros_like(h[0])
    for b in range(h.shape[0]):
        acc = acc + w[b] * h[b]
    return acc


def _gain_reduce_cuda(h, rho, gain_w, norm_l, *, length: float, b_gamma: float,
                      node_block: int) -> torch.Tensor:
    global LAUNCHES
    from .._build import load_library

    cd = h.dtype
    if cd not in (torch.complex64, torch.complex128):
        raise TypeError(f"gain_reduce: complex64/complex128 only, got {cd}")
    if h.dim() != 2:
        raise ValueError(f"gain_reduce: h must be (B, M), got {tuple(h.shape)}")
    if node_block < 1:
        raise ValueError(f"gain_reduce: node_block must be >= 1, got {node_block}")
    rd = torch.float64 if cd == torch.complex128 else torch.float32
    dev = h.device
    b, m = h.shape

    def arg(t, shape):
        if tuple(t.shape) != shape or t.device != dev:
            raise ValueError(
                f"gain_reduce: expected {shape} on {dev}, got {tuple(t.shape)} on {t.device}")
        return t.to(rd).contiguous()

    ins = [h.contiguous(), arg(rho, (b,)), arg(gain_w, (b,)), arg(norm_l, (m,))]
    out = torch.empty((m,), dtype=cd, device=dev)
    lib = load_library()
    entry = lib.bfft_gain_reduce_f64 if rd == torch.float64 else lib.bfft_gain_reduce_f32
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = entry(*[t.data_ptr() for t in ins], out.data_ptr(), b, m, node_block,
                   math.pi / (2.0 * length), 4.0 * math.pi * b_gamma,
                   float(torch.finfo(rd).eps), stream)
    if rc != 0:
        raise RuntimeError(f"gain_reduce: CUDA kernel failed with cudaError {rc}")
    LAUNCHES += 1
    return out
