"""K5: the weighted node reduction of the rfft + ``use_pallas`` route in one
hand-written CUDA kernel, and its plain PyTorch version.

Counterpart of ``boltzfft/pallas_kernels.py``'s ``gain_reduce`` ->
``_gain_reduce_kernel``.  :func:`gain_reduce` dispatches on the device of
``h``: a CUDA tensor runs the kernel of ``csrc/gain_reduce.cu`` (or raises),
a CPU tensor runs :func:`gain_reduce_reference`.  Any other device raises.

Both compute ``out[l] = sum_b gain_w[b] * beta1(rho[b], |l|) * h[b, l]`` with
``beta1 = 4 pi b_gamma sin(a) / a``, ``a = pi rho |l| / (2L) + eps``, as
``(amp * gain_w) * sin(a) / a``, in the JAX kernel's order: the nodes in
blocks of ``nb = gcd(node_block, B)``, each block summed from zero in node
order, the block sums added into the output from zero in block order.  So
``node_block`` enters the result by rounding, as it does in JAX.  The kernel
takes one of two routes that give the same bits: one launch, or a grid over
node blocks through a scratch of block sums and a second launch that adds
them.  :func:`plan` mirrors the ``.cu``'s ``gr_plan`` (the blocks and tiles)
and picks the route from the card's SM count.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

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
    """Plain PyTorch version: the weights of all nodes at once, each node
    block of ``gcd(node_block, B)`` summed from zero in node order, the block
    sums added from zero in block order (the JAX kernel's order)."""
    global REFERENCE_CALLS
    REFERENCE_CALLS += 1
    rd = torch.float64 if h.dtype == torch.complex128 else torch.float32
    w = node_weights(rho, gain_w, norm_l, length=length, b_gamma=b_gamma, dtype=rd)
    nb = math.gcd(node_block, h.shape[0])
    out = torch.zeros_like(h[0])
    for b0 in range(0, h.shape[0], nb):
        acc = torch.zeros_like(h[0])
        for b in range(b0, b0 + nb):
            acc = acc + w[b] * h[b]
        out = out + acc
    return out


#: The kernel's threads a block and modes a thread (``csrc/gain_reduce.cu``).
THREADS, MODES = 128, 2
#: The most node blocks the split route takes (the grid's y limit).
MAX_SPLIT_BLOCKS = 65535


class Plan(NamedTuple):
    """The kernel's launch: ``nb`` nodes a block, ``blocks`` node blocks,
    ``tiles`` tiles of ``THREADS * MODES`` modes (``gr_plan``), and
    ``split``: 1 where the tiles alone leave some of the ``n_sm`` SMs idle
    and there are 2 to ``MAX_SPLIT_BLOCKS`` node blocks: a grid of tiles x
    node blocks through the scratch."""

    nb: int
    blocks: int
    tiles: int
    split: int


@functools.lru_cache(maxsize=None)
def plan(b: int, m: int, node_block: int, n_sm: int) -> Plan:
    """The launch for B nodes and M modes on a card of ``n_sm`` SMs; its
    first three fields mirror ``gr_plan`` in ``csrc/gain_reduce.cu``."""
    nb = math.gcd(node_block, b)
    tiles = -(-m // (THREADS * MODES))
    return Plan(nb, b // nb, tiles, int(tiles < n_sm and 1 < b // nb <= MAX_SPLIT_BLOCKS))


def _gain_reduce_cuda(h, rho, gain_w, norm_l, *, length: float, b_gamma: float,
                      node_block: int, split: Optional[int] = None) -> torch.Tensor:
    """The kernel; ``split`` (0 or 1) replaces the plan's route (the tests
    take both).  Any B and M take the one-launch route; the split route
    takes at most ``MAX_SPLIT_BLOCKS`` node blocks, and raises above."""
    global LAUNCHES
    from .._build import load_library, on_device, sm_count

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
    p = plan(b, m, node_block, sm_count(dev))
    split = p.split if split is None else split
    if split not in (0, 1) or split and p.blocks > MAX_SPLIT_BLOCKS:
        raise ValueError(f"gain_reduce: split={split} with {p.blocks} node blocks")
    out = torch.empty((m,), dtype=cd, device=dev)
    scratch = torch.empty((p.blocks, m), dtype=cd, device=dev) if split else None
    lib = load_library()
    entry = lib.bfft_gain_reduce_f64 if rd == torch.float64 else lib.bfft_gain_reduce_f32
    with on_device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = entry(*[t.data_ptr() for t in ins], out.data_ptr(),
                   None if scratch is None else scratch.data_ptr(), b, m, node_block, split,
                   math.pi / (2.0 * length), 4.0 * math.pi * b_gamma,
                   float(torch.finfo(rd).eps), stream)
    if rc != 0:
        raise RuntimeError(f"gain_reduce: CUDA kernel failed with cudaError {rc}")
    LAUNCHES += 1
    return out
