"""K11: the full-stream Hadamard product and weighted node sum of the ds
engine in one hand-written CUDA kernel, and its plain PyTorch version.

Counterpart of ``boltzfft/oz.py``'s ``hadamard_wsum`` ->
``_hadamard_wsum_kernel``, the oz engine's Hadamard on its full g-streams.
:func:`hadamard_wsum` dispatches on the device of ``g1``: a CUDA tensor runs
the kernel of ``csrc/oz_hadamard.cu`` (or raises), a CPU tensor runs
:func:`hadamard_wsum_reference`.  Any other device raises.  The TPU wrapper
falls back to its staged twin where the grid does not tile 128 lanes; the
card has no such constraint, so on CUDA the kernel always runs.

The function: ``sum_j w[j] * (g1[j] * g2[j])`` over the leading node axis in
ds arithmetic, in the staged order of JAX's ``_hadamard_wsum_jnp``:
``ds.cmul``, then ``ds.cmul_ds`` by the node's weight (skipped when ``w`` is
None), then ``ds.cadd`` in node order, node 0 starting the sum.  The kernel
does the same operations per element, so the two agree bitwise.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .. import ds
from ..ds import CDS, DS

#: Launches of the CUDA kernel (one per :func:`hadamard_wsum` call on CUDA).
LAUNCHES = 0
#: Calls of the plain PyTorch version.
REFERENCE_CALLS = 0


def hadamard_wsum(g1: CDS, g2: CDS, w: Optional[DS], kernel: Optional[bool] = None) -> CDS:
    """``sum_j w[j] * (g1[j] . g2[j])``: ``g1``, ``g2`` are CDS ``(C, ...)``,
    ``w`` a DS ``(C,)`` or None; returns the CDS of shape ``g1.shape[1:]``.
    ``kernel`` is accepted for the JAX signature; the device decides."""
    dev = g1.re.hi.device
    leaves = []
    ds.tree_map(leaves.append, (g1, g2, w))
    if any(t.device != dev for t in leaves):
        raise ValueError("hadamard_wsum: operands on more than one device")
    if dev.type == "cuda":
        return _hadamard_cuda(g1, g2, w)
    if dev.type == "cpu":
        return hadamard_wsum_reference(g1, g2, w)
    raise ValueError(f"hadamard_wsum: no kernel for device {dev}")


def hadamard_wsum_reference(g1: CDS, g2: CDS, w: Optional[DS]) -> CDS:
    """Plain PyTorch version: the staged ds operations, in node order."""
    global REFERENCE_CALLS
    REFERENCE_CALLS += 1
    h = ds.cmul(g1, g2)
    s = None
    for j in range(h.re.hi.shape[0]):
        term = ds.tree_map(lambda a: a[j], h)
        if w is not None:
            term = ds.cmul_ds(term, DS(w.hi[j], w.lo[j]))
        s = term if s is None else ds.cadd(s, term)
    return s


def _hadamard_cuda(g1, g2, w) -> CDS:
    global LAUNCHES
    from .._build import load_library

    f32 = torch.float32
    shape = tuple(g1.re.hi.shape)
    c = shape[0]
    p1, p2 = ([t.to(f32) for t in (g.re.hi, g.re.lo, g.im.hi, g.im.lo)] for g in (g1, g2))
    for t in p1 + p2:
        if tuple(t.shape) != shape:
            raise ValueError(f"hadamard_wsum: stream planes {tuple(t.shape)}, expected {shape}")
    # The kernel reads each stream in place through one set of strides (the
    # full routes hand over the x stage's rolled views), its three per-node
    # axes ordered as the first stream lies in memory, and writes the output
    # through its strides.  Planes that differ in layout, or more than three
    # per-node axes, are copied into order first.
    if len(shape) > 4 or any(len({t.stride() for t in p}) > 1 for p in (p1, p2)):
        p1, p2 = ([t.contiguous().reshape(c, -1) for t in p] for p in (p1, p2))
    pad = lambda t: t.reshape((c,) + (1,) * (4 - t.dim()) + tuple(t.shape[1:]))
    p1, p2 = [pad(t) for t in p1], [pad(t) for t in p2]
    d = tuple(p1[0].shape[1:])
    perm = sorted(range(3), key=lambda a: (-p1[0].stride(a + 1), a))
    dims = tuple(d[a] for a in perm)
    so = tuple((d[1] * d[2], d[2], 1)[a] for a in perm)
    s1, s2 = ((t.stride(0),) + tuple(t.stride(a + 1) for a in perm) for t in (p1[0], p2[0]))
    if math.prod(dims) >= 2**31 or max(s1 + s2) >= 2**31:
        raise ValueError(f"hadamard_wsum: {dims} per node, strides {s1} {s2}; the kernel"
                         " takes < 2^31")
    ws = [None, None]
    if w is not None:
        ws = [t.to(f32).contiguous() for t in (w.hi, w.lo)]
        if any(tuple(t.shape) != (c,) for t in ws):
            raise ValueError(f"hadamard_wsum: weights {tuple(w.hi.shape)}, expected {(c,)}")
    dev = g1.re.hi.device
    out = [torch.empty(shape[1:], dtype=f32, device=dev) for _ in range(4)]
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.bfft_oz_hadamard(*[t.data_ptr() for t in p1 + p2], *[ptr(t) for t in ws],
                                  *[t.data_ptr() for t in out], c, *dims, *s1, *s2, *so, stream)
    if rc != 0:
        raise RuntimeError(f"hadamard_wsum: CUDA kernel failed with cudaError {rc}")
    LAUNCHES += 1
    return CDS(DS(out[0], out[1]), DS(out[2], out[3]))
