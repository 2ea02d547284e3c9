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


def _layout(shape, st1, st2):
    """How the kernel walks streams of these shapes and strides: the extents
    of the three per-node axes in the first stream's memory order (axes of
    extent 1 outermost), both streams' element strides along them (node
    first) and the strides of the contiguous output along them; or None
    where the planes must first be copied into order (more than three
    per-node axes, or planes of one stream laid out differently)."""
    if len(shape) > 4 or len(set(st1)) > 1 or len(set(st2)) > 1:
        return None
    c, d = shape[0], tuple(shape[1:])
    lift = lambda s: (s[0],) + (0,) * (4 - len(shape)) + tuple(s[1:])
    s1, s2 = lift(st1[0]), lift(st2[0])
    d = (1,) * (3 - len(d)) + d
    perm = sorted(range(3), key=lambda a: (d[a] > 1, -s1[a + 1], a))
    dims = tuple(d[a] for a in perm)
    so = tuple((d[1] * d[2], d[2], 1)[a] for a in perm)
    s1, s2 = ((s[0],) + tuple(s[a + 1] for a in perm) for s in (s1, s2))
    if math.prod(dims) >= 2**31 or max(s1 + s2) >= 2**31 or min(s1 + s2) < 0 or c < 1:
        raise ValueError(f"hadamard_wsum: {dims} per node, strides {s1} {s2}; the kernel"
                         " takes < 2^31")
    return dims, s1, s2, so


_LAYOUTS = {}


def _hadamard_cuda(g1, g2, w) -> CDS:
    global LAUNCHES
    from .._build import load_library, on_device

    f32 = torch.float32
    p1 = (g1.re.hi, g1.re.lo, g1.im.hi, g1.im.lo)
    p2 = (g2.re.hi, g2.re.lo, g2.im.hi, g2.im.lo)
    if any(t.dtype != f32 for t in p1 + p2):
        p1, p2 = tuple(t.to(f32) for t in p1), tuple(t.to(f32) for t in p2)
    shape = p1[0].shape
    if any(t.shape != shape for t in p1 + p2):
        raise ValueError(f"hadamard_wsum: stream planes {[tuple(t.shape) for t in p1 + p2]},"
                         f" expected {tuple(shape)}")
    c = shape[0]
    key = (tuple(shape), tuple(t.stride() for t in p1), tuple(t.stride() for t in p2))
    lay = _LAYOUTS.get(key)
    if lay is None:
        # The kernel reads each stream in place through one set of strides
        # (the full routes hand over the x stage's rolled views); planes that
        # differ in layout, or more than three per-node axes, are copied
        # into order first.
        lay = _layout(*key)
        _LAYOUTS[key] = lay if lay is not None else False
    if not lay:
        p1, p2 = (tuple(t.contiguous().reshape(c, -1) for t in p) for p in (p1, p2))
        lay = _layout(tuple(p1[0].shape), (p1[0].stride(),), (p2[0].stride(),))
    dims, s1, s2, so = lay
    ws, sw = (None, None), 0
    if w is not None:
        ws = (w.hi, w.lo)
        if any(t.dtype != f32 or t.dim() != 1 for t in ws) or w.hi.stride() != w.lo.stride():
            ws = tuple(t.to(f32).reshape(-1).contiguous() for t in ws)
        if any(t.shape[0] != c for t in ws):
            raise ValueError(f"hadamard_wsum: weights {tuple(w.hi.shape)}, expected {(c,)}")
        sw = ws[0].stride(0)
    dev = p1[0].device
    out = torch.empty((4,) + tuple(shape[1:]), dtype=f32, device=dev).unbind(0)
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = load_library()
    with on_device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.bfft_oz_hadamard(*[t.data_ptr() for t in p1 + p2], *[ptr(t) for t in ws],
                                  *[t.data_ptr() for t in out], c, *dims, *s1, *s2, *so, sw,
                                  stream)
    if rc != 0:
        raise RuntimeError(f"hadamard_wsum: CUDA kernel failed with cudaError {rc}")
    LAUNCHES += 1
    return CDS(DS(out[0], out[1]), DS(out[2], out[3]))
