"""K12: the half-spectrum Hadamard product and group sum of the ds engine in
one hand-written CUDA kernel, and its plain PyTorch version.

Counterpart of ``boltzfft/oz.py``'s ``hadamard_wsum_half`` -> ``_hwh_kernel``.
:func:`hadamard_wsum_half` dispatches on the device of ``r1``: a CUDA tensor
runs the kernel of ``csrc/oz_hadamard_half.cu`` (or raises), a CPU tensor
runs :func:`hadamard_wsum_half_reference`.  Any other device raises.  The TPU
wrapper falls back to its staged twin where its lane tiling does not fit the
grid; the card has no such constraint, so on CUDA the kernel always runs.

Each g stream is given factored: a real main block ``r`` (C, Nx, Ny, Nz) and
three plane corrections ``(px, py, pz)`` (CDS, (C, Ny, Nz), (C, Nx, Nz),
(C, Nx, Ny)).  Per node ``j``, both streams are rebuilt as
``g = r + sx(jx) px + sy(jy) py + sz(jz) pz`` (:func:`assemble_g_half`; the
``+-1`` parity multiplies are exact), then ``Re(g1 g2) = R1 R2 - E1 E2`` in
``ds.cmul``'s order, times ``w[j]`` when a weight is given, and the nodes of
each of ``groups`` consecutive node groups are summed in order with
compensated adds (the first node starts the sum).  Only ``Re`` is returned:
the pipeline's ``Re(IFFT(beta1 FFT(.)))`` annihilates the imaginary part.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import ds
from ..ds import CDS, DS

#: Launches of the CUDA kernel (one per :func:`hadamard_wsum_half` call on CUDA).
LAUNCHES = 0
#: Calls of the plain PyTorch version.
REFERENCE_CALLS = 0


def assemble_g_half(r_main: DS, corr, signs) -> CDS:
    """Dense complex g from the real main block and the three plane
    corrections (``boltzfft.ds_operator._assemble_g_half``)."""
    px, py, pz = corr
    sx, sy, sz = signs
    al = slice(None)
    terms = (
        (px, (al, None, al, al), sx[None, :, None, None]),
        (py, (al, al, None, al), sy[None, None, :, None]),
        (pz, (al, al, al, None), sz[None, None, None, :]),
    )
    g_re, g_im = r_main, None
    for field, idx, pat in terms:
        tre = DS(field.re.hi[idx] * pat, field.re.lo[idx] * pat)
        tim = DS(field.im.hi[idx] * pat, field.im.lo[idx] * pat)
        g_re = ds.add(g_re, tre)
        g_im = tim if g_im is None else ds.add(g_im, tim)
    return CDS(g_re, g_im)


def hadamard_wsum_half(
    r1: DS, c1, r2: DS, c2, w: Optional[DS], grid_shape, signs, groups: int = 1,
) -> DS:
    """``Re sum_j w[j] g1[j] g2[j]`` per group of ``C // groups`` nodes:
    ``(Nx, Ny, Nz)`` for one group, ``(groups, Nx, Ny, Nz)`` otherwise.
    ``signs`` are the per-axis ``(-1)^n`` float32 vectors.  The JAX
    signature's ``assemble_fn`` (its staged twin's assembler) and ``kernel``
    have no counterpart: the plain version assembles with
    :func:`assemble_g_half`, and the device decides."""
    c = r1.hi.shape[0]
    if groups < 1 or c % groups:
        raise ValueError(f"groups={groups} must divide the node count {c}")
    dev = r1.hi.device
    leaves = []
    ds.tree_map(leaves.append, (r1, c1, r2, c2, w, tuple(signs)))
    if any(t.device != dev for t in leaves):
        raise ValueError("hadamard_wsum_half: operands on more than one device")
    args = (r1, c1, r2, c2, w, tuple(grid_shape), signs, groups)
    if dev.type == "cuda":
        return _hwh_cuda(*args)
    if dev.type == "cpu":
        return hadamard_wsum_half_reference(*args)
    raise ValueError(f"hadamard_wsum_half: no kernel for device {dev}")


def hadamard_wsum_half_reference(r1, c1, r2, c2, w, grid_shape, signs, groups=1) -> DS:
    """Plain PyTorch version: assemble both streams, then the ds products and
    the in-order group sums, elementwise."""
    global REFERENCE_CALLS
    REFERENCE_CALLS += 1
    g1 = assemble_g_half(r1, c1, signs)
    g2 = assemble_g_half(r2, c2, signs)
    h = ds.sub(ds.mul(g1.re, g2.re), ds.mul(g1.im, g2.im))
    c = r1.hi.shape[0]
    ns_pg = c // groups
    outs = []
    for g in range(groups):
        s = None
        for j in range(g * ns_pg, (g + 1) * ns_pg):
            term = DS(h.hi[j], h.lo[j])
            if w is not None:
                term = ds.mul(term, DS(w.hi[j], w.lo[j]))
            s = term if s is None else ds.add(s, term)
        outs.append(s)
    if groups == 1:
        return outs[0]
    return DS(torch.stack([o.hi for o in outs]), torch.stack([o.lo for o in outs]))


def _hwh_cuda(r1, c1, r2, c2, w, grid_shape, signs, groups) -> DS:
    global LAUNCHES
    from .._build import load_library

    nx, ny, nz = grid_shape
    c = r1.hi.shape[0]
    dev = r1.hi.device
    f32 = torch.float32

    def planes(idx):
        return torch.stack([t.to(f32) for cs in (c1, c2) for t in
                            (cs[idx].re.hi, cs[idx].re.lo, cs[idx].im.hi, cs[idx].im.lo)]).contiguous()

    px, py, pz = planes(0), planes(1), planes(2)
    for p, shape in ((px, (8, c, ny, nz)), (py, (8, c, nx, nz)), (pz, (8, c, nx, ny))):
        if tuple(p.shape) != shape:
            raise ValueError(f"hadamard_wsum_half: planes {tuple(p.shape)}, expected {shape}")
    rs = [t.to(f32).contiguous() for t in (r1.hi, r1.lo, r2.hi, r2.lo)]
    for t in rs:
        if tuple(t.shape) != (c, nx, ny, nz):
            raise ValueError(f"hadamard_wsum_half: main block {tuple(t.shape)}, expected {(c, nx, ny, nz)}")
    sg = [t.to(f32).contiguous() for t in signs]
    ws = [None, None] if w is None else [t.to(f32).reshape(c).contiguous() for t in (w.hi, w.lo)]
    oshape = ((groups,) if groups > 1 else ()) + (nx, ny, nz)
    out = [torch.empty(oshape, dtype=f32, device=dev) for _ in range(2)]
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.bfft_oz_hadamard_half(
            *[t.data_ptr() for t in rs], px.data_ptr(), py.data_ptr(), pz.data_ptr(),
            *[t.data_ptr() for t in sg], *[ptr(t) for t in ws],
            out[0].data_ptr(), out[1].data_ptr(), c, groups, nx, ny, nz, stream)
    if rc != 0:
        raise RuntimeError(f"hadamard_wsum_half: CUDA kernel failed with cudaError {rc}")
    LAUNCHES += 1
    return DS(*out)
