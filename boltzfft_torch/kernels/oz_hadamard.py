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
Where a running sum ``acc`` is given, ``ds.add(acc, .)`` ends the call:
``collide_ds`` sums its sub-batches so, in the kernel's launch.

The CUDA wrapper hands the kernel one table of the operands' pointers: it
stacks nothing and copies only an operand that is not contiguous float32
(``COPIES``; the ds eval lays its planes out in order once per eval);
:func:`plan` (cached) sets the launch.
"""

from __future__ import annotations

import ctypes
import functools
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
    acc: Optional[DS] = None,
) -> DS:
    """``Re sum_j w[j] g1[j] g2[j]`` per group of ``C // groups`` nodes:
    ``(Nx, Ny, Nz)`` for one group, ``(groups, Nx, Ny, Nz)`` otherwise.
    ``signs`` are the per-axis ``(-1)^n`` float32 vectors.  ``acc``, a
    running sum of the output's shape, is added last (``ds.add(acc, .)``):
    the caller's sum over sub-batches in the same launch; the JAX function
    has no such argument.  The JAX signature's ``assemble_fn`` (its staged
    twin's assembler) and ``kernel`` have no counterpart: the plain version
    assembles with :func:`assemble_g_half`, and the device decides."""
    c = r1.hi.shape[0]
    if groups < 1 or c % groups:
        raise ValueError(f"groups={groups} must divide the node count {c}")
    ops = _table(r1, c1, r2, c2, w, signs, acc)
    dev = r1.hi.device
    if any(t is not None and t.device != dev for t in ops):
        raise ValueError("hadamard_wsum_half: operands on more than one device")
    if dev.type == "cuda":
        return _hwh_cuda(ops, c, tuple(grid_shape), groups)
    if dev.type == "cpu":
        return hadamard_wsum_half_reference(r1, c1, r2, c2, w, tuple(grid_shape), signs, groups,
                                            acc)
    raise ValueError(f"hadamard_wsum_half: no kernel for device {dev}")


def hadamard_wsum_half_reference(r1, c1, r2, c2, w, grid_shape, signs, groups=1,
                                 acc=None) -> DS:
    """Plain PyTorch version: assemble both streams, then the ds products and
    the in-order group sums, elementwise, then ``ds.add(acc, .)``."""
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
    out = outs[0] if groups == 1 else DS(torch.stack([o.hi for o in outs]),
                                         torch.stack([o.lo for o in outs]))
    return out if acc is None else ds.add(acc, out)


#: Slots of the kernel's pointer table (``HPtrs`` of ``csrc/oz_hadamard_half.cu``,
#: whose ``Slot`` enum has the same numbers): the main blocks (stream 1 hi,
#: lo, stream 2 hi, lo), each stream's x, y, z planes (re hi, re lo, im hi,
#: im lo), the x, y, z sign vectors, the weights (hi, lo), the running sum
#: (hi, lo), the output (hi, lo).
SLOT_PLANES = 4
SLOT_SIGNS = SLOT_PLANES + 2 * 3 * 4
SLOT_W = SLOT_SIGNS + 3
SLOT_ACC = SLOT_W + 2
SLOT_OUT = SLOT_ACC + 2
N_SLOTS = SLOT_OUT + 2


def _table(r1, c1, r2, c2, w, signs, acc) -> list:
    """The operands in the kernel's pointer-table order (the ``SLOT_*``s, up
    to the output); None where absent."""
    planes = [t for cs in (c1, c2) for p in cs for t in (p.re.hi, p.re.lo, p.im.hi, p.im.lo)]
    return [r1.hi, r1.lo, r2.hi, r2.lo, *planes, *signs,
            *((None, None) if w is None else (w.hi, w.lo)),
            *((None, None) if acc is None else (acc.hi, acc.lo))]


#: The grid the plan aims at: this many blocks for each of the card's SMs.
BLOCKS_PER_SM = 2


@functools.lru_cache(maxsize=None)
def plan(nx: int, ny: int, nz: int, groups: int, n_sm: int) -> tuple:
    """``(run, threads)`` of the kernel's launch on a card of ``n_sm`` SMs:
    the z elements a thread walks (4, 2 or 1) and the block size.  The
    longest run, then the largest block, whose grid (``ceil(Nx Ny ceil(Nz /
    run) / threads)`` blocks per group) still has ``BLOCKS_PER_SM * n_sm``
    blocks; 1 and 64 where none has."""
    for run in (4, 2, 1):
        per_group = nx * ny * -(-nz // run)
        for threads in (256, 128, 64):
            if -(-per_group // threads) * groups >= BLOCKS_PER_SM * n_sm:
                return run, threads
    return 1, 64


@functools.lru_cache(maxsize=None)
def _shapes(c: int, groups: int, grid_shape: tuple) -> tuple:
    """The shape each entry of :func:`_table` must have."""
    nx, ny, nz = grid_shape
    main, out = (c, nx, ny, nz), ((groups,) if groups > 1 else ()) + (nx, ny, nz)
    planes = ((c, ny, nz),) * 4 + ((c, nx, nz),) * 4 + ((c, nx, ny),) * 4
    shapes = (main,) * 4 + planes * 2 + ((nx,), (ny,), (nz,), (c,), (c,), out, out)
    return tuple(torch.Size(s) for s in shapes)


#: Operands the CUDA wrapper had to copy (the default route hands over none).
COPIES = 0


def _operands(ops, c, grid_shape, groups) -> list:
    """The table's tensors as the kernel reads them: each checked against its
    shape (the weights may be any shape of C elements); one that is not
    contiguous float32 is copied (counted in ``COPIES``)."""
    global COPIES
    f32 = torch.float32
    out = list(ops)
    if ops[SLOT_W] is not None and ops[SLOT_W].dim() != 1:
        out[SLOT_W], out[SLOT_W + 1] = ops[SLOT_W].reshape(-1), ops[SLOT_W + 1].reshape(-1)
    for i, (t, shape) in enumerate(zip(out, _shapes(c, groups, grid_shape))):
        if t is None or (t.dtype is f32 and t.shape == shape and t.is_contiguous()):
            continue
        if t.shape != shape:
            raise ValueError(f"hadamard_wsum_half: operand {i} has shape {tuple(t.shape)},"
                             f" expected {tuple(shape)}")
        out[i] = t.to(f32).contiguous()
        COPIES += 1
    return out


def _hwh_cuda(ops, c, grid_shape, groups, run=None) -> DS:
    """The kernel; ``run``, a ``(run, threads)`` pair, replaces the plan's
    (the tests walk every run length)."""
    global LAUNCHES
    from .._build import load_library, on_device, sm_count

    ops = _operands(ops, c, grid_shape, groups)
    dev = ops[0].device
    run, threads = plan(*grid_shape, groups, sm_count(dev)) if run is None else run
    oshape = ((groups,) if groups > 1 else ()) + grid_shape
    out = torch.empty((2,) + oshape, dtype=torch.float32, device=dev)
    o = out.data_ptr()
    table = (ctypes.c_void_p * N_SLOTS)(
        *[None if t is None else t.data_ptr() for t in ops[:SLOT_OUT]], o, o + out.numel() * 2)
    lib = load_library()
    with on_device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.bfft_oz_hadamard_half(table, c, groups, *grid_shape, run, threads, stream)
    if rc != 0:
        raise RuntimeError(f"hadamard_wsum_half: CUDA kernel failed with cudaError {rc}")
    LAUNCHES += 1
    return DS(*out.unbind(0))
