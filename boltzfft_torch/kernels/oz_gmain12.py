"""K10: the y and x main-block contractions of the ds engine's half-spectrum
streams fused per (node, z-half block) in one hand-written CUDA kernel, and
its plain PyTorch version.

Counterpart of ``boltzfft/oz.py``'s ``gmain12_nodemat`` ->
``_gmain12_kernel``.  :func:`gmain12_nodemat` dispatches on the device of
``x_pre``: a CUDA tensor runs the kernel of ``csrc/oz_gmain12.cu`` (or
raises), a CPU tensor runs :func:`gmain12_reference`.  Any other device
raises.

Per node ``c`` of ``C``: stage 1 contracts the shared masked half-z spectrum
(merged preslice, rows ``(Nx, Nz/2)``, ``K = Ny``) with ``m_y[c]``; stage 2
the result, rows ``(Ny, Nz/2)``, ``K = Nx``, with ``m_x[c]``.  Both stages
are K8's merged contraction (``merge_ok`` must hold on both), so the result,
the ``(C, Nx, Ny, Nz/2)`` CDS the staged half-z K8 call consumes, is bitwise
equal to the staged K8 chain and to :func:`gmain12_reference`, which is that
chain on the plain version.  The kernel blocks the z-half axis
(``zh_block``, default :func:`oz.default_zh_block` over the blocks that
fit in shared memory, :func:`block_fits`); z is a passenger of both stages,
so every block size gives the same bits.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import oz as _oz
from ..ds import CDS, DS
from .oz_contract import contract_plain

#: Launches of the CUDA kernel (one per :func:`gmain12_nodemat` call on CUDA).
LAUNCHES = 0
#: Calls of the plain PyTorch version.
REFERENCE_CALLS = 0


def block_fits(nx: int, ny: int, zh_block: int, sx: int, nslices: int) -> bool:
    """Whether a K10 block of ``zh_block`` z rows, keeping ``nslices`` matrix
    slices (``min(sm, cmax + 1)``) in shared memory, fits there on the card.
    The kernel's source holds the one count of its shared memory
    (``bfft_oz_gmain12_fits``), so this needs the built library."""
    from .._build import load_library

    return bool(load_library().bfft_oz_gmain12_fits(nx, ny, int(zh_block), sx, int(nslices)))


def gmain12_nodemat(
    x_pre: _oz.PreslicedM,
    m_y: _oz.CSlicedMatrix,
    m_x: _oz.CSlicedMatrix,
    grid_shape,
    cmax: int = _oz.DEFAULT_CMAX,
    w: int = _oz.DEFAULT_W,
    fold_tail: Optional[int] = None,
    zh_block: Optional[int] = None,
) -> CDS:
    """The y+x transformed main block ``(C, Nx, Ny, Nz/2)`` of every node.
    ``x_pre`` is the merged preslice of the ``(Nx, Nz/2, Ny)`` spectrum;
    ``m_y``, ``m_x`` are ``(C, sm, N, N)``.  ``zh_block`` must divide
    ``Nz/2``."""
    nx, ny, nz = grid_shape
    nzh = nz // 2
    for mm, k in ((m_y, ny), (m_x, nx)):
        if not _oz.merge_ok(k, sm=mm.re.shape[-3], cmax=cmax, w=w):
            raise ValueError("gmain12 needs merge_ok on both fused stages")
    dev = x_pre.full.device
    sx = min(_oz.DEFAULT_SLICES_X, cmax + 1)
    if zh_block is not None:
        zb = int(zh_block)
    elif dev.type == "cuda":
        nsl = min(m_y.re.shape[-3], cmax + 1)
        zb = _oz.default_zh_block(nx, nzh, ny, fits=lambda d: block_fits(nx, ny, d, sx, nsl))
    else:  # the plain version gives the same bits for every block
        zb = _oz.default_zh_block(nx, nzh, ny)
    if zb < 1 or nzh % zb:
        raise ValueError(f"zh_block {zb} must divide Nz/2 = {nzh}")
    if any(t.device != dev for mm in (m_y, m_x) for t in mm):
        raise ValueError("gmain12_nodemat: operands on more than one device")
    args = (x_pre, m_y, m_x, tuple(grid_shape), cmax, w, fold_tail)
    if dev.type == "cuda":
        return _gmain12_cuda(*args, zb)
    if dev.type == "cpu":
        return gmain12_reference(*args)
    raise ValueError(f"gmain12_nodemat: no kernel for device {dev}")


def gmain12_reference(x_pre, m_y, m_x, grid_shape, cmax=_oz.DEFAULT_CMAX, w=_oz.DEFAULT_W,
                      fold_tail=None, zh_block=None) -> CDS:
    """Plain PyTorch version: K8's plain merged y and x contractions with the
    transposes between them (``zh_block`` changes nothing and is accepted
    for the signature)."""
    global REFERENCE_CALLS
    REFERENCE_CALLS += 1
    nx, ny, nz = grid_shape
    nzh = nz // 2
    c = m_y.re.shape[0]
    kw = dict(cmax=cmax, w=w, merged=True, fold_tail=fold_tail, n_nodes=c, real_out=False)
    t = contract_plain([None] * 4, x_pre, m_y, rows_pn=nx * nzh, x_per_node=False, **kw)
    # (C, Nx, Nzh, Ny) -> (C, Ny, Nzh, Nx): rows (Ny, Nzh), K = Nx
    t = [a.reshape(c, nx, nzh, ny).permute(0, 3, 2, 1).reshape(-1, nx) for a in t]
    t = contract_plain(t, None, m_x, rows_pn=ny * nzh, x_per_node=True, **kw)
    # (C, Ny, Nzh, Nx) -> (C, Nx, Ny, Nzh)
    rh, rl, ih, il = (a.reshape(c, ny, nzh, nx).permute(0, 3, 1, 2) for a in t)
    return CDS(DS(rh, rl), DS(ih, il))


def _gmain12_cuda(x_pre, m_y, m_x, grid_shape, cmax, w, fold_tail, zb) -> CDS:
    global LAUNCHES
    from .._build import load_library

    nx, ny, nz = grid_shape
    nzh = nz // 2
    c, sm = m_y.re.shape[0], m_y.re.shape[-3]
    nlev = cmax + 1
    sx = min(_oz.DEFAULT_SLICES_X, nlev)
    if nlev > 8 or sm > 8:
        raise ValueError(f"gmain12 kernel: cmax <= 7 and sm <= 8 (got cmax={cmax}, sm={sm})")
    for mm, shape in ((m_y, (c, sm, ny, ny)), (m_x, (c, sm, nx, nx))):
        if tuple(mm.re.shape) != shape or tuple(mm.im.shape) != shape:
            raise ValueError(f"gmain12: matrix slices {tuple(mm.re.shape)}, expected {shape}")
    pre = x_pre.full.contiguous()
    if tuple(pre.shape) != (nx * nzh, sx * 2 * ny):
        raise ValueError(f"gmain12: x_pre {tuple(pre.shape)}, expected {(nx * nzh, sx * 2 * ny)}")
    if not block_fits(nx, ny, zb, sx, min(sm, nlev)):
        raise ValueError(f"gmain12: a block of zh_block {zb} does not fit in shared memory")
    dev = pre.device
    mats = [t.contiguous() for mm in (m_y, m_x) for t in (mm.re, mm.im)]
    out = [torch.empty((c, nx, ny, nzh), dtype=torch.float32, device=dev) for _ in range(4)]
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.bfft_oz_gmain12(pre.data_ptr(), *[t.data_ptr() for t in mats],
                                 *[t.data_ptr() for t in out], c, nx, ny, nzh, zb, sm, nlev,
                                 sx, w, -1 if fold_tail is None else int(fold_tail), stream)
    if rc != 0:
        raise RuntimeError(f"gmain12_nodemat: CUDA kernel failed with cudaError {rc}")
    LAUNCHES += 1
    return CDS(DS(out[0], out[1]), DS(out[2], out[3]))
