"""K9: the half-spectrum main block of the ds engine (per node: the y, x and
half-z contractions) in one hand-written CUDA kernel, and its plain PyTorch
version.

Counterpart of ``boltzfft/oz.py``'s ``gmain3_nodemat`` -> ``_gmain3_kernel``.
:func:`gmain3_nodemat` dispatches on the device of ``x_pre``: a CUDA tensor
runs the kernel of ``csrc/oz_gmain3.cu`` (or raises), a CPU tensor runs
:func:`gmain3_reference`.  Any other device raises.

Per node ``c`` of ``C``: stage 1 contracts the shared masked half-z spectrum
(merged preslice, rows ``(Nx, Nz/2)``, ``K = Ny``) with ``m_y[c]``; stage 2
the result, rows ``(Ny, Nz/2)``, ``K = Nx``, with ``m_x[c]``; stage 3 rows
``(Nx, Ny)``, ``K = Nz/2``, with the half-z matrix ``m_zh[c]``, real output.
Every stage is K8's merged contraction (``merge_ok`` must hold on all three),
so the result is bitwise equal to the staged K8 chain
(``ds_operator._g_main_half`` with ``fused=False``) and to
:func:`gmain3_reference`, which is that chain on the plain version.
``fused="12"`` is K10 (``kernels.oz_gmain12``).

The kernel runs each node on a thread-block cluster of :data:`CLUSTER` CTAs
that split every stage's row tiles by a fixed rule
(:func:`cluster_partition`, the mirror of ``csrc/oz_gmain3.cu``'s), with a
cluster barrier between the stages.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import oz as _oz
from ..ds import DS
from .oz_contract import contract_plain, plan

#: Launches of the CUDA kernel (one per :func:`gmain3_nodemat` call on CUDA).
LAUNCHES = 0
#: Calls of the plain PyTorch version.
REFERENCE_CALLS = 0


#: CTAs of a node's thread-block cluster (``csrc/oz_gmain3.cu`` ``kCluster``).
CLUSTER = 8


def cluster_partition(grid_shape, cmax: int = 6, sm: int = _oz.DEFAULT_SLICES_M):
    """K9's static row partition as ``csrc/oz_gmain3.cu`` states it: each of
    the three stages ``(K, L, rows)`` = ``(Ny, Ny, Nx*Nz/2)``, ``(Nx, Nx,
    Ny*Nz/2)``, ``(Nz/2, Nz, Nx*Ny)`` is cut into tiles of the rows
    :func:`oz_contract.plan` gives it, and CTA ``rank`` of a node's cluster
    takes tiles ``rank, rank + CLUSTER, ...`` (of every column group).
    Returns, per stage and per rank, the ``(row0, nrows)`` of its tiles."""
    nx, ny, nz = grid_shape
    nzh = nz // 2
    sx = min(_oz.DEFAULT_SLICES_X, cmax + 1)
    nsl = min(sm, cmax + 1)
    out = []
    for k, ell, rows in ((ny, ny, nx * nzh), (nx, nx, ny * nzh), (nzh, nz, nx * ny)):
        tr = plan(k, ell, sx, nsl, rows)[1]
        n_tiles = -(-rows // tr)
        out.append([[(t * tr, min(tr, rows - t * tr)) for t in range(rank, n_tiles, CLUSTER)]
                    for rank in range(CLUSTER)])
    return out


def _check(m_y, m_x, m_zh, grid_shape, cmax, w):
    nx, ny, nz = grid_shape
    for mm, k in ((m_y, ny), (m_x, nx), (m_zh, nz // 2)):
        if not _oz.merge_ok(k, sm=mm.re.shape[-3], cmax=cmax, w=w):
            raise ValueError("gmain3 needs merge_ok on every stage")


def gmain3_nodemat(
    x_pre: _oz.PreslicedM,
    m_y: _oz.CSlicedMatrix,
    m_x: _oz.CSlicedMatrix,
    m_zh: _oz.CSlicedMatrix,
    grid_shape,
    cmax: int = _oz.DEFAULT_CMAX,
    w: int = _oz.DEFAULT_W,
    fold_tail: Optional[int] = None,
) -> DS:
    """The real main block ``(C, Nx, Ny, Nz)`` of every node.  ``x_pre`` is the
    merged preslice of the ``(Nx, Nz/2, Ny)`` spectrum; ``m_y``, ``m_x`` are
    ``(C, sm, N, N)``, ``m_zh`` ``(C, sm, Nz/2, Nz)``."""
    _check(m_y, m_x, m_zh, grid_shape, cmax, w)
    dev = x_pre.full.device
    if any(t.device != dev for mm in (m_y, m_x, m_zh) for t in mm):
        raise ValueError("gmain3_nodemat: operands on more than one device")
    args = (x_pre, m_y, m_x, m_zh, tuple(grid_shape), cmax, w, fold_tail)
    if dev.type == "cuda":
        return _gmain3_cuda(*args)
    if dev.type == "cpu":
        return gmain3_reference(*args)
    raise ValueError(f"gmain3_nodemat: no kernel for device {dev}")


def gmain3_reference(x_pre, m_y, m_x, m_zh, grid_shape, cmax=_oz.DEFAULT_CMAX,
                     w=_oz.DEFAULT_W, fold_tail=None) -> DS:
    """Plain PyTorch version: the staged chain of K8's plain merged
    contractions with the transposes between the stages."""
    global REFERENCE_CALLS
    REFERENCE_CALLS += 1
    nx, ny, nz = grid_shape
    nzh = nz // 2
    c = m_y.re.shape[0]
    kw = dict(cmax=cmax, w=w, merged=True, fold_tail=fold_tail, n_nodes=c)
    t = contract_plain([None] * 4, x_pre, m_y, real_out=False, rows_pn=nx * nzh,
                       x_per_node=False, **kw)
    # (C, Nx, Nzh, Ny) -> (C, Ny, Nzh, Nx): rows (Ny, Nzh), K = Nx
    t = [a.reshape(c, nx, nzh, ny).permute(0, 3, 2, 1).reshape(-1, nx) for a in t]
    t = contract_plain(t, None, m_x, real_out=False, rows_pn=ny * nzh, x_per_node=True, **kw)
    # (C, Ny, Nzh, Nx) -> (C, Nx, Ny, Nzh): rows (Nx, Ny), K = Nzh
    t = [a.reshape(c, ny, nzh, nx).permute(0, 3, 1, 2).reshape(-1, nzh) for a in t]
    reh, rel, _, _ = contract_plain(t, None, m_zh, real_out=True, rows_pn=nx * ny,
                                    x_per_node=True, **kw)
    return DS(reh.reshape(c, nx, ny, nz), rel.reshape(c, nx, ny, nz))


def _gmain3_cuda(x_pre, m_y, m_x, m_zh, grid_shape, cmax, w, fold_tail) -> DS:
    global LAUNCHES
    from .._build import load_library

    nx, ny, nz = grid_shape
    nzh = nz // 2
    c, sm = m_y.re.shape[0], m_y.re.shape[-3]
    nlev = cmax + 1
    sx = min(_oz.DEFAULT_SLICES_X, nlev)
    if nlev > 8 or sm > 8:
        raise ValueError(f"gmain3 kernel: cmax <= 7 and sm <= 8 (got cmax={cmax}, sm={sm})")
    for mm, shape in ((m_y, (c, sm, ny, ny)), (m_x, (c, sm, nx, nx)), (m_zh, (c, sm, nzh, nz))):
        if tuple(mm.re.shape) != shape or tuple(mm.im.shape) != shape:
            raise ValueError(f"gmain3: matrix slices {tuple(mm.re.shape)}, expected {shape}")
    pre = x_pre.full.contiguous()
    if tuple(pre.shape) != (nx * nzh, sx * 2 * ny):
        raise ValueError(f"gmain3: x_pre {tuple(pre.shape)}, expected {(nx * nzh, sx * 2 * ny)}")
    dev = pre.device
    mats = [t.contiguous() for mm in (m_y, m_x, m_zh) for t in (mm.re, mm.im)]
    # two complex ds intermediates per node (4 planes each), kept in the L2
    scratch = torch.empty((c, 8, nx * ny * nzh), dtype=torch.float32, device=dev)
    out = [torch.empty((c, nx, ny, nz), dtype=torch.float32, device=dev) for _ in range(2)]
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.bfft_oz_gmain3(pre.data_ptr(), *[t.data_ptr() for t in mats],
                                scratch.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
                                c, nx, ny, nz, sm, nlev, sx, w,
                                -1 if fold_tail is None else int(fold_tail), stream)
    if rc != 0:
        raise RuntimeError(f"gmain3_nodemat: CUDA kernel failed with cudaError {rc}")
    LAUNCHES += 1
    return DS(*out)
