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
(``zh_block``, default the plan's rule, :func:`plan`); z is a passenger of
both stages, so every block size gives the same bits.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from .. import oz as _oz
from ..ds import CDS, DS
from .oz_contract import SMEM_MAX, contract_plain

#: Launches of the CUDA kernel (one per :func:`gmain12_nodemat` call on CUDA).
LAUNCHES = 0
#: Calls of the plain PyTorch version.
REFERENCE_CALLS = 0


#: The z-block rule's grid: two blocks for each of the H100's 132 SMs
#: (``csrc/oz_gmain12.cu`` ``kMinCtas``).
MIN_CTAS = 264


class Plan(NamedTuple):
    """K10's launch plan (``csrc/oz_gmain12.cu`` ``make_plan``): the z block,
    per stage the column group ``lg`` and row tile ``tr``, the block's shared
    memory in bytes, and whether that fits."""

    zb: int
    lg: tuple
    tr: tuple
    smem: int
    fits: bool


def _stage_bytes(k: int, lg: int, sx: int, tr: int, nsl: int) -> int:
    kp = -(-k // 16) * 16
    lp = -(-lg // 16) * 16
    return 2 * (2 * nsl * kp * (lp + 8) + 2 * sx * tr * (kp + 8)) + 4 * tr


def _plan_for(nx: int, ny: int, zb: int, sx: int, nsl: int) -> Plan:
    inter = 16 * nx * ny * zb
    lgs, trs, most = [], [], 0
    for k, rows in ((ny, nx * zb), (nx, ny * zb)):
        lg = k
        while lg > 8 and inter + _stage_bytes(k, lg, sx, 16, nsl) > SMEM_MAX:
            lg = ((lg + 1) // 2 + 7) & ~7
        tr = -(-rows // 16) * 16
        while tr > 16 and inter + _stage_bytes(k, lg, sx, tr, nsl) > SMEM_MAX:
            tr = (tr // 2 + 15) & ~15
        lgs.append(lg)
        trs.append(tr)
        most = max(most, _stage_bytes(k, lg, sx, tr, nsl))
    smem = inter + most
    return Plan(zb, tuple(lgs), tuple(trs), smem, smem <= SMEM_MAX)


@functools.lru_cache(maxsize=None)
def plan(nx: int, ny: int, nzh: int, n_nodes: int, sx: int = _oz.DEFAULT_SLICES_X,
         nsl: int = 7, zh_block: Optional[int] = None) -> Plan:
    """K10's plan, the mirror of ``csrc/oz_gmain12.cu`` ``make_plan``.  Per
    stage, column groups of ``lg`` columns (all unless the slices do not fit
    beside the intermediate; halved in multiples of 8) and row tiles of
    ``tr`` rows (all the stage's rows rounded up to 16, halved while they do
    not fit).  ``zh_block`` None: the largest divisor of ``nzh`` whose block
    fits and which leaves at least :data:`MIN_CTAS` blocks (``n_nodes * nzh
    / zb``), else the smallest that fits (``zb`` 0 when none does).
    ``sx``, ``nsl``: the chunk planes and slices the kernel keeps in shared
    memory (7 and 7; 7 and 8 at ``cmax = 7``)."""
    if zh_block is not None:
        return _plan_for(nx, ny, int(zh_block), sx, nsl)
    best = Plan(0, (0, 0), (0, 0), 0, False)
    for d in range(1, nzh + 1):
        if nzh % d:
            continue
        p = _plan_for(nx, ny, d, sx, nsl)
        if p.fits and (best.zb == 0 or n_nodes * (nzh // d) >= MIN_CTAS):
            best = p
    return best


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
    ``Nz/2``; None takes :func:`plan`'s rule."""
    nx, ny, nz = grid_shape
    nzh = nz // 2
    if zh_block is not None and (int(zh_block) < 1 or nzh % int(zh_block)):
        raise ValueError(f"zh_block {zh_block} must divide Nz/2 = {nzh}")
    for mm, k in ((m_y, ny), (m_x, nx)):
        if not _oz.merge_ok(k, sm=mm.re.shape[-3], cmax=cmax, w=w):
            raise ValueError("gmain12 needs merge_ok on both fused stages")
    dev = x_pre.full.device
    if any(t.device != dev for mm in (m_y, m_x) for t in mm):
        raise ValueError("gmain12_nodemat: operands on more than one device")
    args = (x_pre, m_y, m_x, tuple(grid_shape), cmax, w, fold_tail)
    if dev.type == "cuda":
        return _gmain12_cuda(*args, zh_block)
    if dev.type == "cpu":  # the plain version gives the same bits for every block
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


@functools.lru_cache(maxsize=None)
def _launch_args(c, sm, nx, ny, nzh, cmax, zh_block, pre_shape, my_shape, mx_shape):
    """The checks of one shape, made once: the z block the kernel is given
    (the plan's), or a ValueError to raise."""
    nlev = cmax + 1
    sx = min(_oz.DEFAULT_SLICES_X, nlev)
    if nlev > 8 or sm > 8:
        return ValueError(f"gmain12 kernel: cmax <= 7 and sm <= 8 (got cmax={cmax}, sm={sm})")
    for got, shape in ((my_shape, (c, sm, ny, ny)), (mx_shape, (c, sm, nx, nx))):
        if got != (shape, shape):
            return ValueError(f"gmain12: matrix slices {got[0]}, expected {shape}")
    if pre_shape != (nx * nzh, sx * 2 * ny):
        return ValueError(f"gmain12: x_pre {pre_shape}, expected {(nx * nzh, sx * 2 * ny)}")
    # the kernel keeps 7 chunk planes and 7 slices (8 at cmax = 7) in shared memory
    p = plan(nx, ny, nzh, c, _oz.DEFAULT_SLICES_X, 7 if nlev <= 7 else 8, zh_block)
    if not p.fits:
        return ValueError(f"gmain12: no z block of {zh_block or 'the rule'} fits in shared memory"
                          f" ({p.smem} bytes)")
    return nlev, sx, p.zb


def _gmain12_cuda(x_pre, m_y, m_x, grid_shape, cmax, w, fold_tail, zh_block) -> CDS:
    global LAUNCHES
    from .._build import load_library, on_device

    nx, ny, nz = grid_shape
    nzh = nz // 2
    c, sm = m_y.re.shape[0], m_y.re.shape[-3]
    pre = x_pre.full
    mats = (m_y.re, m_y.im, m_x.re, m_x.im)
    got = _launch_args(c, sm, nx, ny, nzh, cmax, zh_block, tuple(pre.shape),
                       (tuple(m_y.re.shape), tuple(m_y.im.shape)),
                       (tuple(m_x.re.shape), tuple(m_x.im.shape)))
    if isinstance(got, ValueError):
        raise got
    nlev, sx, zb = got
    if not pre.is_contiguous():
        pre = pre.contiguous()
    mats = [t if t.is_contiguous() else t.contiguous() for t in mats]
    out = torch.empty((4, c, nx, ny, nzh), dtype=torch.float32, device=pre.device).unbind(0)
    lib = load_library()
    dev = pre.device
    with on_device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.bfft_oz_gmain12(pre.data_ptr(), *[t.data_ptr() for t in mats],
                                 *[t.data_ptr() for t in out], c, nx, ny, nzh, zb, sm, nlev,
                                 sx, w, -1 if fold_tail is None else int(fold_tail), stream)
    if rc != 0:
        raise RuntimeError(f"gmain12_nodemat: CUDA kernel failed with cudaError {rc}")
    LAUNCHES += 1
    return CDS(DS(out[0], out[1]), DS(out[2], out[3]))
