"""K7: a ds complex operand's bf16 mantissa chunks, cut once per eval, in one
hand-written CUDA kernel, and its plain PyTorch version.

Counterpart of ``boltzfft/oz.py``'s ``preslice_rows`` -> ``_preslice_kernel``
/ ``_preslice_kernel_merged``.  :func:`preslice_rows` dispatches on the device
of ``x``: a CUDA tensor runs the kernel of ``csrc/oz_preslice.cu`` (or
raises), a CPU tensor runs :func:`preslice_rows_reference`.  Any other device
raises.

Rows are the flattened leading axes of ``x`` (last axis ``K``), times
``mask`` where one is given (a float32 multiply, broadcast to ``x``'s
shape).  Each row gets the power-of-two scale of
:func:`boltzfft_torch.oz.row_sigma` (per component, or shared by both in the
merged layout) and ``sx = min(7, cmax + 1)`` chunks from
:func:`boltzfft_torch.oz.chunk_rows`.  Layouts: unmerged
``PreslicedCDS(all_re, all_im)``, each ``(rows, sx*K)`` with chunk ``i`` at
columns ``[i*K, (i+1)*K)``; merged ``PreslicedM(full)``, ``(rows, sx*2K)``
with block ``i`` = ``[re_i | im_i]``.  Kernel and plain version give the
same bits.

The kernel reads ``x`` in place through its strides where the four planes
share them and the leading axis of a 3-D view has unit stride, as both ds
paths' operands do; another layout is copied once (:data:`COPIES`).  :func:`preslice_half` is the
ds half path's operand, f_hat's half-z spectrum under the x/y Nyquist mask
with the last two axes swapped, as such a view: one launch for the whole
step.
"""

from __future__ import annotations

import functools

import torch

from .. import ds
from .. import oz as _oz
from ..ds import CDS

#: Launches of the CUDA kernel (one per :func:`preslice_rows` call on CUDA).
LAUNCHES = 0
#: Calls of the plain PyTorch version.
REFERENCE_CALLS = 0
#: Operands the CUDA wrapper had to copy (planes whose strides differ, not
#: float32, or whose unit-stride axis is not the rows' leading one; the ds
#: eval's operands are read in place).
COPIES = 0


def _sx(cmax: int) -> int:
    return min(_oz.DEFAULT_SLICES_X, cmax + 1)


def _planes(x: CDS) -> list:
    return [x.re.hi, x.re.lo, x.im.hi, x.im.lo]


def preslice_rows(x: CDS, cmax: int = _oz.DEFAULT_CMAX, w: int = _oz.DEFAULT_W,
                  merged: bool = False, mask=None):
    """The bf16 chunk operands of ``x`` (times ``mask``, if given; see the
    module docstring)."""
    dev = x.re.hi.device
    if dev.type == "cuda":
        return _preslice_cuda(x, cmax, w, merged, mask)
    if dev.type == "cpu":
        return preslice_rows_reference(x, cmax, w, merged, mask)
    raise ValueError(f"preslice_rows: no kernel for device {dev}")


def _half_view(f_hat: CDS, fmask: torch.Tensor):
    """f_hat ``(Nx, Ny, Nz)`` as the view ``(Nx, Nz/2, Ny)`` of its half-z
    spectrum, and the ``(Nx, Ny)`` mask as ``(Nx, 1, Ny)``."""
    nzh = f_hat.re.hi.shape[-1] // 2
    return ds._swap_last2(ds.tree_map(lambda a: a[..., :nzh], f_hat)), fmask[:, None, :]


def preslice_half(f_hat: CDS, fmask: torch.Tensor, cmax: int = _oz.DEFAULT_CMAX,
                  w: int = _oz.DEFAULT_W, merged: bool = False):
    """The ds half path's main-block operand: the chunks of
    ``swap_last2(f_hat[..., :Nz/2] * fmask[..., None])`` (rows ``(Nx,
    Nz/2)``, ``K = Ny``), with ``fmask`` the ``(Nx, Ny)`` x/y Nyquist mask.
    On CUDA one launch reads f_hat in place."""
    x, m = _half_view(f_hat, fmask)
    return preslice_rows(x, cmax, w, merged, mask=m)


def preslice_half_reference(f_hat: CDS, fmask: torch.Tensor, cmax: int = _oz.DEFAULT_CMAX,
                            w: int = _oz.DEFAULT_W, merged: bool = False):
    """Plain version of :func:`preslice_half`: the slice, the mask multiply
    and the swap as tensor operations, then :func:`preslice_rows_reference`."""
    nzh = f_hat.re.hi.shape[-1] // 2
    fhs = ds._swap_last2(ds.tree_map(lambda a: a[..., :nzh] * fmask[..., None], f_hat))
    return preslice_rows_reference(fhs, cmax, w, merged)


def preslice_rows_reference(x: CDS, cmax: int = _oz.DEFAULT_CMAX, w: int = _oz.DEFAULT_W,
                            merged: bool = False, mask=None):
    """Plain PyTorch version (float32 EFTs, one op at a time)."""
    global REFERENCE_CALLS
    REFERENCE_CALLS += 1
    k = x.re.hi.shape[-1]
    planes = [a.to(torch.float32) for a in _planes(x)]
    if mask is not None:
        planes = [a * mask for a in planes]
    rh, rl, ih, il = (a.reshape(-1, k) for a in planes)
    sx = _sx(cmax)
    if merged:
        sig = torch.maximum(_oz.row_sigma(rh), _oz.row_sigma(ih))
        cr = _oz.chunk_rows(rh, rl, sig, w, sx)
        ci = _oz.chunk_rows(ih, il, sig, w, sx)
        blocks = [t for i in range(sx) for t in (cr[i], ci[i])]
        return _oz.PreslicedM(torch.cat(blocks, dim=1).to(torch.bfloat16))
    cr = _oz.chunk_rows(rh, rl, _oz.row_sigma(rh), w, sx)
    ci = _oz.chunk_rows(ih, il, _oz.row_sigma(ih), w, sx)
    return _oz.PreslicedCDS(torch.cat(cr, dim=1).to(torch.bfloat16),
                            torch.cat(ci, dim=1).to(torch.bfloat16))


#: Shared memory a block may use without opting in (``csrc/oz_preslice.cu``).
SMEM_MAX = 48 * 1024


#: Lanes a row aims at: the sweep of ``csrc/oz_preslice.cu``'s launch at the
#: main path's shapes was fastest with 16 lanes a row and every thread of
#: the block on a row.
LANES = 16


@functools.lru_cache(maxsize=None)
def plan(a: int, b: int, k: int, n_sm: int) -> tuple:
    """``(v, g, rt, threads)`` of the kernel's launch over the ``(A, B,
    K)`` operand on a card of ``n_sm`` SMs.  ``v`` elements a lane: the
    largest of 4, 2, 1 that divides ``K`` and leaves :data:`LANES` lanes a
    row (the largest divisor where ``K`` is short); ``g``, the lanes a row,
    the power of two that covers ``K / v`` (at most 32).  Tiles of ``rt``
    rows along a: the largest power of two with ``rt * g <= 256`` whose
    grid has at least half a block for each SM and that is under twice A,
    but a warp of lanes at least (and smaller where the tile's shared
    memory would pass 48 KB); a thread for each lane of the tile's rows."""
    divs = [d for d in (4, 2, 1) if k % d == 0]
    v = next((d for d in divs if k // d >= LANES), divs[0])
    g = 1
    while g < 32 and g * v < k:
        g *= 2
    kp = k | 1
    rt_max = 32
    while rt_max > 1 and 16 * rt_max * kp > SMEM_MAX:
        rt_max //= 2
    if 16 * rt_max * kp > SMEM_MAX:
        raise ValueError(f"preslice_rows: rows of K={k} do not fit in shared memory")
    rt = min(rt_max, 256 // g)
    floor = min(rt, max(1, 32 // g))
    while rt > floor and (rt >= 2 * a or -(-a // rt) * b < n_sm // 2):
        rt //= 2
    return v, g, rt, max(32, rt * g)


def _as_3d(t: torch.Tensor) -> torch.Tensor:
    """An operand plane as ``(A, B, K)`` (a view where the strides allow)."""
    if t.dim() == 3:
        return t
    if t.dim() < 3:
        return t.reshape((1,) * (3 - t.dim()) + tuple(t.shape))
    return t.reshape(-1, t.shape[-2], t.shape[-1])


def _preslice_cuda(x: CDS, cmax: int, w: int, merged: bool, mask):
    global LAUNCHES, COPIES
    from .._build import load_library, on_device, sm_count

    planes = [_as_3d(p) for p in _planes(x)]
    a, b, k = planes[0].shape
    if (any(p.dtype != torch.float32 or p.stride() != planes[0].stride() for p in planes)
            or (a > 1 and planes[0].stride(0) != 1)):
        # a the unit-stride axis, the kernel's load order
        planes = [p.to(torch.float32).permute(2, 1, 0).contiguous().permute(2, 1, 0)
                  for p in planes]
        COPIES += 1
    dev = planes[0].device
    if mask is not None:
        if mask.dim() != x.re.hi.dim() or mask.device != dev:
            raise ValueError(f"preslice_rows: mask {tuple(mask.shape)} on {mask.device} for"
                             f" an operand {tuple(x.re.hi.shape)} on {dev}")
        mask = _as_3d(mask.to(torch.float32).expand(x.re.hi.shape))
    sx = _sx(cmax)
    strides = planes[0].stride()
    v, g, rt, threads = plan(a, b, k, sm_count(dev))
    rows = a * b
    if merged:
        outs = [torch.empty((rows, sx * 2 * k), dtype=torch.bfloat16, device=dev)]
        ptrs = (outs[0].data_ptr(), None)
    else:
        outs = [torch.empty((rows, sx * k), dtype=torch.bfloat16, device=dev) for _ in range(2)]
        ptrs = (outs[0].data_ptr(), outs[1].data_ptr())
    mstr = (0, 0, 0) if mask is None else mask.stride()
    lib = load_library()
    with on_device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.bfft_oz_preslice(*[p.data_ptr() for p in planes],
                                  None if mask is None else mask.data_ptr(), *ptrs,
                                  a, b, k, *strides, *mstr, sx, w, int(merged),
                                  v, g, rt, threads, stream)
    if rc != 0:
        raise RuntimeError(f"preslice_rows: CUDA kernel failed with cudaError {rc}")
    LAUNCHES += 1
    return _oz.PreslicedM(outs[0]) if merged else _oz.PreslicedCDS(*outs)
