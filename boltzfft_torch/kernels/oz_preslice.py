"""K7: a ds complex operand's bf16 mantissa chunks, cut once per eval, in one
hand-written CUDA kernel, and its plain PyTorch version.

Counterpart of ``boltzfft/oz.py``'s ``preslice_rows`` -> ``_preslice_kernel``
/ ``_preslice_kernel_merged``.  :func:`preslice_rows` dispatches on the device
of ``x``: a CUDA tensor runs the kernel of ``csrc/oz_preslice.cu`` (or
raises), a CPU tensor runs :func:`preslice_rows_reference`.  Any other device
raises.

Rows are the flattened leading axes of ``x`` (last axis ``K``).  Each row
gets the power-of-two scale of :func:`boltzfft_torch.oz.row_sigma` (per
component, or shared by both in the merged layout) and
``sx = min(7, cmax + 1)`` chunks from :func:`boltzfft_torch.oz.chunk_rows`.
Layouts: unmerged ``PreslicedCDS(all_re, all_im)``, each ``(rows, sx*K)``
with chunk ``i`` at columns ``[i*K, (i+1)*K)``; merged ``PreslicedM(full)``,
``(rows, sx*2K)`` with block ``i`` = ``[re_i | im_i]``.  Kernel and plain
version give the same bits.
"""

from __future__ import annotations

import torch

from .. import oz as _oz
from ..ds import CDS

#: Launches of the CUDA kernel (one per :func:`preslice_rows` call on CUDA).
LAUNCHES = 0
#: Calls of the plain PyTorch version.
REFERENCE_CALLS = 0


def _sx(cmax: int) -> int:
    return min(_oz.DEFAULT_SLICES_X, cmax + 1)


def _flat(x: CDS):
    k = x.re.hi.shape[-1]
    return [a.reshape(-1, k).to(torch.float32) for a in (x.re.hi, x.re.lo, x.im.hi, x.im.lo)]


def preslice_rows(x: CDS, cmax: int = _oz.DEFAULT_CMAX, w: int = _oz.DEFAULT_W,
                  merged: bool = False):
    """The bf16 chunk operands of ``x`` (see the module docstring)."""
    dev = x.re.hi.device
    if dev.type == "cuda":
        return _preslice_cuda(x, cmax, w, merged)
    if dev.type == "cpu":
        return preslice_rows_reference(x, cmax, w, merged)
    raise ValueError(f"preslice_rows: no kernel for device {dev}")


def preslice_rows_reference(x: CDS, cmax: int = _oz.DEFAULT_CMAX, w: int = _oz.DEFAULT_W,
                            merged: bool = False):
    """Plain PyTorch version (float32 EFTs, one op at a time)."""
    global REFERENCE_CALLS
    REFERENCE_CALLS += 1
    rh, rl, ih, il = _flat(x)
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


def _preslice_cuda(x: CDS, cmax: int, w: int, merged: bool):
    global LAUNCHES
    from .._build import load_library

    planes = [a.contiguous() for a in _flat(x)]
    rows, k = planes[0].shape
    sx = _sx(cmax)
    dev = planes[0].device
    if merged:
        outs = [torch.empty((rows, sx * 2 * k), dtype=torch.bfloat16, device=dev)]
        ptrs = (outs[0].data_ptr(), None)
    else:
        outs = [torch.empty((rows, sx * k), dtype=torch.bfloat16, device=dev) for _ in range(2)]
        ptrs = (outs[0].data_ptr(), outs[1].data_ptr())
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.bfft_oz_preslice(*[p.data_ptr() for p in planes], *ptrs,
                                  rows, k, sx, w, int(merged), stream)
    if rc != 0:
        raise RuntimeError(f"preslice_rows: CUDA kernel failed with cudaError {rc}")
    LAUNCHES += 1
    return _oz.PreslicedM(outs[0]) if merged else _oz.PreslicedCDS(*outs)
