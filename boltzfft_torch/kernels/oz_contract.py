"""K8: the Ozaki-sliced ds contraction of the last axis in one hand-written
CUDA kernel, and its plain PyTorch version.

Counterpart of ``boltzfft/oz.py``'s ``_oz_contract_kernel_v3``, reached
through ``contract_last_oz_kernel`` (shared matrix: ``real_in``,
``real_out``; phased mode: ``phase``, ``conj``, ``repeat``) and
``contract_last_oz_nodemat`` (per-node matrices: ``repeat``, ``x_pre``,
``merged``, ``real_out``).  Both entry points dispatch on the device of
``x``: a CUDA tensor runs the kernel of ``csrc/oz_contract.cu`` (or raises),
a CPU tensor runs the plain version.  Any other device raises.

The function: ``out[..., l] = sum_k x[..., k] * m[k, l]`` with ``x`` a
complex ds operand cut into ``sx`` bf16 chunks per row and ``m`` given as
``sm`` bf16 slices.  Level ``d`` is the exact sum of the chunk-pair dots with
``i + j = d`` (``d <= cmax``); the levels are folded into a ds result with
compensated adds in the TPU kernel's order: for each component pair in turn
(``re*re``, ``-im*im`` into the real output, ``re*im``, ``im*re`` into the
imaginary one) its levels from the largest scale down; merged mode forms each
level of ``re*re - im*im`` (and ``re*im + im*re``) as one exact value from a
shared row scale and folds two lists, not four.  ``fold_tail=t`` pre-sums
levels ``>= t`` in plain float32 before one compensated add.

The plain version forms the levels with float64 matmuls of the chunks
(exact: integer-valued sums far below 2^53, whatever the order) and converts
them to float32 (exact below 2^24 units, the bound :func:`oz.merge_ok` and
:func:`oz.unmerged_ok` check).  The kernel forms them on the tensor cores:
per level, chunk pair and k16 block one bf16 product into a zeroed float32
fragment (at most 32 products of at most 2^14 units: exact), then float32
adds into the level (exact below 2^24 units, the same bound;
:func:`edge_operands` are the operands at its edge).  Both then fold with
the same float32 operations in the same order, so they give the same bits.

Phased mode (``_phased_contract``): the operand is ``t = phase[c] * x`` in
ds (``conj(phase[c])`` with ``conj``), formed in the tile load with the TPU
kernel's operation order (``_k_phase_cmul``: four ds products phase-first,
then ``re = rr - ii``, ``im = ri + ir``); each component of ``t`` is cut at
its own row scale and contracted unmerged.  The plain version forms ``t``
with the same ds operations, then contracts it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import ds
from .. import oz as _oz
from ..ds import CDS, DS

#: Launches of the CUDA kernel (one per entry call on CUDA).
LAUNCHES = 0
#: Of those, the launches in phased mode.
PHASED_LAUNCHES = 0
#: Calls of the plain PyTorch version.
REFERENCE_CALLS = 0

# flag bits of the CUDA entry
_REAL_IN, _REAL_OUT, _MERGED, _PRESLICED, _CONJ = 1, 2, 4, 8, 16


def contract_last_oz_kernel(
    x: CDS,
    m: _oz.CSlicedMatrix,
    cmax: int = _oz.DEFAULT_CMAX,
    w: int = _oz.DEFAULT_W,
    interpret: Optional[bool] = None,
    real_in: bool = False,
    real_out: bool = False,
    phase=None,
    conj: bool = False,
    repeat: Optional[int] = None,
    fold_tail: Optional[int] = None,
) -> CDS:
    """Shared-matrix contraction: ``m`` is ``(sm, K, L)``; returns the CDS of
    shape ``x.shape[:-1] + (L,)`` (zero imaginary planes when ``real_out``).
    ``phase``: per-node ds phase rows, a CDS ``(C, K)``; the result is
    ``out[c, ..., l] = sum_k (phase[c, k] x[..., k]) m[k, l]`` (``conj``:
    the conjugate phase).  With ``repeat`` (the node count C) ``x`` is one
    shared operand read in place for every node and the output gains the
    leading ``(C,)`` axis; otherwise ``x`` leads with ``C`` (its rows split
    evenly over the nodes).  ``interpret`` is accepted for the JAX
    signature; the device decides."""
    if phase is not None:
        return _phased(x, m, phase, conj, repeat, cmax, w, fold_tail, _dispatch)
    if repeat is not None:
        raise ValueError("repeat requires phase mode")
    return _shared(x, m, cmax, w, real_in, real_out, fold_tail, _dispatch)


def contract_last_oz_kernel_reference(x, m, cmax=_oz.DEFAULT_CMAX, w=_oz.DEFAULT_W,
                                      real_in=False, real_out=False, phase=None, conj=False,
                                      repeat=None, fold_tail=None) -> CDS:
    """:func:`contract_last_oz_kernel` through the plain version, on the
    device of ``x`` (how ``chip_smoke.py`` holds the kernel to it)."""
    if phase is not None:
        return _phased(x, m, phase, conj, repeat, cmax, w, fold_tail, contract_reference)
    return _shared(x, m, cmax, w, real_in, real_out, fold_tail, contract_reference)


def _shared(x, m, cmax, w, real_in, real_out, fold_tail, run) -> CDS:
    shape = tuple(x.re.hi.shape)
    k = shape[-1]
    ell = m.re.shape[-1]
    rows = int(np.prod(shape[:-1]))
    planes = [a.reshape(rows, k) for a in (x.re.hi, x.re.lo)]
    planes += [None, None] if real_in else [a.reshape(rows, k) for a in (x.im.hi, x.im.lo)]
    out = run(planes, None, m, cmax=cmax, w=w, real_out=real_out, merged=False,
              fold_tail=fold_tail, n_nodes=1, rows_pn=rows, per_node=False, x_per_node=False)
    return _to_cds(out, shape[:-1] + (ell,))


def _phased(x, m, phase, conj, repeat, cmax, w, fold_tail, run) -> CDS:
    shape = tuple(x.re.hi.shape)
    k = shape[-1]
    ell = m.re.shape[-1]
    c = phase.re.hi.shape[0]
    if tuple(phase.re.hi.shape) != (c, k):
        raise ValueError(f"phase rows {tuple(phase.re.hi.shape)}, expected {(c, k)}")
    rows_in = int(np.prod(shape[:-1]))
    if repeat:
        if repeat != c:
            raise ValueError(f"repeat={repeat} != the phase's node count {c}")
        rows_pn, out_lead = rows_in, (c,) + shape[:-1]
    else:
        if rows_in % c:
            raise ValueError(f"{rows_in} rows do not split over {c} nodes")
        rows_pn, out_lead = rows_in // c, shape[:-1]
    planes = [a.reshape(rows_in, k) for a in (x.re.hi, x.re.lo, x.im.hi, x.im.lo)]
    ph = [a.reshape(c, k) for a in (phase.re.hi, phase.re.lo, phase.im.hi, phase.im.lo)]
    out = run(planes, None, m, cmax=cmax, w=w, real_out=False, merged=False,
              fold_tail=fold_tail, n_nodes=c, rows_pn=rows_pn, per_node=False,
              x_per_node=not repeat, phase=ph, conj=conj)
    return _to_cds(out, out_lead + (ell,))


def phase_operand(planes, phase, conj, n_nodes, x_per_node):
    """The phased mode's operand ``t = phase * x`` (``conj(phase)`` with
    ``conj``) as four float32 ``(n_nodes * rows, K)`` planes: ds products
    phase-first, then ``re = rr - ii``, ``im = ri + ir``
    (``boltzfft.oz._k_phase_cmul``).  A shared ``x`` broadcasts over the
    nodes."""
    k = planes[0].shape[-1]
    lead = n_nodes if x_per_node else 1
    xr, xi = (DS(*(a.to(torch.float32).reshape(lead, -1, k) for a in pair))
              for pair in (planes[:2], planes[2:]))
    pr, pi = (DS(*(a.to(torch.float32).reshape(n_nodes, 1, k) for a in pair))
              for pair in (phase[:2], phase[2:]))
    if conj:
        pi = ds.neg(pi)
    tre = ds.sub(ds.mul(pr, xr), ds.mul(pi, xi))
    tim = ds.add(ds.mul(pr, xi), ds.mul(pi, xr))
    return [a.reshape(-1, k) for a in (tre.hi, tre.lo, tim.hi, tim.lo)]


def contract_last_oz_nodemat(
    x: CDS,
    m: _oz.CSlicedMatrix,
    cmax: int = _oz.DEFAULT_CMAX,
    w: int = _oz.DEFAULT_W,
    interpret: Optional[bool] = None,
    repeat: bool = False,
    fold_tail: Optional[int] = None,
    x_pre=None,
    real_out: bool = False,
    merged: Optional[bool] = None,
) -> CDS:
    """Per-node-matrix contraction ``out[c, ..., l] = sum_k x[(c,) ..., k] *
    m[c, k, l]`` with ``m`` of shape ``(C, sm, K, L)``.  ``repeat``: ``x`` is
    one shared operand contracted against every node's matrix; otherwise it
    carries the leading ``(C, ...)`` axis.  ``x_pre`` (repeat only): ``x``'s
    chunks from ``preslice_rows`` in the layout ``merged`` asks for.
    ``merged`` raises unless :func:`oz.merge_ok` holds at this depth.
    ``interpret`` is accepted for the JAX signature; the device decides."""
    return _nodemat(x, m, cmax, w, repeat, fold_tail, x_pre, real_out, merged, _dispatch)


def contract_last_oz_nodemat_reference(x, m, cmax=_oz.DEFAULT_CMAX, w=_oz.DEFAULT_W,
                                       repeat=False, fold_tail=None, x_pre=None,
                                       real_out=False, merged=None) -> CDS:
    """:func:`contract_last_oz_nodemat` through the plain version, on the
    device of ``x``."""
    return _nodemat(x, m, cmax, w, repeat, fold_tail, x_pre, real_out, merged,
                    contract_reference)


def _nodemat(x, m, cmax, w, repeat, fold_tail, x_pre, real_out, merged, run) -> CDS:
    c, sm = m.re.shape[0], m.re.shape[-3]
    ell = m.re.shape[-1]
    shape = tuple(x.re.hi.shape)
    k = shape[-1]
    merged = bool(merged)
    if merged and not _oz.merge_ok(k, sm=sm, cmax=cmax, w=w):
        raise ValueError(
            f"merged contraction is not exact at K={k} (merge_ok: "
            f"2K*pairs*2^(2w) must stay <= 2^24)"
        )
    if repeat:
        rows_pn = int(np.prod(shape[:-1]))
        out_lead = (c,) + shape[:-1]
    else:
        if shape[0] != c:
            raise ValueError(f"leading axis {shape[0]} != node count {c}")
        rows_pn = int(np.prod(shape[1:-1]))
        out_lead = shape[:-1]
    if x_pre is not None:
        if not repeat:
            raise ValueError("x_pre is only meaningful for the shared-x repeat mode")
        want = _oz.PreslicedM if merged else _oz.PreslicedCDS
        if not isinstance(x_pre, want):
            raise ValueError(f"x_pre must be a {want.__name__} for merged={merged}")
    planes = [a.reshape(-1, k) for a in (x.re.hi, x.re.lo, x.im.hi, x.im.lo)]
    out = run(planes, x_pre, m, cmax=cmax, w=w, real_out=real_out, merged=merged,
              fold_tail=fold_tail, n_nodes=c, rows_pn=rows_pn, per_node=True,
              x_per_node=not repeat)
    return _to_cds(out, out_lead + (ell,))


def _to_cds(out, shape) -> CDS:
    reh, rel, imh, iml = (None if a is None else a.reshape(shape) for a in out)
    if imh is None:
        imh, iml = torch.zeros_like(reh), torch.zeros_like(rel)
    return CDS(DS(reh, rel), DS(imh, iml))


def _dispatch(planes, x_pre, m, **kw):
    tensors = [t for t in (*planes, *(x_pre or ()), *(kw.get("phase") or ()), m.re, m.im)
               if t is not None]
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"oz contraction: operands on {sorted({str(t.device) for t in tensors})}")
    if dev.type == "cuda":
        return _contract_cuda(planes, x_pre, m, **kw)
    if dev.type == "cpu":
        return contract_reference(planes, x_pre, m, **kw)
    raise ValueError(f"oz contraction: no kernel for device {dev}")


def _chunks(planes, x_pre, *, w, sx, merged, x_per_node, n_nodes, k):
    """(cr, ci): lists of float32 chunk tensors (lead, R, K); ci None for a
    real input.  ``lead`` is the node count, or 1 for a shared operand."""
    lead = n_nodes if x_per_node else 1
    if x_pre is not None:
        if merged:
            full = x_pre.full.to(torch.float32).reshape(-1, sx, 2, k)
            cr = [full[:, i, 0] for i in range(sx)]
            ci = [full[:, i, 1] for i in range(sx)]
        else:
            cr = [a for a in x_pre.all_re.to(torch.float32).reshape(-1, sx, k).unbind(1)]
            ci = [a for a in x_pre.all_im.to(torch.float32).reshape(-1, sx, k).unbind(1)]
    else:
        rh, rl, ih, il = (None if a is None else a.to(torch.float32) for a in planes)
        if merged:
            sig = torch.maximum(_oz.row_sigma(rh), _oz.row_sigma(ih))
            cr = _oz.chunk_rows(rh, rl, sig, w, sx)
            ci = _oz.chunk_rows(ih, il, sig, w, sx)
        else:
            cr = _oz.chunk_rows(rh, rl, _oz.row_sigma(rh), w, sx)
            ci = None if ih is None else _oz.chunk_rows(ih, il, _oz.row_sigma(ih), w, sx)
    shp = lambda t: t.reshape(lead, -1, k)
    return [shp(t) for t in cr], None if ci is None else [shp(t) for t in ci]


def contract_reference(planes, x_pre, m, *, cmax, w, real_out, merged, fold_tail,
                       n_nodes, rows_pn, per_node, x_per_node, phase=None, conj=False):
    """Plain PyTorch version of the kernel's entry, on the device of ``m``:
    ``planes`` are the four
    float32 (rows_in, K) planes (the imaginary pair None for a real input),
    ``x_pre`` presliced chunks or None, ``phase`` the four (n_nodes, K) phase
    planes of phased mode or None; returns the four (rows_out, L) output
    planes (the imaginary pair None for ``real_out``)."""
    global REFERENCE_CALLS
    REFERENCE_CALLS += 1
    if phase is not None:
        planes = phase_operand(planes, phase, conj, n_nodes, x_per_node)
        x_per_node = True
    return contract_plain(planes, x_pre, m, cmax=cmax, w=w, real_out=real_out, merged=merged,
                          fold_tail=fold_tail, n_nodes=n_nodes, rows_pn=rows_pn,
                          x_per_node=x_per_node)


def contract_plain(planes, x_pre, m, *, cmax, w, real_out, merged, fold_tail,
                   n_nodes, rows_pn, x_per_node):
    """The arithmetic of :func:`contract_reference`, uncounted (K9's plain
    version chains it)."""
    f64 = torch.float64
    sm, k, ell = m.re.shape[-3:]
    nlev = cmax + 1
    sx = min(_oz.DEFAULT_SLICES_X, nlev)
    cr, ci = _chunks(planes, x_pre, w=w, sx=sx, merged=merged, x_per_node=x_per_node,
                     n_nodes=n_nodes, k=k)
    cr = [t.to(f64) for t in cr]
    ci = None if ci is None else [t.to(f64) for t in ci]
    # (lead, sm, K, L): a shared matrix has lead 1
    mre = m.re.to(f64).reshape(-1, sm, k, ell)
    mim = m.im.to(f64).reshape(-1, sm, k, ell)
    n_fold = min(nlev, sx + sm - 1)
    ft = n_fold if fold_tail is None else max(1, min(fold_tail, n_fold))
    levels = lambda chunks, mats: plain_levels(chunks, mats, n_fold)

    if merged:
        combos = [([a - b for a, b in zip(levels(cr, mre), levels(ci, mim))], 1.0, 0)]
        if not real_out:
            combos.append(([a + b for a, b in zip(levels(cr, mim), levels(ci, mre))], 1.0, 1))
    else:
        combos = [(levels(cr, mre), 1.0, 0)]
        if ci is not None:
            combos.append((levels(ci, mim), -1.0, 0))
        if not real_out:
            combos.append((levels(cr, mim), 1.0, 1))
            if ci is not None:
                combos.append((levels(ci, mre), 1.0, 1))
    rows_out = n_nodes * rows_pn
    z = torch.zeros((rows_out, ell), dtype=torch.float32, device=m.re.device)
    acc = [[z, z], [z, z]]
    for lev, sgn, which in combos:
        hi, lo = acc[which]
        tail = None
        for d, v in enumerate(lev):
            v = v.to(torch.float32).reshape(rows_out, ell)
            if d >= ft:
                tail = v if tail is None else tail + v
                continue
            hi, lo = _oz.add_float(hi, lo, -v if sgn < 0 else v)
        if tail is not None:
            hi, lo = _oz.add_float(hi, lo, -tail if sgn < 0 else tail)
        acc[which] = [hi, lo]
    (reh, rel), (imh, iml) = acc
    return (reh, rel, None, None) if real_out else (reh, rel, imh, iml)


def plain_levels(chunks, mats, n_fold: int) -> list:
    """The plain version's level sums: level ``d`` (of ``n_fold``) is
    ``sum_{i + j = d} chunks[i] @ mats[:, j]`` in float64, exact whatever
    the order (integers of one unit, far below 2^53).  ``chunks``: ``sx``
    float64 ``(lead, R, K)`` tensors; ``mats``: float64 ``(lead, sm, K, L)``."""
    sx, sm = len(chunks), mats.shape[1]
    out = []
    for d in range(n_fold):
        acc = None
        for i in range(min(d, sx - 1), -1, -1):
            j = d - i
            if j >= sm:
                continue
            p = torch.matmul(chunks[i], mats[:, j])
            acc = p if acc is None else acc + p
        out.append(acc)
    return out


#: Warps of the kernel's block (``csrc/oz_common.cuh`` ``OZ_WARPS``) and the
#: shared memory a block may use (``OZ_SMEM_MAX``).
TILE_WARPS = 8
SMEM_MAX = 232448


def tile_rows(lg: int) -> int:
    """Rows of a full tile of the kernel for ``lg`` output columns, as
    ``csrc/oz_common.cuh`` ``tile_rows`` counts them: 16-row strips, as many
    as keep every warp on one 16 x 16 output tile."""
    nt = (lg + 15) // 16
    return 16 * (1 if nt >= TILE_WARPS else TILE_WARPS // nt)


def tile_smem_bytes(k: int, lg: int, sx: int, tr: int, nsl: int) -> int:
    """The tile's shared memory (``oz_common.cuh`` ``tile_smem_bytes``)."""
    kp = -(-k // 16) * 16
    lp = -(-lg // 16) * 16
    return 2 * (2 * nsl * kp * (lp + 8) + 2 * sx * tr * (kp + 8)) + 8 * tr


def plan(k: int, ell: int, sx: int, nsl: int, rows: int, extra: int = 0):
    """``(lg, tr)``: how a stage of ``rows`` rows and ``ell`` columns is cut
    (``oz_common.cuh`` ``oz_plan``): column groups of ``lg`` columns, halved
    (in multiples of 8) while the slices do not fit beside ``extra`` bytes,
    and row tiles of ``tr`` rows, a full tile or all the rows rounded up to
    16, halved down to 16 while the tile does not fit."""
    lg = ell
    while lg > 8 and extra + tile_smem_bytes(k, lg, sx, 16, nsl) > SMEM_MAX:
        lg = ((lg + 1) // 2 + 7) & ~7
    tr = min(tile_rows(lg), -(-rows // 16) * 16)
    while tr > 16 and extra + tile_smem_bytes(k, lg, sx, tr, nsl) > SMEM_MAX:
        tr = (tr // 2 + 15) & ~15
    return lg, tr


def edge_operands(k: int, ell: int, rows: int, n_nodes: int, merged: bool,
                  im_list: bool = False, device="cpu", w: int = _oz.DEFAULT_W,
                  sx: int = _oz.DEFAULT_SLICES_X, sm: int = 7):
    """Operands at the edge of the level sums' exactness, for
    :func:`contract_last_oz_nodemat` with ``repeat=True``: every chunk of
    every row at 127 units (chunk ``i`` = ``127 * 2^(-w(i+1))``, row scale
    1) and every matrix slice at 127 units, of one sign per component, so
    that every product of a list has the same sign and a level of ``p``
    chunk pairs sums ``K * p * 127^2`` units (merged ``2K``: 14.45 M of the
    2^24 at ``K = 64``, ``sx = sm = 7``, ``cmax = 6``).  Signs: the
    merged re list ``cr mre - ci mim`` is the extreme one (``mim < 0``), or
    with ``im_list`` the im list ``cr mim + ci mre`` (all positive).
    Returns ``(x, m, x_pre)``: a zero CDS of shape ``(rows, K)`` (the
    wrapper reads its shape), the ``(C, sm, K, L)`` slices and the
    presliced chunks (merged or not)."""
    unit = lambda i: 127.0 * 2.0 ** (-w * (i + 1))
    chunk = torch.tensor([unit(i) for i in range(sx)], dtype=torch.float32)
    row = chunk[:, None].expand(sx, k)  # (sx, K)
    if merged:
        full = torch.cat((row, row), dim=1).reshape(1, -1).expand(rows, -1)
        x_pre = _oz.PreslicedM(full.to(torch.bfloat16).contiguous().to(device))
    else:
        flat = row.reshape(1, -1).expand(rows, -1).to(torch.bfloat16).contiguous().to(device)
        x_pre = _oz.PreslicedCDS(flat, flat.clone())
    sl = torch.tensor([unit(j) for j in range(sm)], dtype=torch.float32)
    mre = sl[None, :, None, None].expand(n_nodes, sm, k, ell)
    mim = mre if im_list else -mre
    m = _oz.CSlicedMatrix(*(a.to(torch.bfloat16).contiguous().to(device) for a in (mre, mim)))
    z = torch.zeros((rows, k), dtype=torch.float32, device=device)
    x = CDS(DS(z, z), DS(z, z))
    return x, m, x_pre


def check_exact(k: int, sm: int, cmax: int, w: int, merged: bool) -> None:
    """Raise where a float32 level accumulator could round."""
    ok = (_oz.merge_ok if merged else _oz.unmerged_ok)(k, sm=sm, cmax=cmax, w=w)
    if not ok:
        raise ValueError(f"oz contraction: level sums are not exact in float32 at K={k}"
                         f" (merged={merged}, cmax={cmax}, w={w})")


def _contract_cuda(planes, x_pre, m, *, cmax, w, real_out, merged, fold_tail,
                   n_nodes, rows_pn, per_node, x_per_node, phase=None, conj=False):
    global LAUNCHES, PHASED_LAUNCHES
    from .._build import load_library

    sm, k, ell = m.re.shape[-3:]
    nlev = cmax + 1
    sx = min(_oz.DEFAULT_SLICES_X, nlev)
    if nlev > 8 or sm > 8 or w < 1:
        raise ValueError(f"oz contraction kernel: cmax <= 7 and sm <= 8 (got cmax={cmax}, sm={sm})")
    check_exact(k, sm, cmax, w, merged)
    dev = m.re.device
    real_in = planes[2] is None
    flags = ((_REAL_IN * real_in) | (_REAL_OUT * real_out) | (_MERGED * merged)
             | (_CONJ * bool(conj)))
    ptr = lambda t: None if t is None else t.data_ptr()
    keep = []  # contiguous operands, alive until the launch is queued
    ph = [None] * 4
    if phase is not None:
        if merged or x_pre is not None or real_in or per_node:
            raise ValueError("oz contraction: phased mode is unmerged, complex in, shared matrix")
        ph = [t.to(torch.float32).contiguous() for t in phase]
        for t in ph:
            if tuple(t.shape) != (n_nodes, k):
                raise ValueError(f"oz contraction: phase rows {tuple(t.shape)}, expected {(n_nodes, k)}")
        keep += ph
    if x_pre is not None:
        flags |= _PRESLICED
        pre = [x_pre.full, None] if merged else [x_pre.all_re, x_pre.all_im]
        pre = [None if t is None else t.contiguous() for t in pre]
        keep += pre
        xs = [None] * 4
    else:
        xs = [None if t is None else t.to(torch.float32).contiguous() for t in planes]
        keep += xs
        pre = [None, None]
    mre, mim = m.re.contiguous(), m.im.contiguous()
    rows_out = n_nodes * rows_pn
    rows_in = rows_pn * (n_nodes if x_per_node else 1)
    width = sx * k * (2 if merged else 1) if x_pre is not None else k
    for t in (*xs, *pre):
        if t is not None and tuple(t.shape) != (rows_in, width):
            raise ValueError(f"oz contraction: operand {tuple(t.shape)}, expected {(rows_in, width)}")
    want_m = ((n_nodes,) if per_node else ()) + (sm, k, ell)
    if tuple(mre.shape) != want_m or tuple(mim.shape) != want_m or mre.dtype != torch.bfloat16:
        raise ValueError(f"oz contraction: bf16 matrix slices {tuple(mre.shape)}, expected {want_m}")
    outs = [torch.empty((rows_out, ell), dtype=torch.float32, device=dev)
            for _ in range(2 if real_out else 4)]
    outs += [None] * (4 - len(outs))
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.bfft_oz_contract(
            *[ptr(t) for t in xs], *[ptr(t) for t in pre], mre.data_ptr(), mim.data_ptr(),
            *[ptr(t) for t in ph], *[ptr(t) for t in outs],
            n_nodes, rows_pn, int(per_node), int(x_per_node), k, ell, sm, nlev, sx, w,
            -1 if fold_tail is None else int(fold_tail), flags, stream)
    if rc != 0:
        raise RuntimeError(f"oz contraction: CUDA kernel failed with cudaError {rc}")
    LAUNCHES += 1
    PHASED_LAUNCHES += phase is not None
    return tuple(outs)
