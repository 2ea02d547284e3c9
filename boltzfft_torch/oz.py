"""Ozaki-scheme sliced contraction at ds accuracy (mirror of the host and
plain half of ``boltzfft/oz.py``).

Every ds value is cut into ``w``-bit mantissa chunks aligned to a per-row
power-of-two scale: each chunk is an integer multiple of a shared unit below
``2^(w+1)`` and so exact in bfloat16.  A chunk-pair product is an integer of
at most ``2w`` bits times a shared unit, so a dot of ``K`` of them is exact
in a float32 accumulator while ``K * pairs * 2^(2w) <= 2^24``.  The slice
pairs with index sum ``i + j <= cmax`` are grouped by level ``d = i + j``
(one exact value per level) and folded largest level first with compensated
adds.  Truncation is ``~2^-w(cmax+2)`` of the row scale: ds class at the
pipeline's ``w=7, cmax=6``.

This module holds the host table slicing, the chunk extraction and fold
shared by the kernels' plain versions, the staged contraction
(:func:`contract_last_oz`, the JAX package's off-TPU engine), the 3-D
transforms, which call the K8 wrapper (``kernels.oz_contract``): the CUDA
kernel on a CUDA tensor, its plain version on a CPU tensor.

The row scale.  The JAX package has two rules: its TPU kernels and
``preslice_rows`` take ``exp2(floor(log2(max|x|)) + 1)`` (``_phase_sigma``),
its off-TPU twin of the contraction the exponent bits plus one, clamped to
[64, 254] (``_pow2_ceil``).  They differ only where ``log2`` rounds a value
just below a power of two up to it.  The port takes the exponent-bit rule
everywhere, kernels and plain versions alike, so kernel and plain agree
bitwise; against a JAX path that uses ``_phase_sigma`` the result agrees
bitwise wherever the two scales agree and at the ds noise floor elsewhere.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from . import ds
from .ds import CDS, DS, quick_two_sum, two_sum

DEFAULT_W = 7  # chunk width (bits); 7 keeps depth-128 dots + 8-term level sums exact
DEFAULT_SLICES_X = 7  # 49 bits: all of a float32 ds pair
DEFAULT_SLICES_M = 8  # 56 bits: a full float64 table entry
DEFAULT_CMAX = 7  # keep slice pairs with i + j <= cmax


class CSlicedMatrix(NamedTuple):
    """A (K, L) complex matrix as bf16 mantissa slices (host-split from f64).

    ``re``/``im``: (nslices, K, L) bfloat16 tensors (or ``(..., nslices, K,
    L)`` per node); slice ``j`` holds the ``w``-bit chunk at scale
    ``sigma * 2^{-w(j+1)}`` (true values: the slices sum to the matrix)."""

    re: torch.Tensor
    im: torch.Tensor


class PreslicedCDS(NamedTuple):
    """All ``sx`` bf16 chunks of a flattened CDS operand, chunk index on the
    last axis: ``(rows, sx*K)`` per component (:func:`kernels.oz_preslice.preslice_rows`)."""

    all_re: torch.Tensor
    all_im: torch.Tensor


class PreslicedM(NamedTuple):
    """K-merged presliced chunks (shared per-row scale, chunk block ``i`` is
    ``[re_i | im_i]``): ``full`` is ``(rows, sx*2K)`` bf16."""

    full: torch.Tensor


def _host_slices(m: np.ndarray, nslices: int, w: int) -> np.ndarray:
    """Split a real f64 matrix into w-bit chunks of a global pow-2 scale."""
    m = np.asarray(m, np.float64)
    amax = float(np.max(np.abs(m))) if m.size else 0.0
    sigma = 2.0 ** np.ceil(np.log2(amax)) if amax > 0 else 1.0
    r = m.copy()
    out = np.empty((nslices,) + m.shape, np.float32)
    for j in range(nslices):
        u = sigma * 2.0 ** (-w * (j + 1))
        c = np.round(r / u) * u  # multiple of u, |c/u| <= 2^w: bf16-exact
        out[j] = c
        r -= c
    return out


def _bf16(a: np.ndarray, device) -> torch.Tensor:
    """float32 values that bfloat16 holds exactly, as a bf16 tensor."""
    return torch.as_tensor(np.ascontiguousarray(a), device=device).to(torch.bfloat16)


def slice_matrix(
    m: np.ndarray, nslices: int = DEFAULT_SLICES_M, w: int = DEFAULT_W, device="cpu"
) -> CSlicedMatrix:
    """Host-split a complex (or real) f64 matrix into bf16 slices on ``device``."""
    m = np.asarray(m)
    return CSlicedMatrix(
        re=_bf16(_host_slices(m.real, nslices, w), device),
        im=_bf16(_host_slices(m.imag, nslices, w), device),
    )


def slice_matrix_nodes(
    m: np.ndarray, nslices: int = DEFAULT_SLICES_M, w: int = DEFAULT_W, device="cpu"
) -> CSlicedMatrix:
    """Host-split a batch of per-node matrices ``(..., K, L)``: slices
    ``(..., nslices, K, L)`` (slice axis inside the node axes), one global
    power-of-two scale across the batch."""
    m = np.asarray(m)
    sl = lambda comp: np.moveaxis(_host_slices(comp, nslices, w), 0, -3)
    return CSlicedMatrix(re=_bf16(sl(m.real), device), im=_bf16(sl(m.imag), device))


def merge_ok(k: int, sx: int = DEFAULT_SLICES_X, sm=None,
             cmax: int = DEFAULT_CMAX, w: int = DEFAULT_W) -> bool:
    """Whether the K-merged complex contraction stays exact at depth ``k``:
    a merged level dot sums ``2k * pairs`` products of two w-bit integers in
    one float32 accumulator, exact while ``2k * pairs * 2^(2w) <= 2^24``
    (``k <= 73`` at the defaults: every stage at 64^3 and below)."""
    if sm is None:
        sm = DEFAULT_SLICES_M
    pairs = min(cmax + 1, min(sx, cmax + 1), sm)
    return 2 * k * pairs * (1 << (2 * w)) <= (1 << 24)


def unmerged_ok(k: int, sx: int = DEFAULT_SLICES_X, sm=None,
                cmax: int = DEFAULT_CMAX, w: int = DEFAULT_W) -> bool:
    """The same bound for one component pair (``k <= 146`` at the
    defaults): past it a float32 level accumulator would round."""
    if sm is None:
        sm = DEFAULT_SLICES_M
    pairs = min(cmax + 1, min(sx, cmax + 1), sm)
    return k * pairs * (1 << (2 * w)) <= (1 << 24)


_GROUP_LEVELS = 2


def _level_groups(nlev: int, sx_eff: int):
    """Staircase partition of the fold levels ``((d0, d1, n_chunks), ...)``
    of the TPU kernel (group ``[d0, d1)`` needs chunks ``i < min(d1, sx)``),
    and so its chunk-level MAC units.  The port's kernel forms every level
    in one pass over the retained pairs and does not partition them."""
    groups = []
    d0 = 0
    while d0 < nlev:
        d1 = min(d0 + _GROUP_LEVELS, nlev)
        groups.append((d0, d1, min(d1, sx_eff)))
        d0 = d1
    return tuple(groups)


# ---------------------------------------------------------------------------
# chunk extraction and fold (the plain versions' arithmetic, float32 EFTs)
# ---------------------------------------------------------------------------


def pow2_ceil(a: torch.Tensor) -> torch.Tensor:
    """Smallest power of two strictly above ``a >= 0`` via exponent bits
    (float32), the exponent clamped to [64, 254] so an all-zero row gives
    zero chunks, not NaNs (``boltzfft.oz._pow2_ceil``)."""
    bits = a.to(torch.float32).contiguous().view(torch.int32)
    exp = torch.clamp(((bits >> 23) & 0xFF) + 1, 64, 254)
    return (exp << 23).view(torch.float32)


def row_sigma(hi: torch.Tensor) -> torch.Tensor:
    """Per-row slicing scale of the last axis, keepdim."""
    return pow2_ceil(hi.abs().amax(dim=-1, keepdim=True))


def chunk_rows(hi, lo, sig, w: int, sx: int) -> list:
    """The ``sx`` float32 chunks (bf16-exact values) of a ds operand at the
    per-row scale ``sig``: the shift trick (add and subtract a mid-binade
    constant whose ulp is the chunk unit), then the low word folded into the
    residual (``boltzfft.oz._chunk_rows``)."""
    out = []
    r_hi, r_lo = hi, lo
    for i in range(sx):
        m_i = (1.5 * 2.0 ** (23 - w * (i + 1))) * sig
        c = (r_hi + m_i) - m_i
        out.append(c)
        r_hi = r_hi - c  # exact
        r_hi, r_lo = two_sum(r_hi, r_lo)
    return out


def add_float(hi, lo, p):
    """(hi, lo) ds += plain float32 p (two_sum, then quick_two_sum)."""
    s, e = two_sum(hi, p)
    return quick_two_sum(s, e + lo)


def slice_ds_last(x: DS, nslices: int = DEFAULT_SLICES_X, w: int = DEFAULT_W) -> torch.Tensor:
    """(nslices, *x.shape) bf16 chunks of a ds tensor scaled per row of its
    last axis (the staged engine's slicing)."""
    hi, lo = x.hi.to(torch.float32), x.lo.to(torch.float32)
    return torch.stack(chunk_rows(hi, lo, row_sigma(hi), w, nslices)).to(torch.bfloat16)


def _level_dots(xs: torch.Tensor, ms: torch.Tensor, cmax: int) -> list:
    """Per-level exact dot sums, level d = sum_{i+j=d} xs[i] @ ms[j], formed
    in float64 (exact: integer-valued sums far below 2^53) and returned as
    float32 (exact below 2^24 units)."""
    xs64, ms64 = xs.to(torch.float64), ms.to(torch.float64)
    levels = []
    for d in range(cmax + 1):
        acc = None
        for i in range(min(d, xs.shape[0] - 1), -1, -1):
            j = d - i
            if j >= ms.shape[0]:
                continue
            p = torch.matmul(xs64[i], ms64[j])
            acc = p if acc is None else acc + p
        if acc is not None:
            levels.append(acc.to(torch.float32))
    return levels


def _fold_levels(a: list, b: list, sign_b: float) -> DS:
    """Compensated ``sum(a) + sign_b * sum(b)`` of exact level arrays, folded
    largest scale first, a and b interleaved per level."""
    acc = None
    for d in range(max(len(a), len(b))):
        for arr, sgn in ((a, 1.0), (b, sign_b)):
            if d < len(arr):
                t = arr[d] if sgn > 0 else -arr[d]
                acc = DS(t, torch.zeros_like(t)) if acc is None else DS(*add_float(acc.hi, acc.lo, t))
    return acc


def contract_last_oz(
    x: CDS, m: CSlicedMatrix, cmax: int = DEFAULT_CMAX, w: int = DEFAULT_W,
    real_in: bool = False, real_out: bool = False,
    fold_tail: Optional[int] = None,
) -> CDS:
    """Staged ``out[..., l] = sum_k x[..., k] * m[k, l]`` at ds accuracy (the
    JAX package's engine off the TPU, ``contract="oz"`` there): per-level
    dots, then the fold with the two component lists interleaved per level.
    The kernel route (:func:`kernels.oz_contract.contract_last_oz_kernel`)
    folds the lists one after the other, so the two agree at the ds noise
    floor, not bitwise."""
    xr = slice_ds_last(x.re, w=w)
    rr = _level_dots(xr, m.re, cmax)
    ri = None if real_out else _level_dots(xr, m.im, cmax)
    if real_in:
        ii, ir = [], []
    else:
        xi = slice_ds_last(x.im, w=w)
        ii = _level_dots(xi, m.im, cmax)
        ir = [] if real_out else _level_dots(xi, m.re, cmax)
    if fold_tail is not None:
        def collapse(levels):
            ft = max(1, fold_tail)
            if levels is None or len(levels) <= ft + 1:
                return levels
            tail = levels[ft]
            for t in levels[ft + 1:]:
                tail = tail + t
            return levels[:ft] + [tail]

        rr, ri, ii, ir = (collapse(v) for v in (rr, ri, ii, ir))
    re = _fold_levels(rr, ii, -1.0)
    if real_out:
        return CDS(re, DS(torch.zeros_like(re.hi), torch.zeros_like(re.lo)))
    return CDS(re, _fold_levels(ri, ir, +1.0))


# ---------------------------------------------------------------------------
# 3-D transforms through the K8 wrapper
# ---------------------------------------------------------------------------


def transform3_oz(
    x: CDS,
    m,
    cmax: int = DEFAULT_CMAX,
    kernel: Optional[bool] = None,
    real_in: bool = False,
    real_out: bool = False,
    fold_tail: Optional[int] = None,
    w: int = DEFAULT_W,
) -> CDS:
    """Separable 3-D transform of the trailing (Nx, Ny, Nz) axes with the
    sliced matrix (or per-axis ``(mx, my, mz)`` tuple) ``m``.  ``kernel``
    None or True runs K8 (``contract_last_oz_kernel``: the CUDA kernel on a
    CUDA tensor, its plain version on a CPU tensor); False the staged
    :func:`contract_last_oz`."""
    from .kernels.oz_contract import contract_last_oz_kernel

    mx, my, mz = (m, m, m) if isinstance(m, CSlicedMatrix) else tuple(m)
    c = contract_last_oz if kernel is False else contract_last_oz_kernel
    x = c(x, mz, cmax, w=w, real_in=real_in, fold_tail=fold_tail)  # z
    x = ds._swap_last2(c(ds._swap_last2(x), my, cmax, w=w, fold_tail=fold_tail))  # y
    return ds._roll_axis(  # x
        c(ds._roll_axis(x, -3, -1), mx, cmax, w=w, real_out=real_out, fold_tail=fold_tail),
        -1, -3,
    )


def transform3_oz_phased(
    f_hat: CDS,
    m,
    phases,
    conj: bool = False,
    cmax: int = DEFAULT_CMAX,
    kernel: Optional[bool] = None,
    w: int = DEFAULT_W,
    fold_tail: Optional[int] = None,
) -> CDS:
    """``IFFT3(alpha_b . f_hat)`` for a block of nodes with the separable
    per-axis phases applied in each axis contraction (K8's phased mode).
    ``f_hat`` is the shared ``(Nx, Ny, Nz)`` spectrum, ``phases`` a
    ``(px, py, pz)`` triple of CDS ``(C, N_axis)`` tables, ``m`` the shared
    sliced matrix or a per-axis tuple; ``conj`` evaluates the conjugate-phase
    (g2) stream.  Returns ``(C, Nx, Ny, Nz)``.  The device of ``f_hat``
    picks K8 or its plain version (the JAX signature's ``kernel`` has no
    counterpart)."""
    from .kernels.oz_contract import contract_last_oz_kernel

    mx, my, mz = (m, m, m) if isinstance(m, CSlicedMatrix) else tuple(m)
    px, py, pz = phases
    c = px.re.hi.shape[0]

    def ck(t, mm, ph, **kw):
        return contract_last_oz_kernel(t, mm, cmax=cmax, w=w, phase=ph, conj=conj,
                                       fold_tail=fold_tail, **kw)

    x = ck(f_hat, mz, pz, repeat=c)  # z, shared input: (C, Nx, Ny, Nz)
    x = ds._swap_last2(ck(ds._swap_last2(x), my, py))  # y
    return ds._roll_axis(ck(ds._roll_axis(x, -3, -1), mx, px), -1, -3)  # x


def transform3_oz_nodemat(
    x: CDS,
    mats,
    cmax: int = DEFAULT_CMAX,
    repeat: bool = True,
    fold_tail: Optional[int] = None,
    w: int = DEFAULT_W,
    x_pre=None,
    merged: Optional[bool] = None,
) -> CDS:
    """``IFFT3(alpha_c . x)`` for a block of nodes with the per-axis phases
    folded into per-node matrices ``(mx, my, mz)``, each ``(C, sm, N, N)``.
    With ``repeat`` (default) ``x`` is one shared ``(Nx, Ny, Nz)`` spectrum;
    returns ``(C, Nx, Ny, Nz)``.  ``merged`` applies per axis where
    :func:`merge_ok` holds.  The device of ``x`` picks K8 or its plain
    version (the JAX signature's ``kernel`` has no counterpart)."""
    from .kernels.oz_contract import contract_last_oz_nodemat

    mx, my, mz = mats

    def ck(t, mm, **kw):
        return contract_last_oz_nodemat(t, mm, cmax=cmax, w=w, fold_tail=fold_tail, **kw)

    mok = lambda mm: bool(merged) and merge_ok(mm.re.shape[-2], sm=mm.re.shape[-3], cmax=cmax, w=w)
    pre_kw = {"x_pre": x_pre} if (x_pre is not None and repeat) else {}
    x = ck(x, mz, repeat=repeat, merged=mok(mz), **pre_kw)  # z: (C, Nx, Ny, Nz)
    x = ds._swap_last2(ck(ds._swap_last2(x), my, merged=mok(my)))  # y
    return ds._roll_axis(ck(ds._roll_axis(x, -3, -1), mx, merged=mok(mx)), -1, -3)  # x

