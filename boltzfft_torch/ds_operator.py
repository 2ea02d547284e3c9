"""Compensated (double-single) collision pipeline (mirror of
``boltzfft/ds_operator.py``, the single-device operator).

The whole pipeline (forward transform, per-node shifted convolutions,
Hadamard, gain reduction, loss, assembly) runs in double-single arithmetic
(:mod:`boltzfft_torch.ds`): every value is a float32 pair (~49 bits), every
table is split exactly from host float64, and ``f`` may enter as an exact
split of a host float64 distribution (:func:`ds.from_f64`).

Two transform engines: ``"vpu"``, compensated rank-1 updates in plain
PyTorch (the bit reference), and ``"oz"`` (``"ozk"`` is the same engine),
Ozaki-sliced contractions through the hand-written kernels K7 (chunks of a
shared spectrum), K8 (contractions; its phased mode for tables built without
the per-node matrices), K9 (the fused main block), K10 (the fused y+x main
block, z-blocked), K11 (the full-stream Hadamard sum) and K12 (the
half-spectrum Hadamard sum) on a CUDA device, and through their plain
PyTorch versions on the CPU.  The oz engine's routes: the half g-streams
(K7, K8, K9 or K10 or the staged K8 chain, K12), the full g-streams on the
per-node matrices (K7, K8, K11) and, for tables built with
``node_mats=False``, the phased full streams (K8's phased mode, K11).

The device of the tensors takes the place of the JAX package's
``jax.default_backend() == "tpu"`` test: on CUDA the defaults are the oz
engine, the half g-stream, merged stages, the fused main block under
:func:`_gmain_mode` (K9 ``"3"`` up to ~40^3, K10 ``"12"`` above, measured on
the card), Hermitian downstream on grids <= 32 per axis and
``group_batch=2`` there; on the CPU the vpu engine and the full streams, as
in JAX.  The Hermitian and group-batch rules were measured on a TPU; the
port keeps them as its starting rules until they are measured on the card.

:func:`make_sharded_ds_collision_operator` spreads the radial groups over
the ranks of a mesh dim (:mod:`boltzfft_torch.sharding`) and folds the
partial gain spectra in ds arithmetic after one ``all_gather``.
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import ds
from . import modes as _modes
from . import obs
from . import oz
from . import quadrature as _quad
from . import weights as _weights
from ._graph import Replayed, hold
from .ds import CDS, DS, tree_map
from .kernels import oz_contract as _k8
from .kernels import oz_gmain as _k9
from .kernels import oz_gmain12 as _k10
from .kernels import oz_hadamard as _k12
from .kernels import oz_hadamard_full as _k11
from .kernels import oz_preslice as _k7
from .weights import CollisionConfig, sincc

class DsPrecomp(NamedTuple):
    """Double-single tables, grouped by radial quadrature node (the fields
    and layouts of ``boltzfft.ds_operator.DsPrecomp``)."""

    ax: CDS  # (n_gl, ns, N) alpha phase factors, x axis
    ay: CDS
    az: CDS
    gain_w: DS  # (n_gl, ns) w_gl * w_sph * rho^(gamma+2)
    beta1: DS  # (n_gl, Nx, Ny, Nz) radial gain kernel rows
    beta2: DS  # (Nx, Ny, Nz) loss multiplier
    vfwd: CDS  # (N, N) forward DFT matrix, or a per-axis (mx, my, mz) tuple
    vinv: CDS  # (N, N) 1/N-normalized inverse DFT matrix (or tuple)
    vfwd_sl: oz.CSlicedMatrix  # bf16 slices for the oz engine (or tuple)
    vinv_sl: oz.CSlicedMatrix
    # per-node phase-folded inverse matrices diag(alpha_axis) @ Vinv (pm1)
    # and diag(conj(alpha_axis)) @ Vinv (pm2), (mx, my, mz) tuples of
    # (n_gl, ns, sm, N, N) slices; None when built with node_mats=False
    pm1: Optional[tuple] = None
    pm2: Optional[tuple] = None
    # half-spectrum g-stream tables (even grids): the per-node z half
    # matrices (n_gl, ns, sm, Nz/2, Nz) of stream 2 and, weight-folded, of
    # stream 1, and the Nyquist-block coefficients (CDS (n_gl, ns) each)
    pmz_half2: Optional[oz.CSlicedMatrix] = None
    nyq_coef: Optional[tuple] = None
    pmz_half1w: Optional[oz.CSlicedMatrix] = None
    nyq_coef_w: Optional[tuple] = None
    # Hermitian-downstream shared z matrices: the forward restricted to
    # kz < Nz/2 (Nz, Nz/2) and the pair-weighted half-depth inverse (Nz/2, Nz)
    vfwd_zh_sl: Optional[oz.CSlicedMatrix] = None
    vinv_zh_sl: Optional[oz.CSlicedMatrix] = None


#: Ozaki slice-pair retention for the ds pipeline at the w=7 chunk width.
DS_PIPELINE_CMAX = 6
#: Fold-tail pre-summing for the pipeline: None = exact all-ds fold.
DS_PIPELINE_FOLD_TAIL = None
#: Default of collide_ds(oz_merge=None): K-merged per-node stages.
DS_PIPELINE_MERGE = True
#: Radial steps whose main-block tables the half path lays out in one go
#: (``_interleave``): the eval holds a copy of 8 steps' tables at a time,
#: not of all of them, for 6 more launches per chunk.
LAYOUT_STEPS = 8


def _pipeline_slicing(cfg: CollisionConfig):
    """Ozaki slicing of the ds pipeline: ``(w, nslices_m, default_cmax)`` =
    (7, 8, 6), the JAX package's digit-exact choice."""
    return 7, 8, DS_PIPELINE_CMAX


def build_ds_precomp(
    cfg: CollisionConfig, dtype=torch.float32, node_mats: bool = True, device="cuda"
) -> DsPrecomp:
    """All host math in float64 NumPy, split exactly into ds pairs of
    ``dtype`` and bf16 slices, then put on ``device`` (bitwise the tables of
    ``boltzfft.ds_operator.build_ds_precomp``).  ``node_mats`` also builds
    the per-node oz tables (~0.6 GB on the device at 64^3/Ns=12)."""
    device = torch.device(device)
    nx, ny, nz = cfg.grid_shape
    length = cfg.domain_length
    gl = _quad.gauss_legendre(cfg.n_gl, 0.0, cfg.r_max)
    sph = _weights.spherical_quadrature(cfg)
    rho = gl.nodes
    sigma = sph.points
    modes = [_modes.fft_modes(n).astype(np.float64) for n in (nx, ny, nz)]
    coef = -np.pi / (2.0 * length)

    def axis_phase_c128(axis):
        ph = coef * rho[:, None, None] * sigma[None, :, axis, None] * modes[axis][None, None, :]
        return np.exp(1j * ph)

    cds = lambda a: ds.cds_from_f64(a, dtype, device)
    gain_w = (gl.weights * rho ** (cfg.gamma + 2.0))[:, None] * sph.weights[None, :]
    norm_l = _modes.mode_norm_grid(*modes)
    eps64 = float(np.finfo(np.float64).eps)
    beta1 = (4.0 * np.pi * cfg.b_gamma) * sincc(
        (np.pi / (2.0 * length)) * rho[:, None, None, None] * norm_l[None], eps64
    )
    radial_w = gl.weights * rho ** (cfg.gamma + 2.0)
    arg = (np.pi / length) * rho[:, None] * norm_l.reshape(1, -1)
    beta2 = (16.0 * np.pi**2 * cfg.b_gamma * (radial_w @ sincc(arg, eps64))).reshape(norm_l.shape)

    def dft_pair(n):
        m = np.arange(n)
        ph = 2.0 * np.pi * np.outer(m, m) / n
        return np.exp(-1j * ph), np.exp(1j * ph) / n

    slw, slm, _ = _pipeline_slicing(cfg)
    sl = lambda a: oz.slice_matrix(a, slm, slw, device)
    sln = lambda a: oz.slice_matrix_nodes(a, slm, slw, device)
    pairs = [dft_pair(n) for n in (nx, ny, nz)]
    if cfg.is_isotropic:
        vfwd, vinv = cds(pairs[0][0]), cds(pairs[0][1])
        vfwd_sl, vinv_sl = sl(pairs[0][0]), sl(pairs[0][1])
    else:
        vfwd = tuple(cds(p[0]) for p in pairs)
        vinv = tuple(cds(p[1]) for p in pairs)
        vfwd_sl = tuple(sl(p[0]) for p in pairs)
        vinv_sl = tuple(sl(p[1]) for p in pairs)
    pm1 = pm2 = None
    if node_mats:
        def folded(axis):
            p = axis_phase_c128(axis)[..., :, None]
            vinv64 = pairs[axis][1]
            return sln(p * vinv64[None, None]), sln(np.conj(p) * vinv64[None, None])

        fx, fy, fz = folded(0), folded(1), folded(2)
        pm1 = (fx[0], fy[0], fz[0])
        pm2 = (fx[1], fy[1], fz[1])
    pmz_half2 = pmz_half1w = nyq_coef = nyq_coef_w = None
    vfwd_zh_sl = vinv_zh_sl = None
    if node_mats and nx % 2 == ny % 2 == nz % 2 == 0:
        nzh = nz // 2
        pz = axis_phase_c128(2)[..., :nzh, None]
        ejz = np.exp(2j * np.pi * np.outer(np.arange(nzh), np.arange(nz)) / nz) / nz
        wt = np.ones((nzh, 1))
        wt[1:] = 2.0
        mzh = wt[None, None] * ejz[None, None]
        pmz_half2 = sln(np.conj(pz) * mzh)
        pmz_half1w = sln(pz * mzh * gain_w[:, :, None, None])
        vfwd_zh_sl = sl(pairs[2][0][:, :nzh])
        vinv_zh_sl = sl(wt * ejz)
        nus = [axis_phase_c128(a)[..., n // 2] for a, n in zip(range(3), (nx, ny, nz))]
        raw_coef = (
            nus[0] / nx,
            nus[1] / ny,
            nus[2] / nz,
            nus[1] * nus[2] / (ny * nz),  # line with free axis x
            nus[0] * nus[2] / (nx * nz),  # free axis y
            nus[0] * nus[1] / (nx * ny),  # free axis z
            nus[0] * nus[1] * nus[2] / (nx * ny * nz),
        )
        nyq_coef = tuple(cds(c) for c in raw_coef)
        nyq_coef_w = tuple(cds(c * gain_w) for c in raw_coef)
    f64 = lambda a: ds.from_f64(a, dtype, device)
    return DsPrecomp(
        ax=cds(axis_phase_c128(0)), ay=cds(axis_phase_c128(1)), az=cds(axis_phase_c128(2)),
        gain_w=f64(gain_w), beta1=f64(beta1), beta2=f64(beta2),
        vfwd=vfwd, vinv=vinv, vfwd_sl=vfwd_sl, vinv_sl=vinv_sl, pm1=pm1, pm2=pm2,
        pmz_half2=pmz_half2, nyq_coef=nyq_coef, pmz_half1w=pmz_half1w, nyq_coef_w=nyq_coef_w,
        vfwd_zh_sl=vfwd_zh_sl, vinv_zh_sl=vinv_zh_sl,
    )


def _cindex(x, idx):
    """Apply one index to every tensor of a DS/CDS tree."""
    return tree_map(lambda a: a[idx], x)


def _cconj(c: CDS) -> CDS:
    """Exact complex conjugate of a CDS (negated imaginary planes)."""
    return CDS(c.re, DS(-c.im.hi, -c.im.lo))


def _corr_ck(cmax, w, ftail):
    """Shared-matrix contraction of the Nyquist corrections and the
    Hermitian forward/inverse: K8 (``contract_last_oz_kernel``)."""
    return partial(_k8.contract_last_oz_kernel, cmax=cmax, w=w, fold_tail=ftail)


class _GridConsts(NamedTuple):
    """The half path's per-grid constants (float32; ``inv_nz`` a ds pair of
    the eval's dtype)."""

    keep: tuple  # (kx, ky, kz): 1 off the axis's Nyquist index, 0 on it
    signs: tuple  # (sx, sy, sz): (-1)^n
    keep_planes: tuple  # ky (x) kz, kx (x) kz, kx (x) ky
    syz: torch.Tensor  # sy (x) sz
    fmask: torch.Tensor  # kx (x) ky: the main block's x/y Nyquist mask
    inv_nz: DS  # 1/Nz, exactly split


@lru_cache(maxsize=8)
def _grid_consts(grid_shape: tuple, dtype: torch.dtype, device: torch.device) -> _GridConsts:
    """Built once per (grid, dtype, device) and only from device arithmetic:
    a captured eval (``make_ds_collision_operator(jit=True)``) may not copy
    from the host.  The eval passes them through ``_graph.hold``, so a graph
    that reads them keeps them alive whatever this cache evicts.  The values are exact (0, 1, -1), bit for bit those of
    the host arrays they replace."""
    ar = lambda n: torch.arange(n, device=device)
    keep = tuple((ar(n) != n // 2).to(torch.float32) for n in grid_shape)
    signs = tuple((1 - 2 * (ar(n) % 2)).to(torch.float32) for n in grid_shape)
    kx, ky, kz = keep
    npd = np.float32 if dtype == torch.float32 else np.float64
    inv = np.float64(1.0) / grid_shape[2]  # split as ds.from_f64 splits it
    hi = npd(inv)
    lo = npd(inv - np.float64(hi))
    full = lambda v: torch.full((), float(v), dtype=dtype, device=device)
    return _GridConsts(
        keep=keep, signs=signs,
        keep_planes=(ky[:, None] * kz[None, :], kx[:, None] * kz[None, :],
                     kx[:, None] * ky[None, :]),
        syz=signs[1][:, None] * signs[2][None, :],
        fmask=kx[:, None] * ky[None, :],
        inv_nz=DS(full(hi), full(lo)),
    )


def _nyq_corrections(cfg, pre, f_hat, ck, conj: bool, coef=None):
    """Coefficient-folded Nyquist-block correction fields of one g stream for
    all nodes: the three plane CDS fields (leading (n_gl, ns)) with the
    line and point blocks folded in (``boltzfft.ds_operator._nyq_corrections``)."""
    nx, ny, nz = cfg.grid_shape
    hx, hy, hz = nx // 2, ny // 2, nz // 2
    gc = hold(_grid_consts(cfg.grid_shape, f_hat.re.hi.dtype, f_hat.re.hi.device))
    kx, ky, kz = gc.keep
    vs = pre.vinv_sl
    vx, vy, vz = (vs, vs, vs) if isinstance(vs, oz.CSlicedMatrix) else tuple(vs)
    ph = (pre.ax, pre.ay, pre.az)
    if coef is None:
        coef = pre.nyq_coef
    if conj:
        ph = tuple(_cconj(p) for p in ph)
        coef = tuple(_cconj(c) for c in coef)
    ax, ay, az = ph
    al = slice(None)

    def t2(u, m_last, m_second):
        u = ck(u, m_last)
        return ds._swap_last2(ck(ds._swap_last2(u), m_second))

    def plane(take, mask, p_b, p_c, m_last, m_second, cf):
        data = tree_map(lambda a: a[take] * mask, f_hat)
        u = ds.cmul(_cindex(p_b, (al, al, al, None)), data)
        u = ds.cmul(_cindex(p_c, (al, al, None, al)), u)
        t = t2(u, m_last, m_second)
        return ds.cmul(_cindex(cf, (al, al, None, None)), t)

    px = plane((hx,), gc.keep_planes[0], ay, az, vz, vy, coef[0])
    py = plane((al, hy), gc.keep_planes[1], ax, az, vz, vx, coef[1])
    pz = plane((al, al, hz), gc.keep_planes[2], ax, ay, vy, vx, coef[2])

    def line(take, mask, p_a, m_a, cf):
        data = tree_map(lambda a: a[take] * mask, f_hat)
        u = ds.cmul(p_a, tree_map(lambda a: a[None, None, :], data))
        t = ck(u, m_a)
        return ds.cmul(_cindex(cf, (al, al, None)), t)

    lx = line((al, hy, hz), kx, ax, vx, coef[3])
    ly = line((hx, al, hz), ky, ay, vy, coef[4])
    lz = line((hx, hy, al), kz, az, vz, coef[5])
    corner = tree_map(lambda a: a[hx, hy, hz], f_hat)
    pt = ds.cmul(coef[6], corner)

    # fold the line and point terms into the plane fields (exact +-1
    # patterns, compensated adds; one launch each on the card):
    #   g = r_main + sx(jx).px'(jy,jz) + sy(jy).py'(jx,jz) + sz(jz).pz(jx,jy)
    _, syv, szv = gc.signs
    b = (al, al)
    px = ds.cadd_signed(px, _cindex(ly, b + (al, None)), szv[None, None, None, :])
    px = ds.cadd_signed(px, _cindex(lz, b + (None, al)), syv[None, None, :, None])
    px = ds.cadd_signed(px, _cindex(pt, b + (None, None)), gc.syz[None, None])
    py = ds.cadd_signed(py, _cindex(lx, b + (al, None)), szv[None, None, None, :])
    # K12 reads every plane along its last axis.  The card's kernels write
    # their outputs in order; the CPU's eager ops keep py and pz transposed
    # (z, resp. y, the outer axis), laid out in order here once per eval
    return tuple(tree_map(lambda a: a.contiguous(), p) for p in (px, py, pz))


def _g_main_half(fhs, x_pre, m_y, m_x, m_zh, cmax, w, ftail, merged=False,
                 grid_shape=None, fused=False):
    """The real main (Nyquist-free) block of the streams of a node batch:
    the y/x complex contractions on the half-z spectrum, then the real_out
    half-depth z contraction.  ``fused="3"`` runs all three stages in one K9
    launch; ``"12"`` the y and x stages in one K10 launch (z-blocked), then
    the half-z stage through K8.  Both are bitwise equal to the staged K8
    chain."""
    if fused == "3":
        return _k9.gmain3_nodemat(x_pre, m_y, m_x, m_zh, grid_shape, cmax=cmax, w=w,
                                  fold_tail=ftail)
    ck = partial(_k8.contract_last_oz_nodemat, cmax=cmax, w=w, fold_tail=ftail)
    mok = lambda mm: merged and oz.merge_ok(mm.re.shape[-2], sm=mm.re.shape[-3], cmax=cmax, w=w)
    if fused == "12":
        t = _k10.gmain12_nodemat(x_pre, m_y, m_x, grid_shape, cmax=cmax, w=w, fold_tail=ftail)
        return ck(t, m_zh, real_out=True, merged=mok(m_zh)).re
    t = ck(fhs, m_y, repeat=True, x_pre=x_pre, merged=mok(m_y))
    t = tree_map(lambda a: a.permute(0, 3, 2, 1), t)  # (C, Ny, Nzh, Nx)
    t = ck(t, m_x, merged=mok(m_x))
    t = tree_map(lambda a: a.permute(0, 3, 1, 2), t)  # (C, Nx, Ny, Nzh)
    return ck(t, m_zh, real_out=True, merged=mok(m_zh)).re  # (C, Nx, Ny, Nz)


def _interleave(t1, t2, cut: Optional[int]):
    """Stream 1's and stream 2's per-node tables ``(G, C, ...)`` as the
    main block's launches take them: per group, ``cut`` nodes of stream 1
    then the same nodes of stream 2, cut after cut (``None``: all ``C`` at
    once), ``(G, 2 C, ...)``.  The launch for nodes ``[j0, j1)`` reads rows
    ``[2 j0, 2 j1)``."""
    def one(a, b):
        g, c = a.shape[:2]
        k = c if cut is None else cut
        if c % k:
            cuts = [slice(j, min(j + k, c)) for j in range(0, c, k)]
            return torch.cat([t for s in cuts for t in (a[:, s], b[:, s])], dim=1)
        rest = tuple(a.shape[2:])
        split = lambda t: t.reshape((g, c // k, k) + rest)
        return torch.stack((split(a), split(b)), dim=2).reshape((g, 2 * c) + rest)

    return tree_map(one, t1, t2)


def _rev_v(a):
    """Physical velocity reversal ``v -> -v`` on the last three axes (the
    index flip ``j -> N-1-j`` of the cell-centered grid)."""
    return torch.flip(a, (-3, -2, -1))


def _g1_from_g2(r2: DS, w: DS) -> DS:
    """Stream-1 weighted main block from stream 2's, ``g1(v) = g2(-v)``:
    exact only for centrally symmetric f (the opt-in ``g1_reversal``)."""
    rev = DS(_rev_v(r2.hi), _rev_v(r2.lo))
    wb = DS(w.hi[:, None, None, None], w.lo[:, None, None, None])
    return ds.mul(rev, wb)


def _gmain_mode(cfg: CollisionConfig, pre: DsPrecomp, cmax: int, w: int,
                forced: bool = False, device=None):
    """Auto fused-main-block mode: ``"3"`` (K9), ``"12"`` (K10, then the
    half-z stage through K8) or ``False`` (the staged K8 chain).

    On CUDA with merged exactness on the y and x stages (``forced`` skips
    both tests and takes "12" past the envelope): K9 where a node's volume is
    under the JAX package's measured TPU VMEM envelope (45.6 MB at 64^3,
    kept under 12 MB: grids up to ~40^3) and the half-z stage merges too;
    above it K10, where its plan fits without cutting the slices into column
    groups (``kernels.oz_gmain12.plan``).  The K10 branch is the card's:
    paired runs of the whole 64^3 eval on an NVIDIA H100 80GB HBM3 put
    ``"12"`` ahead of the staged chain in wall and device time; at 32^3
    K9, K10 and the staged chain tie within the host's spread, so the
    envelope stays."""
    nx, ny, nz = cfg.grid_shape
    sm = pre.pm1[0].re.shape[-3]
    if not forced:
        if device is None or torch.device(device).type != "cuda":
            return False
        for k in (ny, nx):
            if not oz.merge_ok(k, sm=sm, cmax=cmax, w=w):
                return False
    est3 = 45.6 * (nx * ny * nz) / (64**3)
    if est3 <= 12.0 and (forced or oz.merge_ok(nz // 2, sm=sm, cmax=cmax, w=w)):
        return "3"
    if forced:
        return "12"
    p = _k10.plan(nx, ny, nz // 2, 1, oz.DEFAULT_SLICES_X, 7 if cmax < 7 else 8)
    return "12" if p.fits and p.lg == (ny, nx) else False


def _ds_sum_last(x: DS) -> DS:
    """Compensated pairwise sum over the last axis (fixed tree order)."""
    cur = x
    n = cur.hi.shape[-1]
    while n > 1:
        m = n // 2
        s = ds.add(tree_map(lambda t: t[..., :m], cur), tree_map(lambda t: t[..., m:2 * m], cur))
        if n % 2:
            s = tree_map(lambda u, v: torch.cat((u, v), dim=-1), s,
                         tree_map(lambda t: t[..., 2 * m:], cur))
            n = m + 1
        else:
            n = m
        cur = s
    return tree_map(lambda t: t[..., 0], cur)


def _fwd_herm_half(s: DS, ck, m_xy, m_zh, szv):
    """Forward transform of a REAL field onto the Hermitian half-z spectrum:
    ``(main, q)`` with ``q = sum_z s (-1)^z`` the real z-Nyquist line sum."""
    mx, my = m_xy
    u = ck(ds.cds_from_real(s), m_zh, real_in=True)  # (..., Nx, Ny, Nzh)
    u = ds._swap_last2(ck(ds._swap_last2(u), my))
    u = ds._roll_axis(ck(ds._roll_axis(u, -3, -1), mx), -1, -3)
    q = _ds_sum_last(DS(s.hi * szv, s.lo * szv))
    return u, q


def _fwd2_batched(q: DS, ck, m_xy) -> CDS:
    """Batched 2-D forward transform of real fields (the Nyquist planes)."""
    mx, my = m_xy
    p = ck(ds.cds_from_real(q), my, real_in=True)
    return ds._swap_last2(ck(ds._swap_last2(p), mx))


def _cds_sum_first(x: CDS) -> CDS:
    """Compensated pairwise sum over the first axis (fixed tree order)."""
    cur = x
    n = cur.re.hi.shape[0]
    while n > 1:
        m = n // 2
        s = ds.cadd(tree_map(lambda t: t[:m], cur), tree_map(lambda t: t[m:2 * m], cur))
        if n % 2:
            s = tree_map(lambda u, v: torch.cat((u, v), dim=0), s, tree_map(lambda t: t[2 * m:], cur))
            n = m + 1
        else:
            n = m
        cur = s
    return tree_map(lambda t: t[0], cur)


def _inv_herm_half(u: CDS, p: CDS, ck, m_xy, m_zh, inv_nz: DS, szv) -> DS:
    """``Re(IFFT3(.))`` of a Hermitian spectrum given as the half-z main
    block and the z-Nyquist plane; ``inv_nz`` is 1/Nz, exactly split."""
    mx, my = m_xy
    u = ds._swap_last2(ck(ds._swap_last2(u), my))
    u = ds._roll_axis(ck(ds._roll_axis(u, -3, -1), mx), -1, -3)
    main = ck(u, m_zh, real_out=True).re
    p = ck(p, my)
    pr = ds._swap_last2(ck(ds._swap_last2(p), mx, real_out=True)).re
    pr = ds.mul(pr, inv_nz)
    return ds.add_signed(main, DS(pr.hi[..., None], pr.lo[..., None]), szv)


def collide_ds(
    cfg: CollisionConfig, pre: DsPrecomp, f: DS, sub_batch: int = 2,
    contract: str = "vpu",
    gain_reduce: Optional[Callable[[CDS], CDS]] = None,
    oz_cmax: Optional[int] = None,
    preslice: bool = True,
    g_stream: Optional[str] = None,
    herm_downstream: Optional[bool] = None,
    group_batch: Optional[int] = None,
    oz_merge: Optional[bool] = None,
    gmain_fused=None,
    g1_reversal: Optional[bool] = None,
) -> DS:
    """Q(f, f) in double-single arithmetic; ``f`` is a DS on the precomp's
    device (split a host float64 array with :func:`ds.from_f64`).  The
    arguments are ``boltzfft.ds_operator.collide_ds``'s:

    ``sub_batch``: nodes of a radial group in flight at once (gb = 1).
    ``contract``: ``"vpu"`` (compensated rank-1 updates, plain PyTorch) or
    ``"oz"``/``"ozk"`` (the Ozaki engine: K7-K12 on CUDA, their plain
    versions on the CPU).  ``gain_reduce``: a hook on the gain spectrum
    before the final inverse.  ``oz_cmax``: Ozaki retention (call > cfg >
    6).  ``preslice``: cut f_hat's chunks once per eval (K7; on the CPU only
    when the fused main block is forced, and not for the full streams).
    ``g_stream``: ``"half"`` (the exact Nyquist-block decomposition: K9/K10
    or K8, then K12) or ``"full"`` (the direct complex streams: per-node
    matrices through K8, or K8's phased mode for tables built with
    ``node_mats=False``, then K11).  ``herm_downstream``: the
    half path's Hermitian finale (auto: grids <= 32 per axis, the TPU's
    measured crossover, kept as the starting rule until measured on the
    card).  ``group_batch``: radial groups per launch set (auto:
    :func:`default_group_batch`).  ``oz_merge``: K-merged stages where
    :func:`oz.merge_ok` holds (default on).  ``gmain_fused``: ``"3"`` (K9),
    ``"12"`` (K10, then the half-z stage through K8), ``False`` (staged K8),
    ``True`` (by size: "3" up to ~40^3, "12" above), None (auto,
    :func:`_gmain_mode`: the same on CUDA where the stages allow it).  ``g1_reversal``: opt-in stream-1 reuse, exact
    only for centrally symmetric f."""
    dev = f.hi.device
    on_cuda = dev.type == "cuda"
    ns = cfg.ns_eff
    sb = min(ns, sub_batch) if sub_batch else ns
    slw, _, cmax_def = _pipeline_slicing(cfg)
    if oz_cmax is None:
        oz_cmax = getattr(cfg, "oz_cmax", None)
    cmax = cmax_def if oz_cmax is None else oz_cmax
    ftail = DS_PIPELINE_FOLD_TAIL
    mg = DS_PIPELINE_MERGE if oz_merge is None else bool(oz_merge)
    mok = lambda mm: mg and oz.merge_ok(mm.re.shape[-2], sm=mm.re.shape[-3], cmax=cmax, w=slw)
    if contract in ("oz", "ozk"):
        tf_fwd = partial(oz.transform3_oz, m=pre.vfwd_sl, cmax=cmax, w=slw, fold_tail=ftail)
        tf_inv = partial(oz.transform3_oz, m=pre.vinv_sl, cmax=cmax, w=slw, fold_tail=ftail)
    elif contract == "vpu":
        tf_fwd = partial(ds.transform3, m=pre.vfwd)
        tf_inv = partial(ds.transform3, m=pre.vinv)
    else:
        raise ValueError(f"unknown ds contract engine: {contract!r}")
    f_hat = tf_fwd(ds.cds_from_real(f), real_in=True)

    phased = contract in ("oz", "ozk")
    nodemat = phased and pre.pm1 is not None
    gs = default_g_stream(contract, dev) if g_stream is None else g_stream
    half = gs == "half" and nodemat and pre.pmz_half1w is not None
    if g_stream == "half" and not half:
        raise ValueError(
            "g_stream='half' needs an oz/ozk engine with node_mats tables on an all-even grid"
        )
    fhs = f_pre_h = signs = corr1 = corr2 = None
    fuse3 = False
    gb = 1
    if group_batch is not None and group_batch > 1 and not half:
        raise ValueError(
            "group_batch > 1 applies to the half-spectrum path only (oz/ozk engine "
            "with g_stream='half'); it would be silently ignored here"
        )
    if g1_reversal and not half:
        raise ValueError(
            "g1_reversal applies to the half-spectrum path only (oz/ozk engine with "
            "g_stream='half'); it would be silently ignored here"
        )
    rev1 = bool(g1_reversal) and half
    herm = False
    if half:
        n_gl_tot = pre.beta1.hi.shape[0]
        gb = default_group_batch(cfg, n_gl_tot, dev) if group_batch is None else group_batch
        nxg, nyg, nzg = cfg.grid_shape
        gc = hold(_grid_consts(cfg.grid_shape, f.hi.dtype, dev))
        # main-block spectrum: half z extent, x/y Nyquist rows zeroed,
        # swapped for the y-first contraction order: (Nx, Nz/2, Ny)
        if preslice and (on_cuda or gmain_fused):
            # K7 cuts it from f_hat in one launch; the main-block entries
            # read only its chunks, so fhs is the unmasked view, for its shape
            f_pre_h = _k7.preslice_half(f_hat, gc.fmask, cmax=cmax, w=slw,
                                        merged=mok(pre.pm1[1]))
            fhs = ds._swap_last2(tree_map(lambda a: a[..., : nzg // 2], f_hat))
        else:
            fhs = ds._swap_last2(tree_map(lambda a: a[..., : nzg // 2] * gc.fmask[..., None],
                                          f_hat))
        if gmain_fused is None:
            fuse3 = _gmain_mode(cfg, pre, cmax, slw, device=dev)
        elif gmain_fused is False:
            fuse3 = False
        elif gmain_fused is True:
            fuse3 = _gmain_mode(cfg, pre, cmax, slw, forced=True)
        else:
            fuse3 = str(gmain_fused)
        if not (mg and f_pre_h is not None):
            fuse3 = False
        ckc = _corr_ck(cmax, slw, ftail)
        # stream 1 carries the per-node quadrature weight (host-folded into
        # its tables), so the Hadamard kernel sums plain products (w=None)
        corr1 = _nyq_corrections(cfg, pre, f_hat, ckc, conj=False, coef=pre.nyq_coef_w)
        corr2 = _nyq_corrections(cfg, pre, f_hat, ckc, conj=True)
        signs = gc.signs
        if herm_downstream is None:
            herm_downstream = max(cfg.grid_shape) <= 32
        herm = herm_downstream and pre.vfwd_zh_sl is not None
        nzh = nzg // 2
        _xy = lambda m: (m, m) if isinstance(m, oz.CSlicedMatrix) else (m[0], m[1])
        fwd_xy, inv_xy = _xy(pre.vfwd_sl), _xy(pre.vinv_sl)
        if herm:
            beta1h = tree_map(lambda a: a[..., :nzh], pre.beta1)
            beta1p = tree_map(lambda a: a[..., nzh], pre.beta1)
    # the full streams on the per-node matrices: f_hat's chunks cut once per
    # eval for every repeat-mode z contraction (K7; on CUDA only, where the
    # kernel consumes them: the plain version cuts the same chunks inline)
    f_pre = None
    if nodemat and not half and preslice and on_cuda:
        f_pre = _k7.preslice_rows(f_hat, cmax=cmax, w=slw, merged=mok(pre.pm1[2]))

    def group(acc, xs):
        if half and rev1:
            b1h = b1 = xs[0]
            _, mxy2, mzh2g, c1g, c2g, gwn = xs
        elif half:
            b1h = b1 = xs[0]
            _, my12, mx12, mzh12, c1g, c2g = xs
        elif nodemat:
            gw, b1, pm1, pm2 = xs
        else:
            ax, ay, az, gw, b1 = xs
        s = None
        sub_starts = range(0, ns, sb) if gb == 1 else (0,)
        for j0 in sub_starts:
            sl = slice(j0, min(j0 + sb, ns)) if gb == 1 else slice(None)
            if half:
                take = lambda t: tree_map(lambda a: a[sl], t)
                if rev1:
                    r2 = _g_main_half(fhs, f_pre_h, take(mxy2[1]), take(mxy2[0]), take(mzh2g),
                                      cmax, slw, ftail, merged=mg, grid_shape=cfg.grid_shape,
                                      fused=fuse3)
                    r1 = _g1_from_g2(r2, take(gwn))
                else:  # the sub-batch's rows of the interleaved tables (_interleave)
                    rows = slice(2 * j0, 2 * sl.stop) if gb == 1 else slice(None)
                    m_y, m_x, m_zh = (tree_map(lambda a: a[rows], m) for m in (my12, mx12, mzh12))
                    r12 = _g_main_half(fhs, f_pre_h, m_y, m_x, m_zh, cmax, slw, ftail, merged=mg,
                                       grid_shape=cfg.grid_shape, fused=fuse3)
                    c = r12.hi.shape[0] // 2
                    r1 = tree_map(lambda a: a[:c], r12)
                    r2 = tree_map(lambda a: a[c:], r12)
                # K12 adds the running sum of the earlier sub-batches itself
                s = _k12.hadamard_wsum_half(r1, take(c1g), r2, take(c2g), None,
                                            cfg.grid_shape, signs, groups=gb, acc=s)
                continue
            if phased:
                if nodemat:  # the phases folded into the per-node matrices
                    m1 = tuple(_cindex(m, sl) for m in pm1)
                    m2 = tuple(_cindex(m, sl) for m in pm2)
                    g1 = oz.transform3_oz_nodemat(f_hat, m1, cmax=cmax, w=slw, fold_tail=ftail,
                                                  x_pre=f_pre, merged=mg)
                    g2 = oz.transform3_oz_nodemat(f_hat, m2, cmax=cmax, w=slw, fold_tail=ftail,
                                                  x_pre=f_pre, merged=mg)
                else:  # K8's phased mode
                    ph = (_cindex(ax, sl), _cindex(ay, sl), _cindex(az, sl))
                    g1 = oz.transform3_oz_phased(f_hat, pre.vinv_sl, ph, conj=False, cmax=cmax,
                                                 w=slw, fold_tail=ftail)
                    g2 = oz.transform3_oz_phased(f_hat, pre.vinv_sl, ph, conj=True, cmax=cmax,
                                                 w=slw, fold_tail=ftail)
                part = _k11.hadamard_wsum(g1, g2, _cindex(gw, sl))
                s = part if s is None else ds.cadd(s, part)
                continue
            # vpu engine: a1[s, x, y, z] = ax[s, x] * ay[s, y] * az[s, z]
            a_yz = ds.cmul(_cindex(ay, (sl, slice(None), None)), _cindex(az, (sl, None, slice(None))))
            a1 = ds.cmul(_cindex(ax, (sl, slice(None), None, None)),
                         _cindex(a_yz, (slice(None), None, slice(None), slice(None))))
            t1, t2 = ds.cmul_both(a1, f_hat)
            g1 = tf_inv(t1)
            g2 = tf_inv(t2)
            h = ds.cmul(g1, g2)
            for j in range(h.re.hi.shape[0]):
                hj, wj = _cindex(h, j), _cindex(gw, j0 + j)
                s = ds.cmul_ds(hj, wj) if s is None else ds.caxpy(s, hj, wj)
        if half and herm:
            hm, q = _fwd_herm_half(s, ckc, fwd_xy, pre.vfwd_zh_sl, signs[2])
            if gb > 1:
                for g in range(gb):
                    tk = lambda t, _g=g: tree_map(lambda a: a[_g], t)
                    acc = ds.caxpy(acc, tk(hm), tk(b1h))
                return acc, q
            return ds.caxpy(acc, hm, b1h), q
        if half:
            h_hat = tf_fwd(ds.cds_from_real(s), real_in=True)
            if gb > 1:
                for g in range(gb):
                    tk = lambda t, _g=g: tree_map(lambda a: a[_g], t)
                    acc = ds.caxpy(acc, tk(h_hat), tk(b1))
                return acc, None
        else:
            h_hat = tf_fwd(s)
        return ds.caxpy(acc, h_hat, b1), None

    fdt = f.hi.dtype
    lay = None  # the half path's table layout (_interleave), per chunk of steps
    if half:
        nxg, nyg, nzg = cfg.grid_shape
        acc = ds.czeros((nxg, nyg, nzg // 2) if herm else cfg.grid_shape, fdt, dev)
        if rev1:
            xs = (beta1h if herm else pre.beta1, (pre.pm2[0], pre.pm2[1]), pre.pmz_half2,
                  corr1, corr2, pre.gain_w)
        else:
            xs = (beta1h if herm else pre.beta1, (pre.pm1[0], pre.pm1[1]),
                  (pre.pm2[0], pre.pm2[1]), pre.pmz_half1w, pre.pmz_half2, corr1, corr2)
        n_gl = xs[0].hi.shape[0]
        if gb > 1:
            # fold gb radial groups into each step: beta1 gains a (gb,) axis,
            # node-carrying tables merge the group axis into the node axis
            # (group-major: the K12 group windows and the accumulation order
            # match the gb = 1 sequence)
            if n_gl % gb:
                raise ValueError(f"group_batch={gb} must divide the radial group count {n_gl}")
            grp = lambda t: tree_map(lambda a: a.reshape((n_gl // gb, gb) + tuple(a.shape[1:])), t)
            nod = lambda t: tree_map(
                lambda a: a.reshape((n_gl // gb, gb * a.shape[1]) + tuple(a.shape[2:])), t)
            xs = (grp(xs[0]),) + tuple(nod(t) for t in xs[1:])
        if not rev1:
            # each main-block launch reads one table of both streams' nodes:
            # laid out once per chunk of radial steps, a launch takes its rows
            cut = min(ns, sb) if gb == 1 else None
            lay = lambda x: (x[0], _interleave(x[1][1], x[2][1], cut),
                             _interleave(x[1][0], x[2][0], cut), _interleave(x[3], x[4], cut),
                             x[5], x[6])
    elif nodemat:
        acc = ds.czeros(cfg.grid_shape, fdt, dev)
        xs = (pre.gain_w, pre.beta1, pre.pm1, pre.pm2)
    else:
        acc = ds.czeros(cfg.grid_shape, fdt, dev)
        xs = (pre.ax, pre.ay, pre.az, pre.gain_w, pre.beta1)
    n_steps = pre.gain_w.hi.shape[0] // gb
    qs = []
    step = LAYOUT_STEPS if lay else max(n_steps, 1)
    for r0 in range(0, n_steps, step):
        xc = tree_map(lambda a: a[r0:r0 + step], xs)
        xc = lay(xc) if lay else xc
        for r in range(min(step, n_steps - r0)):  # the JAX package's lax.scan over radial groups
            acc, q = group(acc, tree_map(lambda a: a[r], xc))
            qs.append(q)
    q_gain_hat = acc

    if half and herm:
        # Hermitian finale: gain and loss ride one half-z main + Nyquist-plane
        # inverse, stacked on a leading axis
        am = q_gain_hat
        qs = tree_map(lambda *a: torch.stack(a), *qs)
        if gb > 1:
            qs = tree_map(lambda a: a.reshape((-1,) + tuple(a.shape[2:])), qs)
        ap = _cds_sum_first(ds.cmul_ds(_fwd2_batched(qs, ckc, fwd_xy), beta1p))
        if gain_reduce is not None:
            am, ap = gain_reduce(am), gain_reduce(ap)
        b2h = tree_map(lambda a: a[..., :nzh], pre.beta2)
        b2p = tree_map(lambda a: a[..., nzh], pre.beta2)
        fh = tree_map(lambda a: a[..., :nzh], f_hat)
        fp = tree_map(lambda a: a[..., nzh], f_hat)
        stk = lambda a, b: tree_map(lambda x, y: torch.stack((x, y)), a, b)
        inv = _inv_herm_half(stk(am, ds.cmul_ds(fh, b2h)), stk(ap, ds.cmul_ds(fp, b2p)),
                             ckc, inv_xy, pre.vinv_zh_sl, gc.inv_nz, signs[2])
        q_gain = tree_map(lambda a: a[0], inv)
        loss = tree_map(lambda a: a[1], inv)
        return ds.sub_mul(q_gain, loss, f)

    if gain_reduce is not None:
        q_gain_hat = gain_reduce(q_gain_hat)
    both = tree_map(lambda a, b: torch.stack((a, b)), q_gain_hat, ds.cmul_ds(f_hat, pre.beta2))
    inv = tf_inv(both, real_out=True).re
    q_gain = tree_map(lambda a: a[0], inv)
    loss = tree_map(lambda a: a[1], inv)
    return ds.sub_mul(q_gain, loss, f)


def default_contract(device="cuda") -> str:
    """``collide_ds``'s engine by device: the Ozaki kernels on CUDA, the
    plain vpu engine elsewhere (the JAX package's TPU/other split)."""
    return "oz" if torch.device(device).type == "cuda" else "vpu"


def default_group_batch(cfg: CollisionConfig, n_gl: int, device="cuda") -> int:
    """``group_batch`` auto rule (half path): the largest divisor of ``n_gl``
    up to 2 on grids <= 32 per axis on CUDA, else 1; 1 off CUDA.  Measured
    on a TPU (gb = 2 won 6-8% at 16^3-32^3 there); the port's starting rule
    until it is measured on the card."""
    if torch.device(device).type != "cuda":
        return 1
    target = 2 if max(cfg.grid_shape) <= 32 else 1
    gb = 1
    for d in range(1, n_gl + 1):
        if n_gl % d == 0 and d <= target:
            gb = d
    return gb


def default_g_stream(contract: str, device="cuda") -> str:
    """Default g stream of the oz engines: ``"half"`` on CUDA (the TPU's
    measured default, kept as the starting rule), ``"full"`` elsewhere, as
    in the JAX package."""
    return "half" if torch.device(device).type == "cuda" else "full"


def make_ds_collision_operator(
    cfg: CollisionConfig, jit: bool = True, dtype=torch.float32,
    sub_batch: int = 2, contract: Optional[str] = None,
    oz_cmax: Optional[int] = None, g_stream: Optional[str] = None,
    group_batch: Optional[int] = None, oz_merge: Optional[bool] = None,
    gmain_fused=None, g1_reversal: Optional[bool] = None, *, device="cuda",
) -> Tuple[Callable[[DS, DsPrecomp], DS], DsPrecomp]:
    """Build ``(collide_fn, ds_precomp)`` on ``device`` (CUDA unless the
    caller asks for the CPU); ``collide_fn(f_ds, pre) -> Q_ds``.  A plain
    tensor ``f`` is promoted with :func:`ds.from_float`.

    ``jit=True`` on CUDA replays the eval from a CUDA graph
    (:class:`boltzfft_torch._graph.Replayed`), the card's counterpart of the
    JAX package's ``jax.jit``: the first call per precomp and f shape runs
    one eager eval, then captures one; every call returns a fresh Q with the
    eager eval's bits.  A failed capture raises.  The arithmetic stays eager
    PyTorch and the hand-written kernels (no compiler may contract the
    EFTs).  On the CPU ``jit`` changes nothing."""
    device = torch.device(device)
    collide_fn = ds_collide_fn(
        cfg, jit, dtype, sub_batch, contract, oz_cmax, g_stream, group_batch, oz_merge,
        gmain_fused, g1_reversal, device=device,
    )
    return collide_fn, build_ds_precomp(cfg, dtype, device=device)


def ds_collide_fn(
    cfg: CollisionConfig, jit: bool = True, dtype=torch.float32,
    sub_batch: int = 2, contract: Optional[str] = None,
    oz_cmax: Optional[int] = None, g_stream: Optional[str] = None,
    group_batch: Optional[int] = None, oz_merge: Optional[bool] = None,
    gmain_fused=None, g1_reversal: Optional[bool] = None, *, device="cuda",
) -> Callable[[DS, DsPrecomp], DS]:
    """:func:`make_ds_collision_operator`'s ``collide_fn`` alone, for tables
    built once elsewhere (``autotune_ds`` times one per ``sub_batch`` on one
    ``DsPrecomp``).  Each call makes its own graph cache under ``jit=True``
    on CUDA: a graph is keyed by the precomp and the shapes only, so two
    operators that differ in their arguments must not share one."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but torch.cuda.is_available() is False")
    fn = partial(
        collide_ds, cfg, sub_batch=sub_batch, contract=contract or default_contract(device),
        oz_cmax=oz_cmax, g_stream=g_stream, group_batch=group_batch, oz_merge=oz_merge,
        gmain_fused=gmain_fused, g1_reversal=g1_reversal,
    )
    def run(f, precomp):
        with obs.span("collide", like=f.hi):
            return fn(precomp, f)

    if jit and device.type == "cuda":
        run = Replayed(run, "collide_ds")

    def collide_fn(f, precomp):
        if not isinstance(f, DS):
            f = ds.from_float(torch.as_tensor(f, dtype=dtype, device=device))
        return run(f, precomp)

    return collide_fn


# ---------------------------------------------------------------------------
# several devices: radial-group sharding with a compensated fold across ranks
# ---------------------------------------------------------------------------

#: The tables with one row per radial group (sharded); the rest are whole.
_RADIAL_FIELDS = ("ax", "ay", "az", "gain_w", "beta1", "pm1", "pm2", "pmz_half2", "nyq_coef",
                  "pmz_half1w", "nyq_coef_w")


def _pad_radial(pre: DsPrecomp, n_groups: int) -> DsPrecomp:
    """Pad the leading radial axis to ``n_groups`` with zero groups: their
    ``gain_w = 0``, so they add exactly nothing to the gain sum (their
    phase and beta1 rows are zeros, finite and unused)."""
    have = pre.gain_w.hi.shape[0]
    if n_groups == have:
        return pre

    def pad(a):
        return torch.cat([a, a.new_zeros((n_groups - have,) + tuple(a.shape[1:]))])

    return pre._replace(**{k: tree_map(pad, getattr(pre, k)) for k in _RADIAL_FIELDS})


def _radial_rows(pre: DsPrecomp, n: int, k: int) -> DsPrecomp:
    g = pre.gain_w.hi.shape[0]
    if g % n:
        raise ValueError(f"{g} radial groups do not divide over {n} shards")
    s = slice(k * (g // n), (k + 1) * (g // n))
    return pre._replace(**{f: tree_map(lambda a: a[s], getattr(pre, f)) for f in _RADIAL_FIELDS})


def place_ds(pre: DsPrecomp, mesh, radial_axis: Optional[str] = "node") -> DsPrecomp:
    """This rank's ds tables on its device: its shard of the radial groups
    along ``radial_axis`` (``None``: all of them); the shared tables whole."""
    from . import sharding as _sh

    dev = _sh.mesh_device(mesh)
    if pre.gain_w.hi.device != dev:
        pre = tree_map(lambda a: a.to(dev), pre)
    return _radial_rows(pre, _sh.axis_size(mesh, radial_axis), _sh.axis_index(mesh, radial_axis))


def _folded_gather(group, n: int) -> Callable[[CDS], CDS]:
    """The cross-rank gain reduction: one ``all_gather`` of the four float32
    parts of every rank's partial spectrum, folded with ``ds.cadd`` in rank
    order (deterministic, ~49 bits, the same on every rank).  A float32
    ``all_reduce`` would round the pairs back to 2^-24."""
    import torch.distributed as dist

    def reduce(q: CDS) -> CDS:
        mine = torch.stack((q.re.hi, q.re.lo, q.im.hi, q.im.lo))
        parts = [torch.empty_like(mine) for _ in range(n)]
        dist.all_gather(parts, mine, group=group)
        as_cds = lambda p: CDS(DS(p[0], p[1]), DS(p[2], p[3]))
        acc = as_cds(parts[0])
        for p in parts[1:]:
            acc = ds.cadd(acc, as_cds(p))
        return acc

    return reduce


def make_sharded_ds_collision_operator(
    cfg: CollisionConfig,
    mesh,
    radial_axis: Optional[str] = "node",
    ensemble_axis: Optional[str] = None,
    jit: bool = True,
    dtype=torch.float32,
    sub_batch: int = 2,
    contract: Optional[str] = None,
    oz_cmax: Optional[int] = None,
    g_stream: Optional[str] = None,
    herm_downstream: Optional[bool] = None,
    group_batch: Optional[int] = None,
    oz_merge: Optional[bool] = None,
    gmain_fused=None,
    g1_reversal: Optional[bool] = None,
) -> Tuple[Callable[[DS, DsPrecomp], DS], DsPrecomp]:
    """ds collision evals sharded over ``mesh``, on this rank's device.

    The radial quadrature groups spread over ``radial_axis`` (the ds group
    loop runs over them).  The cross-rank gain reduction is
    :func:`_folded_gather` through ``collide_ds(gain_reduce=)``.
    ``ensemble_axis`` also shards a leading ensemble axis of ``f`` (this
    rank's block, no communication).  Returns ``(collide_fn, precomp)``
    with the radial tables padded to shard evenly; ``collide_fn`` takes the
    padded tables or this rank's :func:`place_ds` shard.

    The other arguments go to :func:`collide_ds` on every rank.  Its auto
    rules see the rank's radial group count, so ``group_batch``'s may
    differ from the unsharded operator's: pass it to compare the two.
    ``jit=True`` on CUDA replays the eval from a CUDA graph (an NCCL
    ``all_gather`` is captured with it; a gloo one raises: pass
    ``jit=False``).  On the CPU ``jit`` changes nothing."""
    from . import sharding as _sh

    if radial_axis is None and ensemble_axis is None:
        raise ValueError("need at least one of radial_axis/ensemble_axis")
    device = _sh.mesh_device(mesh)
    n_shards = _sh.axis_size(mesh, radial_axis)
    _sh.axis_size(mesh, ensemble_axis)
    pre = build_ds_precomp(cfg, dtype, device=device)
    n_gl = pre.gain_w.hi.shape[0]
    pre = _pad_radial(pre, -(-n_gl // n_shards) * n_shards)
    n_global = pre.gain_w.hi.shape[0]
    group = mesh.get_group(radial_axis) if radial_axis and n_shards > 1 else None
    reducer = _folded_gather(group, n_shards) if group is not None else None
    one = partial(
        collide_ds, cfg, sub_batch=sub_batch, contract=contract or default_contract(device),
        gain_reduce=reducer, oz_cmax=oz_cmax, g_stream=g_stream,
        herm_downstream=herm_downstream, group_batch=group_batch, oz_merge=oz_merge,
        gmain_fused=gmain_fused, g1_reversal=g1_reversal,
    )

    def body(f, p):
        with obs.span("collide", like=f.hi):
            if ensemble_axis is None:
                return one(p, f)
            qs = [one(p, tree_map(lambda a, i=i: a[i], f)) for i in range(f.hi.shape[0])]
            return tree_map(lambda *a: torch.stack(a), *qs)

    run = body
    if jit and device.type == "cuda":
        run = _sh._replay(body, [group], "make_sharded_ds_collision_operator",
                          "sharded_collide_ds")
    shards = {}  # id of a padded global precomp -> (it, this rank's shard)

    def local(p):
        g = p.gain_w.hi.shape[0]
        if g == n_global // n_shards:
            return p
        if g != n_global:
            raise ValueError(
                f"ds precomp with {g} radial groups: expected the sharded operator's "
                f"{n_global} or this rank's {n_global // n_shards}")
        hit = shards.get(id(p))
        if hit is None or hit[0] is not p:
            hit = shards[id(p)] = (p, place_ds(p, mesh, radial_axis))
            while len(shards) > 2:
                shards.pop(next(iter(shards)))
        return hit[1]

    def collide_fn(f, precomp):
        if not isinstance(f, DS):
            f = ds.from_float(torch.as_tensor(f, dtype=dtype, device=device))
        return run(f, local(precomp))

    return collide_fn, pre
