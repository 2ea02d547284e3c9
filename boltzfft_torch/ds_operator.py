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

The sharded operator waits for the multi-device slice.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import ds
from . import modes as _modes
from . import oz
from . import quadrature as _quad
from . import weights as _weights
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


def _f32(a, device):
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def _nyq_corrections(cfg, pre, f_hat, ck, conj: bool, coef=None):
    """Coefficient-folded Nyquist-block correction fields of one g stream for
    all nodes: the three plane CDS fields (leading (n_gl, ns)) with the
    line and point blocks folded in (``boltzfft.ds_operator._nyq_corrections``)."""
    nx, ny, nz = cfg.grid_shape
    hx, hy, hz = nx // 2, ny // 2, nz // 2
    dev = f_hat.re.hi.device
    kx, ky, kz = (_f32(np.arange(n) != h, dev) for n, h in ((nx, hx), (ny, hy), (nz, hz)))
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

    px = plane((hx,), ky[:, None] * kz[None, :], ay, az, vz, vy, coef[0])
    py = plane((al, hy), kx[:, None] * kz[None, :], ax, az, vz, vx, coef[1])
    pz = plane((al, al, hz), kx[:, None] * ky[None, :], ax, ay, vy, vx, coef[2])

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
    # patterns, compensated adds):
    #   g = r_main + sx(jx).px'(jy,jz) + sy(jy).py'(jx,jz) + sz(jz).pz(jx,jy)
    syv = _f32((-1.0) ** np.arange(ny), dev)
    szv = _f32((-1.0) ** np.arange(nz), dev)
    expand = lambda t, idx, pat: tree_map(lambda a: a[idx] * pat, t)
    b = (al, al)
    px = ds.cadd(px, expand(ly, b + (al, None), szv[None, None, None, :]))
    px = ds.cadd(px, expand(lz, b + (None, al), syv[None, None, :, None]))
    px = ds.cadd(px, expand(pt, b + (None, None), (syv[:, None] * szv[None, :])[None, None]))
    py = ds.cadd(py, expand(lx, b + (al, None), szv[None, None, None, :]))
    return (px, py, pz)


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
    paired runs of the whole 64^3 eval (``chip_smoke.py`` phase 20)
    put ``"12"`` ahead of the staged chain in wall and device time; at 32^3
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


def _inv_herm_half(u: CDS, p: CDS, ck, m_xy, m_zh, nz: int, szv) -> DS:
    """``Re(IFFT3(.))`` of a Hermitian spectrum given as the half-z main
    block and the z-Nyquist plane."""
    mx, my = m_xy
    u = ds._swap_last2(ck(ds._swap_last2(u), my))
    u = ds._roll_axis(ck(ds._roll_axis(u, -3, -1), mx), -1, -3)
    main = ck(u, m_zh, real_out=True).re
    p = ck(p, my)
    pr = ds._swap_last2(ck(ds._swap_last2(p), mx, real_out=True)).re
    # 1/Nz as an exactly split ds constant
    pr = ds.mul(pr, ds.from_f64(np.float64(1.0) / nz, pr.hi.dtype, pr.hi.device))
    corr = DS(pr.hi[..., None] * szv, pr.lo[..., None] * szv)
    return ds.add(main, corr)


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
        hx, hy = nxg // 2, nyg // 2
        kxm = _f32(np.arange(nxg) != hx, dev)
        kym = _f32(np.arange(nyg) != hy, dev)
        fmask = kxm[:, None, None] * kym[None, :, None]
        # main-block spectrum: half z extent, x/y Nyquist rows zeroed,
        # pre-swapped once for the y-first contraction order
        f_main = tree_map(lambda a: a[..., : nzg // 2] * fmask, f_hat)
        fhs = ds._swap_last2(f_main)  # (Nx, Nz/2, Ny)
        if preslice and (on_cuda or gmain_fused):
            f_pre_h = _k7.preslice_rows(fhs, cmax=cmax, w=slw, merged=mok(pre.pm1[1]))
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
        signs = tuple(_f32((-1.0) ** np.arange(n), dev) for n in (nxg, nyg, nzg))
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
            _, mxy1, mxy2, mzh1g, mzh2g, c1g, c2g = xs
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
                else:
                    cat = lambda a, b: tree_map(lambda x, y: torch.cat((x, y)), a, b)
                    r12 = _g_main_half(
                        fhs, f_pre_h,
                        cat(take(mxy1[1]), take(mxy2[1])),
                        cat(take(mxy1[0]), take(mxy2[0])),
                        cat(take(mzh1g), take(mzh2g)),
                        cmax, slw, ftail, merged=mg, grid_shape=cfg.grid_shape, fused=fuse3,
                    )
                    c = r12.hi.shape[0] // 2
                    r1 = tree_map(lambda a: a[:c], r12)
                    r2 = tree_map(lambda a: a[c:], r12)
                part = _k12.hadamard_wsum_half(r1, take(c1g), r2, take(c2g), None,
                                               cfg.grid_shape, signs, groups=gb)
                s = part if s is None else ds.add(s, part)
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
                term = ds.cmul_ds(_cindex(h, j), _cindex(gw, j0 + j))
                s = term if s is None else ds.cadd(s, term)
        if half and herm:
            hm, q = _fwd_herm_half(s, ckc, fwd_xy, pre.vfwd_zh_sl, signs[2])
            if gb > 1:
                for g in range(gb):
                    tk = lambda t, _g=g: tree_map(lambda a: a[_g], t)
                    acc = ds.cadd(acc, ds.cmul_ds(tk(hm), tk(b1h)))
                return acc, q
            return ds.cadd(acc, ds.cmul_ds(hm, b1h)), q
        if half:
            h_hat = tf_fwd(ds.cds_from_real(s), real_in=True)
            if gb > 1:
                for g in range(gb):
                    tk = lambda t, _g=g: tree_map(lambda a: a[_g], t)
                    acc = ds.cadd(acc, ds.cmul_ds(tk(h_hat), tk(b1)))
                return acc, None
        else:
            h_hat = tf_fwd(s)
        return ds.cadd(acc, ds.cmul_ds(h_hat, b1)), None

    fdt = f.hi.dtype
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
    elif nodemat:
        acc = ds.czeros(cfg.grid_shape, fdt, dev)
        xs = (pre.gain_w, pre.beta1, pre.pm1, pre.pm2)
    else:
        acc = ds.czeros(cfg.grid_shape, fdt, dev)
        xs = (pre.ax, pre.ay, pre.az, pre.gain_w, pre.beta1)
    n_steps = pre.gain_w.hi.shape[0] // gb
    qs = []
    for r in range(n_steps):  # the JAX package's lax.scan over radial groups
        acc, q = group(acc, tree_map(lambda a: a[r], xs))
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
                             ckc, inv_xy, pre.vinv_zh_sl, nzg, signs[2])
        q_gain = tree_map(lambda a: a[0], inv)
        loss = tree_map(lambda a: a[1], inv)
        return ds.sub(q_gain, ds.mul(loss, f))

    if gain_reduce is not None:
        q_gain_hat = gain_reduce(q_gain_hat)
    both = tree_map(lambda a, b: torch.stack((a, b)), q_gain_hat, ds.cmul_ds(f_hat, pre.beta2))
    inv = tf_inv(both, real_out=True).re
    q_gain = tree_map(lambda a: a[0], inv)
    loss = tree_map(lambda a: a[1], inv)
    return ds.sub(q_gain, ds.mul(loss, f))


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
    tensor ``f`` is promoted with :func:`ds.from_float`.  ``jit`` is accepted
    for the JAX signature and ignored: PyTorch runs eagerly, which the ds
    arithmetic needs (no compiler may contract its EFTs)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but torch.cuda.is_available() is False")
    pre = build_ds_precomp(cfg, dtype, device=device)
    fn = partial(
        collide_ds, cfg, sub_batch=sub_batch, contract=contract or default_contract(device),
        oz_cmax=oz_cmax, g_stream=g_stream, group_batch=group_batch, oz_merge=oz_merge,
        gmain_fused=gmain_fused, g1_reversal=g1_reversal,
    )

    def collide_fn(f, precomp):
        if not isinstance(f, DS):
            f = ds.from_float(torch.as_tensor(f, dtype=dtype, device=device))
        return fn(precomp, f)

    return collide_fn, pre
