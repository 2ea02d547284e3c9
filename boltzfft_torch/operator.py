"""The Boltzmann collision operator in PyTorch (mirror of ``boltzfft/operator.py``).

Computes ``Q(f, f) = Q_gain - Q_loss`` for the spatially homogeneous
Boltzmann equation with a VHS kernel by the fast Fourier spectral method:

  1. ``f_hat = FFT(f)``
  2. per node: ``g1 = IFFT(alpha1 f_hat)``, ``g2 = IFFT(conj(alpha1) f_hat)``,
     ``h_hat = FFT(g1 g2)``
  3. ``Q_gain = Re IFFT(sum_b w_b beta1_b h_hat_b)`` (a fixed-order sum)
  4. ``Q_loss = Re IFFT(beta2 f_hat) * f``

``impl="c2c"`` and ``"rfft"`` are the staged pipelines on ``torch.fft``
(cuFFT on the card; c2c in float64 is the port's independent oracle there).
``impl="rfft", use_pallas=True`` runs each node chunk's phase multiply in K6
(``kernels.alpha_multiply``) and its node reduction in K5
(``kernels.gain_reduce``) around the same transforms.  ``impl="dft"`` writes
every transform of a chunk as per-axis einsums against DFT matrices, with
the node phases folded into the inverse matrices (no kernel).

``impl="fused"`` takes one of these routes (``fused_scheme``; ``"auto"`` is
:func:`pick_scheme`: ``"kron"`` on y/z planes of at most 64 points, such as
8^3, and ``"ct"`` on every other grid):

* ``"ct"`` without a ``gain_reduce`` hook: the whole eval in the K1 kernel
  (``kernels.fused_collide``), differentiable through :class:`_FusedCollide`,
  whose backward is the staged c2c pipeline;
* ``"ct"`` with a hook: the gain spectrum of the whole batch in one K2 call
  (``kernels.fused_gain_dft``), then the hook, then the staged c2c finale;
* ``"transpose"``: the same with K4 (cubic grids), hook or not;
* ``"kron"``: the same with K3 (``kernels.fused_gain``), hook or not.

As in ``boltzfft``, only the first has a gradient.

:func:`make_collision_operator` with ``jit=True`` on CUDA replays the eval
from a CUDA graph (``_graph.Replayed``).  So that the capture and every
eager call take one node chunk, each route's chunk is settled at its first
use and kept in ``pre.derived`` (:func:`node_chunk`, :func:`kernel_chunk`),
as a trace settles it once in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from . import _graph, obs
from .kernels import alpha_multiply as _k6
from .kernels import fused_collide as _k1
from .kernels import fused_gain as _k3
from .kernels import gain_reduce as _k5
from .kernels.fused_gain import pick_scheme
from .weights import CollisionConfig, Precomp, build_precomp

_FFT_AXES = (-3, -2, -1)


def _alpha_factors(cfg: CollisionConfig, pre: Precomp, rho, sigma):
    """Separable per-axis phase factors of alpha1 for a chunk of nodes:
    alpha1(b, l) = exp(-i pi/(2L) rho_b (l . sigma_b)) = ax[b,lx] ay[b,ly] az[b,lz]."""
    coef = -math.pi / (2.0 * cfg.domain_length)
    cd = cfg.complex_dtype
    px = (coef * rho[:, None]) * (sigma[:, 0:1] * pre.lx[None, :])
    py = (coef * rho[:, None]) * (sigma[:, 1:2] * pre.ly[None, :])
    pz = (coef * rho[:, None]) * (sigma[:, 2:3] * pre.lz[None, :])
    ax = torch.exp(1j * px.to(cd))
    ay = torch.exp(1j * py.to(cd))
    az = torch.exp(1j * pz.to(cd))
    return ax, ay, az


def _beta1(cfg: CollisionConfig, pre: Precomp, rho):
    """Gain radial kernel beta1(b, l) = 4 pi b_gamma sincc(pi rho_b |l| / (2L)),
    eps matched to the dtype."""
    eps = float(np.finfo(cfg.dtype).eps)
    arg = (math.pi / (2.0 * cfg.domain_length)) * rho[:, None, None, None] * pre.norm_l[None]
    return (4.0 * math.pi * cfg.b_gamma) * (torch.sin(arg + eps) / (arg + eps))


def _settled(pre: Precomp, key, make):
    """``pre.derived[key]``, made by ``make()`` at its first use and kept."""
    if key not in pre.derived:
        pre.derived[key] = make()
    return pre.derived[key]


def divisor_chunk(c: int, b: int) -> int:
    """The largest divisor of the node count ``b`` that is at most ``c``."""
    c = min(c, b)
    while b % c:
        c -= 1
    return c


def node_chunk_for(cfg: CollisionConfig, device, n_nodes: Optional[int] = None) -> int:
    """The staged pipelines' nodes per chunk on ``device``: ``cfg.chunk`` of
    the device (on CUDA a share of the free memory) cut to a divisor of the
    node count (:func:`divisor_chunk`); ``n_nodes`` defaults to the padded
    count ``build_precomp`` gives (a shard passes its own rows)."""
    device = torch.device(device)
    b = cfg.n_nodes_padded(device) if n_nodes is None else n_nodes
    return divisor_chunk(cfg.chunk(device), b)


def node_chunk(cfg: CollisionConfig, pre: Precomp) -> int:
    """:func:`node_chunk_for` ``pre``'s device and rows, settled at the
    first call.  The chunk sets the order of the node sum, and the free
    memory moves between calls (a CUDA graph's pool holds some), so it is
    read once."""
    return _settled(pre, ("chunk", cfg),
                    lambda: node_chunk_for(cfg, pre.device, pre.rho.shape[0]))


def kernel_chunk(cfg: CollisionConfig, pre: Precomp, f: torch.Tensor) -> Optional[int]:
    """K1-K4's nodes per chunk for a batch of ``f``'s shape on CUDA (their
    buffers; the result's bits do not depend on it), settled at the first
    call per batch size; None on the CPU, whose plain versions take no
    chunk."""
    if pre.device.type != "cuda":
        return None
    n_batch = f.shape[0] if f.dim() == 4 else 1

    def make():
        nx, ny, nz = cfg.grid_shape
        csize = 16 if cfg.dtype == "float64" else 8
        return _k1._chunk_nodes(pre.rho.shape[0], cfg.ns_eff, n_batch, nx * ny * nz, csize,
                                pre.device)

    return _settled(pre, ("kernel chunk", cfg, n_batch), make)


def _gain_chunk(cfg: CollisionConfig, pre: Precomp, f_hat, rho, sigma, gain_w):
    """Partial gain spectrum of one chunk of nodes:
    sum_b gain_w[b] * beta1[b, l] * FFT(g1_b * g2_b)[l]."""
    if cfg.impl == "dft":
        return _gain_chunk_dft(cfg, pre, f_hat, rho, sigma, gain_w)
    if cfg.impl == "rfft" and cfg.use_pallas:
        return _gain_chunk_pallas(cfg, pre, f_hat, rho, sigma, gain_w)
    ax, ay, az = _alpha_factors(cfg, pre, rho, sigma)
    a1 = ax[:, :, None, None] * ay[:, None, :, None] * az[:, None, None, :]
    a1f = a1 * f_hat[None]
    a2f = torch.conj(a1) * f_hat[None]

    shape = cfg.grid_shape
    if cfg.impl == "rfft":
        g1 = torch.fft.irfftn(a1f, s=shape, dim=_FFT_AXES)
        g2 = torch.fft.irfftn(a2f, s=shape, dim=_FFT_AXES)
        h_hat = torch.fft.rfftn(g1 * g2, dim=_FFT_AXES)
    else:
        g1 = torch.fft.ifftn(a1f, dim=_FFT_AXES)
        g2 = torch.fft.ifftn(a2f, dim=_FFT_AXES)
        h_hat = torch.fft.fftn(g1 * g2, dim=_FFT_AXES)

    w = gain_w[:, None, None, None] * _beta1(cfg, pre, rho)
    return torch.sum(w.to(h_hat.dtype) * h_hat, dim=0)


def _gain_chunk_pallas(cfg: CollisionConfig, pre: Precomp, f_hat, rho, sigma, gain_w):
    """The rfft chunk with its phase multiply in K6 and its node reduction in
    K5; the transforms stay on ``torch.fft``.  Cubic grids only (checked by
    ``CollisionConfig``)."""
    n = cfg.nv
    nh = pre.lz.shape[0]
    m2 = n * nh
    ax, ay, az = _alpha_factors(cfg, pre, rho, sigma)
    ayz = (ay[:, :, None] * az[:, None, :]).reshape(-1, m2)  # (C, N * Nh)
    a1f, a2f = _k6.alpha_multiply(ax, ayz, f_hat.reshape(n, m2))
    shape4 = (-1, n, n, nh)
    g1 = torch.fft.irfftn(a1f.reshape(shape4), s=(n, n, n), dim=_FFT_AXES)
    g2 = torch.fft.irfftn(a2f.reshape(shape4), s=(n, n, n), dim=_FFT_AXES)
    h_hat = torch.fft.rfftn(g1 * g2, dim=_FFT_AXES)
    q = _k5.gain_reduce(
        h_hat.reshape(rho.shape[0], -1), rho, gain_w, pre.norm_l.reshape(-1),
        length=cfg.domain_length, b_gamma=cfg.b_gamma,
    )
    return q.reshape(n, n, nh)


def _gain_chunk_dft(cfg: CollisionConfig, pre: Precomp, f_hat, rho, sigma, gain_w):
    """The chunk with every transform as per-axis einsums on (re, im) planes.
    Each complex contraction is three real ones (p1 = Mr Tr, p2 = Mi Ti,
    p3 = (Mr + Mi)(Tr + Ti); re = p1 - p2, im = p3 - p1 - p2), and the
    inverse of node b contracts with V diag(a_b) per axis, its phase folded
    into the matrix, so the phased spectra are never formed."""
    ax, ay, az = _alpha_factors(cfg, pre, rho, sigma)

    def cmatmul(spec, mr, mi, tr, ti):
        p1 = torch.einsum(spec, mr, tr)
        p2 = torch.einsum(spec, mi, ti)
        p3 = torch.einsum(spec, mr + mi, tr + ti)
        return p1 - p2, p3 - p1 - p2

    def inverse(conj: bool):
        mats = []
        for v, a in zip(pre.dft_inv_axes(), (ax, ay, az)):
            m = torch.complex(v[0], v[1])[None] * (a.conj() if conj else a)[:, None, :]
            mats.append((m.real, m.imag))
        (xr, xi), (yr, yi), (zr, zi) = mats
        sr, si = cmatmul("cxm,mjk->cxjk", xr, xi, f_hat.real, f_hat.imag)
        sr, si = cmatmul("cyn,cxnk->cxyk", yr, yi, sr, si)
        return cmatmul("czp,cxyp->cxyz", zr, zi, sr, si)

    g1r, g1i = inverse(False)
    g2r, g2i = inverse(True)
    hr = g1r * g2r - g1i * g2i
    hi = g1r * g2i + g1i * g2r
    (xr, xi), (yr, yi), (zr, zi) = pre.dft_fwd_axes()
    hr, hi = cmatmul("xm,cmjk->cxjk", xr, xi, hr, hi)
    hr, hi = cmatmul("yn,cxnk->cxyk", yr, yi, hr, hi)
    hr, hi = cmatmul("zp,cxyp->cxyz", zr, zi, hr, hi)
    w = gain_w[:, None, None, None] * _beta1(cfg, pre, rho)
    return torch.complex(torch.sum(w * hr, dim=0), torch.sum(w * hi, dim=0))


def fused_scheme(cfg: CollisionConfig) -> str:
    """The configuration's fused route: ``cfg.fused_scheme`` or, for
    ``"auto"``, :func:`pick_scheme` of its grid."""
    if cfg.fused_scheme == "auto":
        return pick_scheme(*cfg.grid_shape)
    return cfg.fused_scheme


def _kron_tables(cfg: CollisionConfig, pre: Precomp) -> _k3.KronTables:
    """K3's tables for ``pre``, built at the first call and kept in
    ``pre.derived``; held by a CUDA graph being captured, which reads them
    in place."""
    key = ("kron", cfg.domain_length, cfg.dtype)
    if key not in pre.derived:
        ax, ay, az = _alpha_factors(cfg, pre, pre.rho, pre.sigma)
        pre.derived[key] = _k3.kron_tables(
            ax, ay, az, pre.dft_inv_axes(), pre.dft_fwd_axes())
    return _graph.hold(pre.derived[key])


def gain_spectrum(cfg: CollisionConfig, pre: Precomp, f_hat) -> torch.Tensor:
    """Full gain spectrum Q_gain_hat.

    ``impl="fused"``: one gain-only kernel call (K2, K4 or K3 by
    ``fused_scheme``) on f_hat of shape (Nx, Ny, Nz) or (E, Nx, Ny, Nz).  The
    staged pipelines: one spectrum, chunked over the node batch and summed
    chunk after chunk in order; the chunking follows the node tables in
    ``pre`` (not ``cfg.n_nodes``), so a device-local shard of the node axis
    works the same way.
    """
    if cfg.impl == "fused":
        scheme = fused_scheme(cfg)
        if scheme == "kron":
            ax = ay = az = None
            tables = _kron_tables(cfg, pre)
        else:
            ax, ay, az = _alpha_factors(cfg, pre, pre.rho, pre.sigma)
            tables = None
        return _k3.fused_gain(
            pre.rho, pre.gain_w, ax, ay, az, f_hat.to(cfg.complex_dtype),
            pre.dft_inv_axes(), pre.dft_fwd_axes(), pre.norm_l,
            length=cfg.domain_length, b_gamma=cfg.b_gamma,
            radial_group=cfg.ns_eff, scheme=scheme, tables=tables,
            chunk=kernel_chunk(cfg, pre, f_hat),
        )
    b = pre.rho.shape[0]
    c = node_chunk(cfg, pre)
    acc = None
    for i in range(0, b, c):
        part = _gain_chunk(
            cfg, pre, f_hat, pre.rho[i:i + c], pre.sigma[i:i + c], pre.gain_w[i:i + c]
        )
        acc = part if acc is None else acc + part
    return acc


def _fused_io_collide(cfg: CollisionConfig, pre: Precomp, f: torch.Tensor):
    """The whole eval through K1 (kernel on CUDA, plain version on the CPU)."""
    ax, ay, az = _alpha_factors(cfg, pre, pre.rho, pre.sigma)
    return _k1.fused_collide(
        pre.rho, pre.gain_w, ax, ay, az, f, pre.beta2,
        pre.dft_inv_axes(), pre.dft_fwd_axes(), pre.norm_l,
        length=cfg.domain_length, b_gamma=cfg.b_gamma,
        radial_group=cfg.ns_eff, chunk=kernel_chunk(cfg, pre, f),
    ).to(cfg.real_dtype)


class _FusedCollide(torch.autograd.Function):
    """K1 forward; the backward reruns the staged c2c pipeline on the same
    ``Precomp`` (the fused tables carry full-spectrum modes) under autograd.
    Gradients flow to ``f`` only."""

    @staticmethod
    def forward(ctx, cfg: CollisionConfig, pre: Precomp, f: torch.Tensor):
        ctx.cfg = cfg
        ctx.pre = pre
        ctx.save_for_backward(f)
        return _fused_io_collide(cfg, pre, f)

    @staticmethod
    def backward(ctx, grad_q):
        (f,) = ctx.saved_tensors
        staged_cfg = dataclasses.replace(ctx.cfg, impl="c2c")
        with torch.enable_grad():
            x = f.detach().requires_grad_(True)
            q = collide(staged_cfg, ctx.pre, x)
            (grad_f,) = torch.autograd.grad(q, x, grad_q)
        return None, None, grad_f


def collide(
    cfg: CollisionConfig,
    pre: Precomp,
    f: torch.Tensor,
    gain_reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> torch.Tensor:
    """Evaluate Q(f, f) for f of shape (Nx, Ny, Nz) or (E, Nx, Ny, Nz).

    ``gain_reduce`` is an optional hook applied to the gain spectrum before
    the final inverse transform (the node-sharded operator's all-reduce).
    ``impl="fused"`` on the ct scheme without a hook runs the whole eval in
    K1; every other fused route sends the whole batch through one gain-only
    kernel call (K2, K4 or K3), then the hook, then the staged c2c finale.
    """
    f = f.to(cfg.real_dtype)
    scheme = fused_scheme(cfg) if cfg.impl == "fused" else None
    if scheme == "ct" and gain_reduce is None:
        return _FusedCollide.apply(cfg, pre, f)
    if scheme is not None and torch.is_grad_enabled() and f.requires_grad:
        hook = " with a gain_reduce hook" if gain_reduce is not None else ""
        raise NotImplementedError(
            f"impl='fused' with fused_scheme={scheme!r}{hook} has no gradient, "
            "as in boltzfft; use fused_scheme='ct' without a hook, or impl='c2c'"
        )
    if f.dim() == 4 and scheme is None:
        return torch.stack([collide(cfg, pre, fi, gain_reduce) for fi in f])
    shape = cfg.grid_shape
    if cfg.impl == "rfft":
        f_hat = torch.fft.rfftn(f, dim=_FFT_AXES)
        q_gain_hat = gain_spectrum(cfg, pre, f_hat)
        if gain_reduce is not None:
            q_gain_hat = gain_reduce(q_gain_hat)
        q_gain = torch.fft.irfftn(q_gain_hat, s=shape, dim=_FFT_AXES)
        loss_conv = torch.fft.irfftn(
            pre.beta2.to(f_hat.dtype) * f_hat, s=shape, dim=_FFT_AXES
        )
    else:  # "c2c", "dft" and the gain-only fused routes: full complex spectra
        f_hat = torch.fft.fftn(f.to(cfg.complex_dtype), dim=_FFT_AXES)
        q_gain_hat = gain_spectrum(cfg, pre, f_hat)
        if gain_reduce is not None:
            q_gain_hat = gain_reduce(q_gain_hat)
        q_gain = torch.fft.ifftn(q_gain_hat, dim=_FFT_AXES).real
        loss_conv = torch.fft.ifftn(
            pre.beta2.to(f_hat.dtype) * f_hat, dim=_FFT_AXES
        ).real
    return q_gain - loss_conv * f


def make_collision_operator(
    cfg: CollisionConfig, jit: bool = True, *, device="cuda",
) -> Tuple[Callable[[torch.Tensor, Precomp], torch.Tensor], Precomp]:
    """Build ``(collide_fn, precomp)`` for a configuration on ``device``
    (CUDA unless the caller asks for the CPU).

    ``collide_fn(f, precomp) -> Q`` for f of shape (Nx, Ny, Nz) or
    (E, Nx, Ny, Nz).  ``impl="fused"`` on CUDA raises here if the kernels
    cannot take the grid.

    ``jit=True`` on CUDA replays the eval from a CUDA graph
    (:class:`boltzfft_torch._graph.Replayed`), the card's counterpart of the
    JAX package's ``jax.jit``, on every route: the first call per precomp
    and f shape runs one eager eval, then captures one; every call returns a
    fresh Q with the eager eval's bits.  A failed capture raises, and so
    does an f that requires grad while grad is enabled (a graph replays no
    backward: build with ``jit=False`` to differentiate).  On the CPU
    ``jit`` changes nothing.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but torch.cuda.is_available() is False")
    if cfg.impl == "fused" and device.type == "cuda":
        _k1.check_grid(cfg.grid_shape, cfg.real_dtype)
    with obs.span("precomp"):
        pre = build_precomp(cfg, device)

    def collide_fn(f, precomp):
        with obs.span("collide", like=f):
            return collide(cfg, precomp, f)

    if jit and device.type == "cuda":
        replayed = _graph.Replayed(collide_fn, "collide")

        def collide_fn(f, precomp):  # noqa: F811
            if torch.is_grad_enabled() and f.requires_grad:
                raise RuntimeError(
                    "make_collision_operator(jit=True) replays a CUDA graph, which has no"
                    " backward; build the operator with jit=False to differentiate")
            return replayed(f, precomp)

    return collide_fn, pre
