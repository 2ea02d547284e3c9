"""Plain reference of the fast Fourier spectral collision operator.

Written from the method (Gamba, Haack, Hauck and Hu, SIAM J. Sci. Comput.
39 (2017); the reference code i3s93/Boltzmann-Fourier-Spectral-Method), not
from the program under test: torch and NumPy only, every table rebuilt here
from the configuration's numbers.

For a VHS kernel ``B = b_gamma |g|^gamma`` on the periodic box ``[-L, L]^3``
with Fourier modes ``l``, radial Gauss-Legendre nodes ``rho_r`` on ``[0, R]``
(weights ``w_r``) and a spherical design ``sigma_s`` (weights ``w_s``):

    f_hat     = FFT(f)
    g1_rs     = IFFT(a_rs f_hat),  g2_rs = IFFT(conj(a_rs) f_hat),
                a_rs(l) = exp(-i pi/(2L) rho_r l . sigma_s)
    Q_gain    = Re IFFT( sum_r beta1_r(l) FFT( sum_s w_r rho_r^(gamma+2) w_s g1_rs g2_rs ) )
    beta1_r   = 4 pi b_gamma sinc(pi rho_r |l| / (2L))
    Q_loss    = Re IFFT(beta2 f_hat) f,
    beta2(l)  = 16 pi^2 b_gamma sum_r w_r rho_r^(gamma+2) sinc(pi rho_r |l| / L)

with ``R = 2S`` and ``L = (3 + sqrt 2) S / 2`` for the support radius S (unless the
configuration states ``radial_radius`` or ``length``), and
``sinc(x) = sin(x + eps) / (x + eps)`` (eps the float64 epsilon), the
regularised sinc of the reference code.  The inner sum over a radial group
before the forward transform is exact: beta1 depends on rho_r only.  Under
the antipodal reduction a design closed under ``sigma -> -sigma`` keeps one
node of each pair at twice the weight (the two give the same gain term).
"""

from __future__ import annotations

import dataclasses
import math
from pathlib import Path

import numpy as np
import torch

_HERE = Path(__file__).resolve().parent
#: Spherical designs this reference carries (frozen copies of the tables).
DESIGNS = {12: _HERE / "ss005.012.txt"}
_EPS64 = float(np.finfo(np.float64).eps)


def _sinc(x: torch.Tensor) -> torch.Tensor:
    return torch.sin(x + _EPS64) / (x + _EPS64)


def gauss_legendre(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Gauss-Legendre nodes and weights on [-1, 1]: NumPy's rule refined by
    Newton's iteration on P_n in long double (NumPy's weights at n = 64
    are ~1e-12 off, which the cancellation of gain and loss near
    equilibrium would magnify)."""
    x = np.polynomial.legendre.leggauss(n)[0].astype(np.longdouble)

    def legendre(x):
        p0, p1 = np.ones_like(x), x.copy()
        for k in range(1, n):
            p0, p1 = p1, ((2 * k + 1) * x * p1 - k * p0) / (k + 1)
        return p1, n * (x * p1 - p0) / (x * x - 1)

    for _ in range(3):
        p, dp = legendre(x)
        x = x - p / dp
    _, dp = legendre(x)
    return x.astype(np.float64), (2 / ((1 - x * x) * dp * dp)).astype(np.float64)


def _design(ns: int, antipodal: bool) -> tuple[np.ndarray, np.ndarray]:
    """Points (n, 3) and weights of the ``ns``-point design, halved to one
    node of each antipodal pair when asked."""
    if ns not in DESIGNS:
        raise ValueError(f"no spherical design with {ns} points here; have {sorted(DESIGNS)}")
    pts = np.loadtxt(DESIGNS[ns], dtype=np.float64).reshape(ns, 3)
    w = np.full(ns, 4.0 * math.pi / ns)
    if not antipodal:
        return pts, w
    keep, paired = [], set()
    for i, p in enumerate(pts):
        if i in paired:
            continue
        j = int(np.argmin(np.abs(pts + p).sum(axis=1)))
        if j == i or j in paired or np.abs(pts[j] + p).max() > 1e-15:
            raise ValueError(f"design ss{ns} is not closed under sigma -> -sigma")
        keep.append(i)
        paired.update((i, j))
    return pts[keep], 2.0 * w[keep]


@dataclasses.dataclass
class Grid:
    """The velocity grid of a configuration: what the inputs need, cheap to
    build (no quadrature, no multipliers)."""

    shape: tuple  # (Nx, Ny, Nz)
    length: float  # L
    v: tuple  # per-axis cell-centred velocities (host float64)
    cell_volume: float
    device: torch.device


@dataclasses.dataclass
class Tables(Grid):
    """The operator's grid, quadrature and multipliers for one configuration,
    on one device in one precision."""

    rho: np.ndarray  # (R,) radial nodes
    radial_w: np.ndarray  # (R,) w_r rho_r^(gamma+2)
    sigma: np.ndarray  # (S, 3) design points kept
    sph_w: np.ndarray  # (S,)
    b_gamma: float
    l_axes: tuple  # per-axis integer modes in FFT order, on the device
    norm_l: torch.Tensor  # |l| on the mode grid
    beta2: torch.Tensor
    dtype: torch.dtype  # real dtype of the arithmetic

    @property
    def cdtype(self) -> torch.dtype:
        return torch.complex128 if self.dtype == torch.float64 else torch.complex64


def _support(config: dict) -> float:
    return float(config.get("support_radius", 5.0))


def grid(config: dict, device) -> Grid:
    """The velocity grid for a configuration file's numbers (``shape``, or
    ``nv`` with ``nvy`` and ``nvz``; ``support_radius``, ``length``)."""
    nv = config.get("nv")
    shape = tuple(config.get("shape") or (nv, config.get("nvy") or nv, config.get("nvz") or nv))
    length = float(config.get("length") or 0.5 * (3.0 + math.sqrt(2.0)) * _support(config))
    v = tuple(-length + (2.0 * length / n) * (0.5 + np.arange(n)) for n in shape)
    cell_volume = math.prod(2.0 * length / n for n in shape)
    return Grid(shape, length, v, cell_volume, torch.device(device))


def tables(config: dict, device, dtype=torch.float64) -> Tables:
    """Tables for a configuration file's numbers (the grid's, ``ns``,
    ``n_radial``, ``gamma``, ``b_gamma``, ``radial_radius``, ``antipodal``);
    the multipliers are formed in float64 and cast to ``dtype``."""
    g = grid(config, device)
    r_max = float(config.get("radial_radius") or 2.0 * _support(config))
    gamma = float(config.get("gamma", 0.0))
    b_gamma = float(config.get("b_gamma", 1.0 / (4.0 * math.pi)))
    t, w = gauss_legendre(int(config.get("n_radial") or g.shape[0]))
    rho = 0.5 * r_max * (t + 1.0)
    radial_w = 0.5 * r_max * w * rho ** (gamma + 2.0)
    sigma, sph_w = _design(int(config["ns"]), bool(config.get("antipodal", True)))

    l_axes = tuple(torch.tensor(np.fft.fftfreq(n, 1.0 / n), dtype=torch.float64, device=g.device)
                   for n in g.shape)
    lx, ly, lz = l_axes
    norm_l = torch.sqrt(lx[:, None, None] ** 2 + ly[None, :, None] ** 2 + lz[None, None, :] ** 2)
    beta2 = torch.zeros_like(norm_l)
    for r, wr in zip(rho, radial_w):
        beta2 += 16.0 * math.pi**2 * b_gamma * wr * _sinc((math.pi / g.length) * r * norm_l)
    return Tables(g.shape, g.length, g.v, g.cell_volume, g.device, rho, radial_w, sigma, sph_w,
                  b_gamma, l_axes, norm_l.to(dtype), beta2.to(dtype), dtype)


def collide(f: torch.Tensor, tab: Tables, block_bytes: int = 1 << 28) -> torch.Tensor:
    """Q(f, f) for ``f`` of shape (..., Nx, Ny, Nz) in ``tab``'s precision,
    a few radial nodes and distributions at a time (each block's phased
    spectra at most about ``block_bytes``)."""
    lead = f.shape[:-3]
    fb = f.reshape((-1,) + tab.shape).to(tab.dtype)
    out = torch.empty_like(fb)
    per_item = len(tab.sigma) * math.prod(tab.shape) * (16 if tab.dtype == torch.float64 else 8)
    e_blk = max(1, min(fb.shape[0], block_bytes // per_item))
    for e0 in range(0, fb.shape[0], e_blk):
        out[e0:e0 + e_blk] = _collide_block(fb[e0:e0 + e_blk], tab, block_bytes)
    return out.reshape(lead + tab.shape)


def _collide_block(f: torch.Tensor, tab: Tables, block_bytes: int) -> torch.Tensor:
    axes = (-3, -2, -1)
    cd = tab.cdtype
    f_hat = torch.fft.fftn(f.to(cd), dim=axes)  # (E, Nx, Ny, Nz)
    n_e, n_s = f.shape[0], len(tab.sigma)
    per_radial = n_e * n_s * math.prod(tab.shape) * (16 if tab.dtype == torch.float64 else 8)
    r_blk = max(1, block_bytes // per_radial)
    lx, ly, lz = tab.l_axes
    sig = torch.tensor(tab.sigma, dtype=torch.float64, device=tab.device)
    # l . sigma_s on the mode grid, per design node: (S, Nx, Ny, Nz), float64
    l_dot_s = (sig[:, 0, None, None, None] * lx[None, :, None, None]
               + sig[:, 1, None, None, None] * ly[None, None, :, None]
               + sig[:, 2, None, None, None] * lz[None, None, None, :])
    sph_w = torch.tensor(tab.sph_w, dtype=tab.dtype, device=tab.device)
    gain_hat = torch.zeros_like(f_hat)
    for r0 in range(0, len(tab.rho), r_blk):
        rho = torch.tensor(tab.rho[r0:r0 + r_blk], dtype=torch.float64, device=tab.device)
        rw = torch.tensor(tab.radial_w[r0:r0 + r_blk], dtype=tab.dtype, device=tab.device)
        phase = (-math.pi / (2.0 * tab.length)) * rho[:, None, None, None, None] * l_dot_s[None]
        a = torch.polar(torch.ones_like(phase), phase).to(cd)  # (Rb, S, Nx, Ny, Nz)
        g1 = torch.fft.ifftn(a[None] * f_hat[:, None, None], dim=axes)  # (E, Rb, S, ...)
        g2 = torch.fft.ifftn(torch.conj(a)[None] * f_hat[:, None, None], dim=axes)
        h = torch.sum((rw[:, None, None, None, None] * sph_w[None, :, None, None, None]).to(cd)
                      * (g1 * g2), dim=2)  # (E, Rb, Nx, Ny, Nz)
        beta1 = (4.0 * math.pi * tab.b_gamma) * _sinc(
            (math.pi / (2.0 * tab.length)) * rho[:, None, None, None] * tab.norm_l.double()[None])
        gain_hat += torch.sum(beta1.to(cd)[None] * torch.fft.fftn(h, dim=axes), dim=1)
    q_gain = torch.fft.ifftn(gain_hat, dim=axes).real
    loss = torch.fft.ifftn(tab.beta2.to(cd) * f_hat, dim=axes).real
    return q_gain - loss * f
