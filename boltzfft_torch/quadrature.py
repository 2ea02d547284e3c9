"""Quadrature rules for the collision kernel decomposition (host NumPy, f64).

Mirror of ``boltzfft/quadrature.py``: an ``n``-point Gauss-Legendre rule on
``[0, R]`` in the radial direction and a symmetric spherical t-design on the
unit sphere.  The design tables are the package's own copies under
``boltzfft_torch/data/``.  The Gauss-Legendre rule is the port's own: a NumPy
``longdouble`` copy of the Newton iteration of ``native/boltzfft_native.cpp``
(same initial guess, recurrence and stopping rule), so its nodes and weights
are bitwise those of the JAX package's native library, and do not depend on
whether that library was built.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional

import numpy as np

_DATA_DIR = Path(__file__).resolve().parent / "data"

#: Available spherical design sizes -> node-table file under ``data/``.
SPHERICAL_DESIGN_FILES = {
    6: "ss003.006.txt",
    12: "ss005.012.txt",
    32: "ss007.032.txt",
    48: "ss009.048.txt",
    70: "ss011.070.txt",
    94: "ss013.094.txt",
    120: "ss015.120.txt",
    156: "ss017.156.txt",
    192: "ss019.192.txt",
}


@dataclasses.dataclass(frozen=True)
class Quadrature1D:
    """A 1-D quadrature rule: ``integral f(x) dx ~= sum_i w_i f(x_i)``."""

    nodes: np.ndarray  # (n,) float64
    weights: np.ndarray  # (n,) float64

    @property
    def n(self) -> int:
        return self.nodes.shape[0]


@dataclasses.dataclass(frozen=True)
class SphericalQuadrature:
    """A quadrature rule on the unit sphere with ``sum_s w_s = 4*pi``."""

    points: np.ndarray  # (n, 3) float64, unit vectors
    weights: np.ndarray  # (n,) float64

    @property
    def n(self) -> int:
        return self.points.shape[0]


_LD = np.longdouble
# long double constants of the native iteration (80-bit x87 on x86-64)
_PI_LD = _LD("3.14159265358979323846264338327950288")
_NEWTON_TOL = _LD("1e-19")


def _leggauss_unit(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Gauss-Legendre nodes/weights on [-1, 1]: Newton's iteration on P_n
    (three-term recurrence) in long double for the upper half of the roots,
    each root stopping on its own once ``|dx| < 1e-19 (1 + |x|)``, rounded
    once to float64.  Operation for operation the native ``bz_leggauss``."""
    half = (n + 1) // 2
    k = np.arange(half)
    x = np.cos(_PI_LD * (k.astype(_LD) + _LD("0.75")) / (_LD(n) + _LD("0.5")))
    pp = np.zeros(half, _LD)  # P_n'(x) of each root's last iteration
    active = np.ones(half, bool)
    for _ in range(100):
        idx = np.flatnonzero(active)
        if idx.size == 0:
            break
        xa = x[idx]
        p0, p1 = np.ones_like(xa), xa.copy()
        for j in range(1, n):
            p0, p1 = p1, (_LD(2 * j + 1) * xa * p1 - _LD(j) * p0) / _LD(j + 1)
        ppa = _LD(n) * (xa * p1 - p0) / (xa * xa - _LD(1))
        dx = p1 / ppa
        xa = xa - dx
        x[idx], pp[idx] = xa, ppa
        active[idx[np.abs(dx) < _NEWTON_TOL * (_LD(1) + np.abs(xa))]] = False
    w = _LD(2) / ((_LD(1) - x * x) * pp * pp)
    nodes = np.empty(n, np.float64)
    weights = np.empty(n, np.float64)
    nodes[k], nodes[n - 1 - k] = (-x).astype(np.float64), x.astype(np.float64)
    weights[k] = weights[n - 1 - k] = w.astype(np.float64)
    if n % 2:
        nodes[n // 2] = 0.0  # exact centre root
    return nodes, weights


def gauss_legendre(n: int, a: float, b: float) -> Quadrature1D:
    """n-point Gauss-Legendre rule on ``[a, b]``."""
    if n <= 0:
        raise ValueError(f"Gauss-Legendre rule needs n >= 1, got {n}")
    t, w = _leggauss_unit(n)
    half = 0.5 * (b - a)
    mid = 0.5 * (b + a)
    return Quadrature1D(nodes=mid + half * t, weights=half * w)


def spherical_design(n: int) -> SphericalQuadrature:
    """Symmetric spherical t-design with ``n`` points and equal weights 4*pi/n."""
    if n not in SPHERICAL_DESIGN_FILES:
        raise ValueError(
            f"No spherical design with {n} points; available: "
            f"{sorted(SPHERICAL_DESIGN_FILES)}"
        )
    path = _DATA_DIR / SPHERICAL_DESIGN_FILES[n]
    pts = np.loadtxt(path, dtype=np.float64)
    if pts.shape != (n, 3):
        raise RuntimeError(f"Bad node table {path}: shape {pts.shape} != ({n}, 3)")
    return SphericalQuadrature(points=pts, weights=np.full(n, 4.0 * np.pi / n))


def antipodal_pairs(points: np.ndarray) -> Optional[np.ndarray]:
    """Pair indices ``(n/2, 2)`` if the node set is exactly (bit for bit)
    closed under ``sigma -> -sigma``, else ``None``."""
    n = points.shape[0]
    if n % 2:
        return None
    index = {pt.tobytes(): i for i, pt in enumerate(points)}
    pairs, seen = [], set()
    for i, pt in enumerate(points):
        if i in seen:
            continue
        j = index.get((-pt).tobytes())
        if j is None or j == i or j in seen:
            return None
        pairs.append((i, j))
        seen.update((i, j))
    return np.asarray(pairs, np.int64)


def antipodal_reduce(sph: SphericalQuadrature) -> SphericalQuadrature:
    """Half-design with doubled weights, exact for the collision integrand
    (a node and its antipode contribute bitwise the same gain term).

    Raises ``ValueError`` if the design is not exactly antipodally symmetric.
    """
    pairs = antipodal_pairs(sph.points)
    if pairs is None:
        raise ValueError(
            "spherical quadrature is not exactly antipodally symmetric; "
            "use the full design (antipodal=False)"
        )
    keep = pairs[:, 0]
    return SphericalQuadrature(points=sph.points[keep], weights=2.0 * sph.weights[keep])
