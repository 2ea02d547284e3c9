"""Quadrature rules for the collision kernel decomposition (host NumPy, f64).

Mirror of ``boltzfft/quadrature.py``: an ``n``-point Gauss-Legendre rule on
``[0, R]`` in the radial direction and a symmetric spherical t-design on the
unit sphere.  The design tables are read from ``boltzfft/data/`` by path (they
are not copied), and the Gauss-Legendre nodes come from the same native
library the JAX package uses when it has been built (``make -C native``), with
the same ``numpy.polynomial.legendre.leggauss`` fallback, so both packages
compute bitwise the same tables.
"""

from __future__ import annotations

import ctypes
import dataclasses
from pathlib import Path
from typing import Optional

import numpy as np

_JAX_PKG_DIR = Path(__file__).resolve().parents[1] / "boltzfft"
_DATA_DIR = _JAX_PKG_DIR / "data"
_NATIVE_LIB = _JAX_PKG_DIR / "_lib" / "libboltzfft_native.so"

#: Available spherical design sizes -> node-table file under ``boltzfft/data``.
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


def _native_leggauss(n: int) -> Optional[tuple[np.ndarray, np.ndarray]]:
    """Nodes/weights from the native long-double Newton iteration, or None
    when the library has not been built."""
    if not _NATIVE_LIB.exists():
        return None
    lib = ctypes.CDLL(str(_NATIVE_LIB))
    dp = ctypes.POINTER(ctypes.c_double)
    lib.bz_leggauss.restype = ctypes.c_int
    lib.bz_leggauss.argtypes = [ctypes.c_int, dp, dp]
    nodes = np.empty(n, dtype=np.float64)
    weights = np.empty(n, dtype=np.float64)
    if lib.bz_leggauss(n, nodes.ctypes.data_as(dp), weights.ctypes.data_as(dp)):
        raise ValueError(f"bz_leggauss failed for n={n}")
    return nodes, weights


def _leggauss_unit(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Gauss-Legendre nodes/weights on [-1, 1]."""
    native = _native_leggauss(n)
    if native is not None:
        return native
    return np.polynomial.legendre.leggauss(n)


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
