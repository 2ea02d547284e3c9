"""Velocity-space grid (mirror of ``boltzfft/grid.py``).

A uniform, cell-centered tensor grid on ``[-L, L]^3``:
``v_i = -L + dv/2 + i*dv`` with ``dv = 2L/Nv``, per-axis resolutions allowed.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class VelocityGrid:
    """Uniform cell-centered velocity grid on ``[-L, L]^3``.

    ``nv`` is the x-axis resolution; ``nvy``/``nvz`` default to it (cubic).
    """

    nv: int
    length: float  # domain half-width L
    nvy: Optional[int] = None
    nvz: Optional[int] = None

    @property
    def shape(self) -> tuple[int, int, int]:
        return (self.nv, self.nvy or self.nv, self.nvz or self.nv)

    @property
    def is_isotropic(self) -> bool:
        s = self.shape
        return s[0] == s[1] == s[2]

    def _axis_v(self, n: int) -> np.ndarray:
        dv = 2.0 * self.length / n
        return -self.length + dv * (0.5 + np.arange(n))

    @property
    def dv(self) -> float:
        """Cell width (isotropic grids; use ``dvs``/``cell_volume`` otherwise)."""
        if not self.is_isotropic:
            raise ValueError(
                "dv is ambiguous on an anisotropic grid; use dvs or cell_volume"
            )
        return 2.0 * self.length / self.nv

    @property
    def dvs(self) -> tuple[float, float, float]:
        return tuple(2.0 * self.length / n for n in self.shape)

    @property
    def cell_volume(self) -> float:
        dx, dy, dz = self.dvs
        return dx * dy * dz

    @property
    def v(self) -> np.ndarray:
        """1-D cell-centered x-axis coordinates (all axes when isotropic)."""
        return self._axis_v(self.nv)

    @property
    def vx(self) -> np.ndarray:
        return self._axis_v(self.shape[0])

    @property
    def vy(self) -> np.ndarray:
        return self._axis_v(self.shape[1])

    @property
    def vz(self) -> np.ndarray:
        return self._axis_v(self.shape[2])

    def meshgrid(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        return np.meshgrid(self.vx, self.vy, self.vz, indexing="ij")

    def r_squared(self) -> np.ndarray:
        """``|v|^2`` on the 3-D grid."""
        return (
            self.vx[:, None, None] ** 2
            + self.vy[None, :, None] ** 2
            + self.vz[None, None, :] ** 2
        )


def domain_from_support(support_radius: float = 5.0) -> tuple[float, float]:
    """Return ``(R, L)`` for a distribution supported in ``|v| < S``:
    ``R = 2S`` and ``L = ((3+sqrt(2))/2) S``."""
    s = support_radius
    return 2.0 * s, 0.5 * (3.0 + np.sqrt(2.0)) * s
