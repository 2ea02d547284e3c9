"""Conservative moment projection for the collision operator (mirror of
``boltzfft/conserve.py``).

The discrete spectral operator leaves a small defect in the collision
invariants' moments (mass, momentum, energy) of each Q.  :func:`project`
removes it: ``Q' = Q - sum_k c_k phi_k`` with ``phi_k = psi_k(v) w(v)``, the
invariants ``psi`` in {1, v, |v|^2} weighted by a Maxwellian ``w`` at the
domain temperature scale, and the 5 coefficients solving the precomputed
Gram system ``G c = m(Q)``, ``G_jk = sum psi_j phi_k dv^3``.  The tables are
built in host float64 NumPy exactly as ``boltzfft`` builds them, then placed
on an explicit device.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from .weights import CollisionConfig


class ConservePrecomp(NamedTuple):
    """Projection tables: ``psi`` (5, Nx, Ny, Nz) invariant moments x cell
    volume (so ``m = psi . Q`` sums are integrals), and ``corr``
    (5, Nx, Ny, Nz), the ``G^-1``-combined correction fields with
    ``Q' = Q - sum_j m_j corr_j``."""

    psi: torch.Tensor
    corr: torch.Tensor


def build_conserve_precomp(
    cfg: CollisionConfig, temperature: float = 1.0, *, device="cuda"
) -> ConservePrecomp:
    """Host-f64 basis and Gram build for :func:`project`, on ``device`` (the
    card by default, as ``build_ds_precomp``; ``device="cpu"`` for the plain
    versions).

    ``temperature`` sets the Gaussian weight's scale; any positive value
    gives an exact projection (it only shapes where the correction lives).
    """
    g = cfg.velocity_grid
    X = np.asarray(g.vx, np.float64)[:, None, None]
    Y = np.asarray(g.vy, np.float64)[None, :, None]
    Z = np.asarray(g.vz, np.float64)[None, None, :]
    r2 = X**2 + Y**2 + Z**2
    one = np.ones_like(r2)
    psi = np.stack([one, X * one, Y * one, Z * one, r2])  # (5, Nx, Ny, Nz)
    phi = psi * np.exp(-r2 / (2.0 * temperature))
    dv3 = float(g.cell_volume)
    gram = np.einsum("aijk,bijk->ab", psi, phi) * dv3  # (5, 5)
    ginv = np.linalg.inv(gram)
    # corr_j = sum_k ginv[k, j] phi_k  so that  Q' = Q - m_j corr_j
    corr = np.tensordot(ginv.T, phi, axes=(1, 0))
    rd = cfg.real_dtype
    return ConservePrecomp(
        psi=torch.as_tensor(psi * dv3, dtype=rd, device=device),
        corr=torch.as_tensor(corr, dtype=rd, device=device),
    )


def project(q: torch.Tensor, cp: ConservePrecomp) -> torch.Tensor:
    """Remove the invariant-moment defect of ``q`` (leading axes, e.g. a
    cell batch, broadcast): moments of the result vanish to roundoff."""
    m = torch.einsum("aijk,...ijk->...a", cp.psi, q)
    return q - torch.einsum("...a,aijk->...ijk", m, cp.corr)


def conservative(collide_fn: Callable, cp: ConservePrecomp) -> Callable:
    """Wrap a collision operator so every Q it returns is projected:
    ``conservative(collide, cp)(f, pre) = project(collide(f, pre), cp)``."""

    def collide_conservative(f, pre):
        return project(collide_fn(f, pre), cp)

    return collide_conservative
