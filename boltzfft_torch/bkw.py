"""BKW analytic solution for Maxwell molecules (mirror of ``boltzfft/bkw.py``).

With ``K(t) = 1 - exp(-t/6)``:

    f(v, t) = 1/(2 (2 pi K)^{3/2}) * exp(-|v|^2/(2K))
              * ((5K - 3)/K + (1 - K)/K^2 * |v|^2)

and ``Q(f, f) = df/dt`` — the accuracy oracle of the collision operator.
Host NumPy builders in float64; cast to the compute dtype on the device.
"""

from __future__ import annotations

import numpy as np


def bkw_k(t: float) -> float:
    """``K(t) = 1 - exp(-t/6)``."""
    return 1.0 - np.exp(-t / 6.0)


def bkw_f(r_squared: np.ndarray, t: float) -> np.ndarray:
    """BKW distribution at time ``t`` given ``|v|^2`` on the grid."""
    k = bkw_k(t)
    pref = 1.0 / (2.0 * (2.0 * np.pi * k) ** 1.5)
    return pref * np.exp(-r_squared / (2.0 * k)) * (
        (5.0 * k - 3.0) / k + (1.0 - k) / k**2 * r_squared
    )


def bkw_dfdt(r_squared: np.ndarray, t: float) -> np.ndarray:
    """Analytic ``df/dt`` of the BKW solution (chain rule through K,
    ``dK/dt = exp(-t/6)/6``)."""
    k = bkw_k(t)
    dk = np.exp(-t / 6.0) / 6.0
    f = bkw_f(r_squared, t)
    pref = 1.0 / (2.0 * (2.0 * np.pi * k) ** 1.5)
    q = (-3.0 / (2.0 * k) + r_squared / (2.0 * k**2)) * f
    q = q + pref * np.exp(-r_squared / (2.0 * k)) * (
        3.0 / k**2 + (k - 2.0) / k**3 * r_squared
    )
    return q * dk


def maxwellian(r_squared: np.ndarray, density: float = 1.0, temperature: float = 1.0) -> np.ndarray:
    """Isotropic Maxwellian equilibrium (the t -> inf limit of BKW)."""
    pref = density / (2.0 * np.pi * temperature) ** 1.5
    return pref * np.exp(-r_squared / (2.0 * temperature))
