"""Integer Fourier-mode tables in FFT (wrap-around) order (mirror of
``boltzfft/modes.py``): ``0, 1, ..., N/2-1, -N/2, ..., -1``; the rfft last axis
keeps ``0..N/2`` with the Nyquist entry stored as ``-N/2``."""

from __future__ import annotations

import numpy as np


def fft_modes(n: int) -> np.ndarray:
    """FFT-order integer modes for an axis of length ``n``."""
    return np.fft.fftfreq(n, d=1.0 / n).astype(np.float64)


def rfft_modes(n: int) -> np.ndarray:
    """Half-axis modes ``0..n/2`` of an rfft, Nyquist stored as ``-n/2``."""
    m = np.arange(n // 2 + 1, dtype=np.float64)
    if n % 2 == 0:
        m[-1] = -(n // 2)
    return m


def mode_norm_grid(lx: np.ndarray, ly: np.ndarray, lz: np.ndarray) -> np.ndarray:
    """``|l|`` on the 3-D tensor grid of the given per-axis mode tables."""
    return np.sqrt(
        lx[:, None, None] ** 2 + ly[None, :, None] ** 2 + lz[None, None, :] ** 2
    )
