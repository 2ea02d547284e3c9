"""Moments of a velocity distribution (mirror of ``boltzfft/moments.py``):
mass, momentum, energy and temperature, and the Boltzmann H functional.

Tensor reductions over the trailing (cell-centred) velocity axes, on the
device of ``f``; leading axes (cells, an ensemble) broadcast.  Host
coordinates are uploaded once per (values, dtype, device), so a ``record``
of moments can be captured into a step's CUDA graph.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import NamedTuple, Optional

import numpy as np
import torch

from ._graph import hold

#: Uploaded coordinate arrays kept, the least recently used going first.
KEEP_COORDS = 16
_coords: OrderedDict = OrderedDict()  # (bytes, shape, dtype, torch dtype, device) -> tensor


class Moments(NamedTuple):
    mass: torch.Tensor  # rho            = sum f dv^3
    momentum: torch.Tensor  # (..., 3)   = sum v f dv^3
    energy: torch.Tensor  # 0.5 sum |v|^2 f dv^3
    temperature: torch.Tensor  # T = (2E/rho - |u|^2) / 3


_V_AXES = (-3, -2, -1)


def _cell_weight(dv, cell_volume):
    if cell_volume is None and dv is None:
        raise ValueError("pass dv or cell_volume")
    return cell_volume if cell_volume is not None else dv**3


def entropy(f: torch.Tensor, dv: Optional[float] = None, *,
            cell_volume: Optional[float] = None) -> torch.Tensor:
    """Boltzmann H functional ``H(f) = sum f log(f) dv^3`` over the trailing
    velocity axes (leading axes broadcast).

    Non-positive values (spectral updates can undershoot to tiny negative f
    in the tails) contribute 0, the limit of ``f log f`` as f -> 0+.
    """
    w = _cell_weight(dv, cell_volume)
    pos = f > 0.0
    safe = torch.where(pos, f, torch.ones_like(f))
    return torch.sum(torch.where(pos, safe * torch.log(safe), torch.zeros_like(f)),
                     dim=_V_AXES) * w


def moments(f: torch.Tensor, v, dv: Optional[float] = None, *,
            cell_volume: Optional[float] = None) -> Moments:
    """Moments of ``f`` (..., Nx, Ny, Nz) on the tensor grid with 1-D
    coordinates ``v``: one array shared by all axes (cubic grids, pass ``dv``)
    or a ``(vx, vy, vz)`` tuple (anisotropic grids, pass ``cell_volume``).
    Coordinates may be NumPy arrays or tensors; they are moved to ``f``."""
    if isinstance(v, (tuple, list)):
        if cell_volume is None:
            raise ValueError("anisotropic moments need cell_volume, not dv")
        w = cell_volume
    else:
        v = (v, v, v)
        w = _cell_weight(dv, cell_volume)
    vx, vy, vz = (_on(c, f.dtype, f.device) for c in v)
    mass = torch.sum(f, dim=_V_AXES) * w
    mx = torch.sum(f * vx[:, None, None], dim=_V_AXES) * w
    my = torch.sum(f * vy[None, :, None], dim=_V_AXES) * w
    mz = torch.sum(f * vz[None, None, :], dim=_V_AXES) * w
    momentum = torch.stack([mx, my, mz], dim=-1)
    r_sq = vx[:, None, None] ** 2 + vy[None, :, None] ** 2 + vz[None, None, :] ** 2
    energy = 0.5 * torch.sum(f * r_sq, dim=_V_AXES) * w
    u_sq = torch.sum((momentum / mass[..., None]) ** 2, dim=-1)
    temperature = (2.0 * energy / mass - u_sq) / 3.0
    return Moments(mass=mass, momentum=momentum, energy=energy, temperature=temperature)


def _on(c, dtype, device) -> torch.Tensor:
    """Coordinates ``c`` as a ``dtype`` tensor on ``device``: a tensor there
    cast in place, anything else uploaded once and cached (passed through
    ``_graph.hold``, so an eviction frees nothing a graph reads)."""
    if isinstance(c, torch.Tensor) and c.device == device:
        return c.to(dtype)
    a = np.asarray(c.cpu() if isinstance(c, torch.Tensor) else c)
    key = (a.tobytes(), a.shape, a.dtype.str, dtype, device)
    t = _coords.get(key)
    if t is None:
        t = _coords[key] = torch.as_tensor(a, dtype=dtype, device=device)
        while len(_coords) > KEEP_COORDS:
            _coords.popitem(last=False)
    _coords.move_to_end(key)
    return hold(t)
