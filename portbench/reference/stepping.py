"""Plain reference of the solvers around the collision operator: the BKW
closed form, explicit Runge-Kutta steps, moments, the periodic MUSCL
advection with the MC limiter, the Strang-split 2D x 3V step and the
Taylor-Green monitor.  Torch only, written from the equations.
"""

from __future__ import annotations

import math

import torch

from . import spectral


# ---------------------------------------------------------------- BKW
def bkw_f(r_squared: torch.Tensor, t: float) -> torch.Tensor:
    """The BKW solution for Maxwell molecules, ``K = 1 - exp(-t/6)``:
    ``f = exp(-|v|^2/(2K)) ((5K-3)/K + (1-K)/K^2 |v|^2) / (2 (2 pi K)^1.5)``."""
    k = 1.0 - math.exp(-t / 6.0)
    return (torch.exp(-r_squared / (2.0 * k)) * ((5.0 * k - 3.0) / k + (1.0 - k) / k**2 * r_squared)
            / (2.0 * (2.0 * math.pi * k) ** 1.5))


def bkw_dfdt(r_squared: torch.Tensor, t: float) -> torch.Tensor:
    """d/dt of :func:`bkw_f` (through ``dK/dt = exp(-t/6)/6``): the exact
    Q(f, f) of the BKW state."""
    k = 1.0 - math.exp(-t / 6.0)
    dk = math.exp(-t / 6.0) / 6.0
    gauss = torch.exp(-r_squared / (2.0 * k)) / (2.0 * (2.0 * math.pi * k) ** 1.5)
    poly = (5.0 * k - 3.0) / k + (1.0 - k) / k**2 * r_squared
    dpoly = 3.0 / k**2 + (k - 2.0) / k**3 * r_squared
    return dk * gauss * ((-1.5 / k + r_squared / (2.0 * k**2)) * poly + dpoly)


def r_squared(grid: spectral.Grid) -> torch.Tensor:
    vx, vy, vz = (torch.tensor(v, dtype=torch.float64, device=grid.device) for v in grid.v)
    return vx[:, None, None] ** 2 + vy[None, :, None] ** 2 + vz[None, None, :] ** 2


def maxwellian(ux, uy, grid: spectral.Grid, density: float, temperature: float) -> torch.Tensor:
    """Maxwellians of bulk velocities ``(ux, uy, 0)`` (any leading shape)
    on the grid: ``(..., Nx, Ny, Nz)`` in float64."""
    vx, vy, vz = (torch.tensor(v, dtype=torch.float64, device=grid.device) for v in grid.v)
    ux, uy = ux[..., None, None, None], uy[..., None, None, None]
    vsq = (vx[:, None, None] - ux) ** 2 + (vy[None, :, None] - uy) ** 2 + vz[None, None, :] ** 2
    return density / (2.0 * math.pi * temperature) ** 1.5 * torch.exp(-vsq / (2.0 * temperature))


# ---------------------------------------------------------------- RK
def rk_step(rhs, f: torch.Tensor, dt: float, method: str) -> torch.Tensor:
    """One explicit step of ``df/dt = rhs(f)``: forward Euler, the RK2
    midpoint rule or classic RK4."""
    if method == "euler":
        return f + dt * rhs(f)
    if method == "rk2":
        return f + dt * rhs(f + (0.5 * dt) * rhs(f))
    if method == "rk4":
        k1 = rhs(f)
        k2 = rhs(f + (0.5 * dt) * k1)
        k3 = rhs(f + (0.5 * dt) * k2)
        k4 = rhs(f + dt * k3)
        return f + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
    raise ValueError(f"unknown method {method!r}")


# ---------------------------------------------------------------- moments
def moments(f: torch.Tensor, tab: spectral.Tables) -> dict:
    """Mass, momentum (3), energy and temperature of ``f`` (..., Nx, Ny, Nz)."""
    vx, vy, vz = (torch.tensor(v, dtype=f.dtype, device=f.device) for v in tab.v)
    w = tab.cell_volume
    ax = (-3, -2, -1)
    mass = f.sum(ax) * w
    mom = torch.stack([(f * vx[:, None, None]).sum(ax), (f * vy[None, :, None]).sum(ax),
                       (f * vz[None, None, :]).sum(ax)], dim=-1) * w
    vsq = vx[:, None, None] ** 2 + vy[None, :, None] ** 2 + vz[None, None, :] ** 2
    energy = 0.5 * (f * vsq).sum(ax) * w
    temperature = (2.0 * energy / mass - ((mom / mass[..., None]) ** 2).sum(-1)) / 3.0
    return {"mass": mass, "momentum": mom, "energy": energy, "temperature": temperature}


def entropy(f: torch.Tensor, tab: spectral.Tables) -> torch.Tensor:
    """Boltzmann's H = sum f log f dv^3 per distribution; f <= 0 adds 0."""
    pos = f > 0
    safe = torch.where(pos, f, torch.ones_like(f))
    return torch.where(pos, safe * torch.log(safe), torch.zeros_like(f)).sum((-3, -2, -1)) * tab.cell_volume


def taylor_green_monitor(f: torch.Tensor, tab: spectral.Tables, d: float) -> torch.Tensor:
    """``[total mass, bulk kinetic energy, total H]`` of cells (Cx, Cy, ...)
    of side ``d``."""
    m = moments(f, tab)
    rho, mom = m["mass"], m["momentum"]
    ke = 0.5 * ((mom[..., 0] ** 2 + mom[..., 1] ** 2) / rho).sum() * d * d
    return torch.stack([rho.sum() * d * d, ke, entropy(f, tab).sum() * d * d])


# ---------------------------------------------------------------- transport
def advect_muscl(f: torch.Tensor, v: torch.Tensor, dx: float, dt: float, axis: int) -> torch.Tensor:
    """One periodic step of ``df/dt + v df/dx = 0`` along cell ``axis``:
    MC-limited slopes ``s_i`` (zero at extrema, else the least of
    ``2|f_i - f_{i-1}|``, ``2|f_{i+1} - f_i|``, ``|f_{i+1} - f_{i-1}|/2``
    with their sign), the time-centred face value ``f_i + (1 - nu) s_i / 2``
    for ``v > 0`` and ``f_{i+1} - (1 + nu) s_{i+1} / 2`` otherwise
    (``nu = v dt/dx``), and the conservative flux difference."""
    nu = v * (dt / dx)
    back = f - torch.roll(f, 1, dims=axis)
    fwd = torch.roll(f, -1, dims=axis) - f
    mag = torch.minimum(torch.minimum(2.0 * back.abs(), 2.0 * fwd.abs()), 0.5 * (back + fwd).abs())
    s = torch.where(back * fwd > 0, torch.sign(back) * mag, torch.zeros_like(f))
    right = torch.roll(f - 0.5 * (1.0 + nu) * s, -1, dims=axis)
    face = torch.where(v > 0, f + 0.5 * (1.0 - nu) * s, right)
    flux = v * face
    return f - (dt / dx) * (flux - torch.roll(flux, 1, dims=axis))


def strang_step_2d(f: torch.Tensor, tab: spectral.Tables, *, d: float, dt: float, knudsen: float,
                   collide=spectral.collide) -> torch.Tensor:
    """One step of ``df/dt + v . grad f = Q(f, f)/Kn`` on a periodic grid of
    cells ``f`` (Cx, Cy, Nx, Ny, Nz): ``Ax(dt/2) Ay(dt/2) C(dt) Ay(dt/2)
    Ax(dt/2)``, the collision substep the RK2 midpoint rule on Q/Kn."""
    vx = torch.tensor(tab.v[0], dtype=f.dtype, device=f.device).reshape(1, 1, -1, 1, 1)
    vy = torch.tensor(tab.v[1], dtype=f.dtype, device=f.device).reshape(1, 1, 1, -1, 1)
    f = advect_muscl(f, vx, d, 0.5 * dt, 0)
    f = advect_muscl(f, vy, d, 0.5 * dt, 1)
    f = rk_step(lambda x: collide(x, tab) / knudsen, f, dt, "rk2")
    f = advect_muscl(f, vy, d, 0.5 * dt, 1)
    return advect_muscl(f, vx, d, 0.5 * dt, 0)
