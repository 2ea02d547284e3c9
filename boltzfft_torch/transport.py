"""Space-inhomogeneous kinetic solver: transport + collisions (mirror of
``boltzfft/transport.py``).

Solves ``df/dt + v . grad_x f = Q(f, f) / Kn`` on periodic cell grids in 1, 2
or 3 space dimensions by Strang splitting: conservative advection along each
spatial axis (second-order MUSCL with the MC limiter by default, first-order
upwind as the fallback scheme), and the homogeneous collision operator on
every cell.  Cells are independent during the collision substep, so it is
one call of the operator on the flattened ``(cells, Nvx, Nvy, Nvz)`` stack
(where ``boltzfft`` vmaps a single-cell operator); with
``impl="fused"`` that is one K1 launch per substep (one K3 launch on the
kron route, ``operator.pick_scheme``).

The node- and cell-sharded steps (``make_sharded_step_2d``/``_3d`` and their
halo exchange) are not ported yet (ROADMAP Queue 1, step 9).
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from .bkw import maxwellian
from .weights import CollisionConfig, Precomp


def _advect_upwind_axis(f, v, dx, dt, axis):
    """First-order periodic upwind along ``axis``; ``v`` pre-broadcast."""
    vp = torch.clamp(v, min=0.0)
    vm = torch.clamp(v, max=0.0)
    c = dt / dx
    # backward difference for v > 0, forward for v < 0
    return f - c * (
        vp * (f - torch.roll(f, 1, dims=axis))
        + vm * (torch.roll(f, -1, dims=axis) - f)
    )


def _advect_muscl_axis(f, v, dx, dt, axis):
    """Second-order MUSCL (MC limiter) periodic step along ``axis``;
    ``v`` pre-broadcast.  See :func:`advect_muscl` for the scheme."""
    nu = (dt / dx) * v

    dm = f - torch.roll(f, 1, dims=axis)  # f_i - f_{i-1}
    dp = torch.roll(dm, -1, dims=axis)  # f_{i+1} - f_i
    # MC limiter: same-signed slopes take min(2|dm|, 2|dp|, |dm+dp|/2),
    # opposite-signed (extrema) clip to zero
    s = torch.where(
        dm * dp > 0.0,
        torch.sign(dm) * torch.minimum(
            torch.minimum(2.0 * torch.abs(dm), 2.0 * torch.abs(dp)),
            0.5 * torch.abs(dm + dp),
        ),
        0.0,
    )

    up = f + 0.5 * (1.0 - nu) * s  # left-biased face value (for v > 0)
    dn = torch.roll(f - 0.5 * (1.0 + nu) * s, -1, dims=axis)  # right-biased
    face = torch.where(v > 0.0, up, dn)  # value at i + 1/2
    flux = v * face
    return f - (dt / dx) * (flux - torch.roll(flux, 1, dims=axis))


def _as_velocity(v_x, f, shape):
    return torch.as_tensor(v_x, dtype=f.dtype, device=f.device).reshape(shape)


def advect_upwind(f: torch.Tensor, v_x, dx: float, dt: float) -> torch.Tensor:
    """One periodic first-order upwind step of ``df/dt + v_x df/dx = 0``.

    ``f`` has shape ``(Nx, Nv, Nv, Nv)`` (cells leading, velocity axes
    trailing; the first velocity axis is x).  Conservative by construction.
    """
    return _advect_upwind_axis(f, _as_velocity(v_x, f, (1, -1, 1, 1)), dx, dt, 0)


def advect_muscl(f: torch.Tensor, v_x, dx: float, dt: float) -> torch.Tensor:
    """One periodic second-order MUSCL step of ``df/dt + v_x df/dx = 0``.

    MC-limited piecewise-linear reconstruction with the Lax-Wendroff
    time-centred face value: for ``nu = v dt/dx``,

        v > 0:  face_{i+1/2} = f_i     + 0.5 (1 - nu) s_i
        v < 0:  face_{i+1/2} = f_{i+1} - 0.5 (1 + nu) s_{i+1}

    with ``s_i = minmod(2(f_i - f_{i-1}), 2(f_{i+1} - f_i),
    (f_{i+1} - f_{i-1})/2)``.  Conservative and TVD for |nu| <= 1.
    """
    return _advect_muscl_axis(f, _as_velocity(v_x, f, (1, -1, 1, 1)), dx, dt, 0)


_AXIS_SCHEMES = {"upwind": _advect_upwind_axis, "muscl": _advect_muscl_axis}


def cfl_dt(v_max: float, dx: float, safety: float = 0.9) -> float:
    """Largest stable time step for the advection substep (both schemes
    are stable and TVD for |v| dt/dx <= 1)."""
    return safety * dx / v_max


def _make_step_nd(
    cfg: CollisionConfig,
    collide_fn: Callable[[torch.Tensor, Precomp], torch.Tensor],
    *,
    deltas: Tuple[float, ...],
    dt: float,
    knudsen: float,
    scheme: str,
) -> Callable[[torch.Tensor, Precomp], torch.Tensor]:
    """Strang-split step over ``len(deltas)`` leading periodic cell axes:
    palindromic ``A0(dt/2) .. A_{n-1}(dt/2) C(dt) A_{n-1}(dt/2) .. A0(dt/2)``
    with the i-th spatial axis advected by the i-th velocity coordinate, and
    the collision substep an RK2 midpoint on ``Q / Kn``."""
    if scheme not in _AXIS_SCHEMES:
        raise ValueError(
            f"scheme must be one of {sorted(_AXIS_SCHEMES)}, got {scheme!r}"
        )
    advect = _AXIS_SCHEMES[scheme]
    ndim = len(deltas)
    g = cfg.velocity_grid
    coords = (g.vx, g.vy, g.vz)[:ndim]
    inv_kn = 1.0 / knudsen
    velocities = {}  # (device, dtype) -> broadcast coordinate tensors

    def cell_velocities(f):
        key = (f.device, f.dtype)
        if key not in velocities:
            lead = (1,) * ndim
            velocities[key] = tuple(
                _as_velocity(v, f, lead + tuple(-1 if k == i else 1 for k in range(3)))
                for i, v in enumerate(coords)
            )
        return velocities[key]

    def q_of(f, pre):
        cells = int(np.prod(f.shape[:ndim]))
        return collide_fn(f.reshape((cells,) + f.shape[ndim:]), pre).reshape(f.shape)

    def step(f, pre):
        vs = cell_velocities(f)
        for ax in range(ndim):
            f = advect(f, vs[ax], deltas[ax], 0.5 * dt, ax)
        # RK2 midpoint for the stiff-ish collision substep
        k1 = q_of(f, pre)
        f_mid = f + (0.5 * dt * inv_kn) * k1
        k2 = q_of(f_mid, pre)
        f = f + (dt * inv_kn) * k2
        for ax in reversed(range(ndim)):
            f = advect(f, vs[ax], deltas[ax], 0.5 * dt, ax)
        return f

    return step


def make_inhomogeneous_step(
    cfg: CollisionConfig,
    collide_fn: Callable[[torch.Tensor, Precomp], torch.Tensor],
    *,
    dx: float,
    dt: float,
    knudsen: float = 1.0,
    scheme: str = "muscl",
) -> Callable[[torch.Tensor, Precomp], torch.Tensor]:
    """One Strang-split 1D x 3V step ``f -> f(t + dt)`` for ``f`` of shape
    ``(Nx, Nvx, Nvy, Nvz)``: half-step advection, full-step collision (RK2
    midpoint on ``Q/Kn``), half-step advection.

    ``collide_fn(f, pre)`` takes the whole ``(cells, Nvx, Nvy, Nvz)`` stack,
    as the operator of :func:`boltzfft_torch.make_collision_operator` does.
    ``scheme``: ``"muscl"`` (second-order TVD, default) or ``"upwind"``.
    """
    return _make_step_nd(cfg, collide_fn, deltas=(dx,), dt=dt,
                         knudsen=knudsen, scheme=scheme)


def make_inhomogeneous_step_2d(
    cfg: CollisionConfig,
    collide_fn: Callable[[torch.Tensor, Precomp], torch.Tensor],
    *,
    dx: float,
    dy: float,
    dt: float,
    knudsen: float = 1.0,
    scheme: str = "muscl",
) -> Callable[[torch.Tensor, Precomp], torch.Tensor]:
    """One Strang-split 2D x 3V step for ``f`` of shape
    ``(Cx, Cy, Nvx, Nvy, Nvz)``, splitting ``Ax Ay C Ay Ax``; the collision
    substep calls ``collide_fn`` on the flattened ``(Cx*Cy, ...)`` stack."""
    return _make_step_nd(cfg, collide_fn, deltas=(dx, dy), dt=dt,
                         knudsen=knudsen, scheme=scheme)


def make_inhomogeneous_step_3d(
    cfg: CollisionConfig,
    collide_fn: Callable[[torch.Tensor, Precomp], torch.Tensor],
    *,
    dx: float,
    dy: float,
    dz: float,
    dt: float,
    knudsen: float = 1.0,
    scheme: str = "muscl",
) -> Callable[[torch.Tensor, Precomp], torch.Tensor]:
    """One Strang-split 3D x 3V step for ``f`` of shape
    ``(Cx, Cy, Cz, Nvx, Nvy, Nvz)``, splitting ``Ax Ay Az C Az Ay Ax``; the
    collision substep calls ``collide_fn`` on the flattened
    ``(Cx*Cy*Cz, ...)`` stack."""
    return _make_step_nd(cfg, collide_fn, deltas=(dx, dy, dz), dt=dt,
                         knudsen=knudsen, scheme=scheme)


def sod_initial_condition(
    cfg: CollisionConfig,
    nx: int,
    *,
    rho_left: float = 1.0,
    rho_right: float = 0.125,
    t_left: float = 1.0,
    t_right: float = 0.8,
    device="cuda",
) -> torch.Tensor:
    """Sod-type Riemann initial data: two half-domains of Maxwellians with
    different density/temperature, zero bulk velocity.  Returns
    ``(nx, Nvx, Nvy, Nvz)`` on ``device`` (the card by default;
    ``device="cpu"`` for the plain versions)."""
    rsq = cfg.velocity_grid.r_squared()
    m_left = maxwellian(rsq, density=rho_left, temperature=t_left)
    m_right = maxwellian(rsq, density=rho_right, temperature=t_right)
    f = np.where(
        (np.arange(nx) < nx // 2)[:, None, None, None], m_left[None], m_right[None]
    )
    return torch.as_tensor(f, dtype=cfg.real_dtype, device=device)


def density_profile(f: torch.Tensor, dv: float) -> torch.Tensor:
    """Per-cell number density (mass moment) of ``f`` (Nx, Nv, Nv, Nv)."""
    return torch.sum(f, dim=(1, 2, 3)) * dv**3
