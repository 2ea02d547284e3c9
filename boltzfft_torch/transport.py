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

:func:`make_sharded_step_2d` and :func:`make_sharded_step_3d` decompose the
cell grid over the dims of a mesh (:mod:`boltzfft_torch.sharding`): each rank
advects its block extended by a halo from its neighbours (ring sends and
receives, :func:`_halo_exchange`) and collides its own cells; built with
``jit=True`` on a CUDA mesh, a step replays from one CUDA graph.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from . import obs
from .bkw import maxwellian
from .weights import CollisionConfig, Precomp

#: The cell axes' names in spans (``advect.x``, ``halo.y``).
AXES = "xyz"


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
    halos: Optional[Tuple[Optional[Callable], ...]] = None,
) -> Callable[[torch.Tensor, Precomp], torch.Tensor]:
    """Strang-split step over ``len(deltas)`` leading periodic cell axes:
    palindromic ``A0(dt/2) .. A_{n-1}(dt/2) C(dt) A_{n-1}(dt/2) .. A0(dt/2)``
    with the i-th spatial axis advected by the i-th velocity coordinate, and
    the collision substep an RK2 midpoint on ``Q / Kn``.

    ``halos``: per cell axis, ``None`` (the axis is whole and periodic) or
    ``halo(f, axis, width)``, which returns ``f`` extended by ``width``
    cells on each side along ``axis``; the stencil then runs on the
    extended block and keeps its interior, the same arithmetic per cell.
    Each advection is the :mod:`obs` span ``advect.<axis>``."""
    if scheme not in _AXIS_SCHEMES:
        raise ValueError(
            f"scheme must be one of {sorted(_AXIS_SCHEMES)}, got {scheme!r}"
        )
    scheme_advect = _AXIS_SCHEMES[scheme]
    halo_w = 2 if scheme == "muscl" else 1
    ndim = len(deltas)
    halos = halos or (None,) * ndim

    def advect(f, v, d, dtt, axis):
        with obs.span(f"advect.{AXES[axis]}", like=f):
            if halos[axis] is None:
                return scheme_advect(f, v, d, dtt, axis)
            ext = halos[axis](f, axis, halo_w)
            return scheme_advect(ext, v, d, dtt, axis).narrow(axis, halo_w, f.shape[axis])

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


def _halo_exchange(f: torch.Tensor, axis: int, width: int, mesh, axis_name: str) -> torch.Tensor:
    """Periodic halo exchange along the mesh dim ``axis_name``: ``f``
    extended by ``width`` cells from each neighbouring rank along ``axis``
    (a ring: the global periodic boundary is the ring's closure).  Each rank
    sends its trailing cells to its right neighbour, where they become the
    left halo, and its leading cells to its left neighbour; a dim of one
    rank copies its own edges (a rank cannot send to itself).  A gloo group
    moves a card's cells through host copies (gloo sends no CUDA tensor
    point to point).  The whole exchange is the :mod:`obs` span
    ``halo.<axis>``."""
    from .sharding import axis_index, axis_size

    with obs.span(f"halo.{AXES[axis]}", like=f):
        n = axis_size(mesh, axis_name)
        m = f.shape[axis]
        lo = f.narrow(axis, 0, width).contiguous()
        hi = f.narrow(axis, m - width, width).contiguous()
        if n == 1:
            left, right = hi, lo
        else:
            group = mesh.get_group(axis_name)
            if f.is_cuda and dist.get_backend(group) == "gloo":  # gloo sends host tensors only
                hi, lo = hi.cpu(), lo.cpu()
            ranks = dist.get_process_group_ranks(group)
            k = axis_index(mesh, axis_name)
            left, right = torch.empty_like(hi), torch.empty_like(lo)
            to_right, to_left = ranks[(k + 1) % n], ranks[(k - 1) % n]
            ops = [  # tag 1: trailing cells going right; tag 2: leading cells going left
                dist.P2POp(dist.isend, hi, to_right, group, 1),
                dist.P2POp(dist.irecv, left, to_left, group, 1),
                dist.P2POp(dist.isend, lo, to_left, group, 2),
                dist.P2POp(dist.irecv, right, to_right, group, 2),
            ]
            for work in dist.batch_isend_irecv(ops):
                work.wait()
            left, right = left.to(f.device), right.to(f.device)
        return torch.cat([left, f, right], dim=axis)


def _make_sharded_step_nd(
    cfg: CollisionConfig,
    collide_fn: Callable[[torch.Tensor, Precomp], torch.Tensor],
    mesh,
    *,
    deltas: Tuple[float, ...],
    dt: float,
    axes: Tuple[Optional[str], ...],
    knudsen: float,
    scheme: str,
    jit: bool,
) -> Callable[[torch.Tensor, Precomp], torch.Tensor]:
    """The N-dimensional decomposed Strang step (see
    :func:`make_sharded_step_2d`): :func:`_make_step_nd`'s arithmetic, each
    sharded axis advected on its block extended by :func:`_halo_exchange`
    (width 2 for MUSCL, 1 for upwind), the collisions on the rank's own
    cells.  ``jit=True`` on a CUDA mesh replays the whole step from one
    CUDA graph (:func:`boltzfft_torch.sharding._replay`): the transport,
    the halo exchanges and the operator's kernels (``collide_fn`` runs
    eagerly inside the capture); the bits of ``jit=False``, which runs the
    step eagerly around the operator.  A mesh whose exchanges cannot be
    captured (a gloo group of several ranks holding CUDA tensors) raises
    here: pass ``jit=False``.  On the CPU ``jit`` changes nothing."""
    from .sharding import _replay, axis_size, mesh_device

    if scheme not in _AXIS_SCHEMES:
        raise ValueError(
            f"scheme must be one of {sorted(_AXIS_SCHEMES)}, got {scheme!r}"
        )
    for name in axes:
        axis_size(mesh, name)

    def exchange(name):
        def halo(f, axis, width):
            if f.shape[axis] < width:
                raise ValueError(
                    f"local cell block of {f.shape[axis]} along axis {axis} is "
                    f"smaller than the {scheme!r} stencil's halo width "
                    f"{width}; use more cells or fewer shards on that axis"
                )
            return _halo_exchange(f, axis, width, mesh, name)

        return halo

    step = _make_step_nd(
        cfg, collide_fn, deltas=deltas, dt=dt, knudsen=knudsen, scheme=scheme,
        halos=tuple(None if name is None else exchange(name) for name in axes),
    )
    if not (jit and mesh_device(mesh).type == "cuda"):
        return step
    groups = [mesh.get_group(name) for name in axes
              if name is not None and axis_size(mesh, name) > 1]
    return _replay(step, groups, f"make_sharded_step_{len(deltas)}d",
                   f"sharded_step_{len(deltas)}d")


def make_sharded_step_2d(
    cfg: CollisionConfig,
    collide_fn: Callable[[torch.Tensor, Precomp], torch.Tensor],
    mesh,
    *,
    dx: float,
    dy: float,
    dt: float,
    x_axis: Optional[str] = None,
    y_axis: Optional[str] = None,
    knudsen: float = 1.0,
    scheme: str = "muscl",
    jit: bool = True,
) -> Callable[[torch.Tensor, Precomp], torch.Tensor]:
    """2D x 3V Strang step with the cell grid ``(Cx, Cy)`` decomposed over
    the mesh dims ``x_axis`` / ``y_axis`` (``None``: that direction whole
    on every rank).

    ``step(f, pre)`` takes and returns this rank's block ``(Cx/mx, Cy/my,
    Nvx, Nvy, Nvz)`` (:func:`boltzfft_torch.place_cells`).  The advection
    runs on the block extended by a halo from the neighbouring ranks; the
    collision substep calls ``collide_fn`` (an unsharded operator) on the
    block's own cells, with no cross-rank traffic.  Every velocity
    transform stays on its rank.

    ``jit=True`` (JAX's default) on a CUDA mesh replays each step from one
    CUDA graph, the exchanges and the operator's kernels in it, with the
    eager step's bits; over gloo ranks holding CUDA tensors it raises when
    the step is built (pass ``jit=False``).  On the CPU ``jit`` changes
    nothing."""
    return _make_sharded_step_nd(
        cfg, collide_fn, mesh, deltas=(dx, dy), dt=dt,
        axes=(x_axis, y_axis), knudsen=knudsen, scheme=scheme, jit=jit,
    )


def make_sharded_step_3d(
    cfg: CollisionConfig,
    collide_fn: Callable[[torch.Tensor, Precomp], torch.Tensor],
    mesh,
    *,
    dx: float,
    dy: float,
    dz: float,
    dt: float,
    x_axis: Optional[str] = None,
    y_axis: Optional[str] = None,
    z_axis: Optional[str] = None,
    knudsen: float = 1.0,
    scheme: str = "muscl",
    jit: bool = True,
) -> Callable[[torch.Tensor, Precomp], torch.Tensor]:
    """3D x 3V Strang step with the cell grid ``(Cx, Cy, Cz)`` decomposed
    over up to three mesh dims; as :func:`make_sharded_step_2d`, with
    ``f`` this rank's block ``(Cx/mx, Cy/my, Cz/mz, Nvx, Nvy, Nvz)``."""
    return _make_sharded_step_nd(
        cfg, collide_fn, mesh, deltas=(dx, dy, dz), dt=dt,
        axes=(x_axis, y_axis, z_axis), knudsen=knudsen, scheme=scheme, jit=jit,
    )


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
