"""Space-inhomogeneous 3D×3V demo: the full-phase-space kinetic Taylor-Green
vortex.

Solves ``df/dt + v·∇f = Q(f,f)/Kn`` on a periodic cube with Strang splitting
(second-order MUSCL transport on all three spatial axes, per-cell spectral
collisions): the six-dimensional phase space (Cx, Cy, Cz, Nvx, Nvy, Nvz).
The 3D Taylor-Green field

    u(x,y,z) = U0 ( sin(kx) cos(ky) cos(kz), -cos(kx) sin(ky) cos(kz), 0 )

(k = 2π/L) initializes per-cell Maxwellians, monitored by total mass, bulk
kinetic energy and the Boltzmann H functional.  One device: the collision
substep evaluates all Cx·Cy·Cz cells in one operator call, and on a card
each step and its diagnostics replay from one CUDA graph.  ``--mesh
MXxMYxMZ`` decomposes the cells over MX x MY x MZ ranks
(``transport.make_sharded_step_3d``).

    python -m boltzfft_torch.cli.taylor_green_3d3v --cells 8 --Nv 16 --steps 10
    torchrun --nproc-per-node 8 -m boltzfft_torch.cli.taylor_green_3d3v --mesh 2x2x2
"""

from __future__ import annotations

import sys
import time

import numpy as np


def taylor_green_f0_3d(cfg, nc: int, *, u0: float, temperature: float,
                       length: float = 1.0, device="cuda"):
    """Per-cell Maxwellian initial data with the 3D Taylor-Green bulk field.

    Returns ``(nc, nc, nc, Nvx, Nvy, Nvz)`` on ``device`` (the card by default;
    ``device="cpu"`` for the plain versions).
    """
    import torch

    from boltzfft_torch.bkw import maxwellian

    g = cfg.velocity_grid
    x = (np.arange(nc) + 0.5) * (length / nc)
    k = 2.0 * np.pi / length
    sx, cx = np.sin(k * x), np.cos(k * x)
    ux = u0 * sx[:, None, None] * cx[None, :, None] * cx[None, None, :]
    uy = -u0 * cx[:, None, None] * sx[None, :, None] * cx[None, None, :]
    # uz = 0 (classic TG); built cell-row by cell-row to bound host memory
    vx, vy, vz = g.vx, g.vy, g.vz
    out = np.empty((nc, nc, nc, vx.size, vy.size, vz.size), np.float64)
    vz_sq = vz[None, None, None, None, :] ** 2
    for i in range(nc):
        vsq = (
            (vx[None, None, :, None, None] - ux[i][:, :, None, None, None]) ** 2
            + (vy[None, None, None, :, None] - uy[i][:, :, None, None, None]) ** 2
            + vz_sq
        )
        out[i] = maxwellian(vsq, density=1.0, temperature=temperature)
    return torch.as_tensor(out, dtype=cfg.real_dtype, device=device)


def diagnostics_fn(cfg, d: float, device):
    """The driver's per-step monitor ``f -> [mass, bulk KE, H]`` for cells
    of side ``d``: moments reduce on the device, the host reads them after
    the run.  The bulk KE leaves out mom_z, as boltzfft's CLI does."""
    import torch

    from boltzfft_torch.moments import entropy

    g = cfg.velocity_grid
    dv3 = g.cell_volume
    cell_vol = d ** 3
    vx = torch.as_tensor(g.vx, dtype=cfg.real_dtype, device=device).reshape(1, 1, 1, -1, 1, 1)
    vy = torch.as_tensor(g.vy, dtype=cfg.real_dtype, device=device).reshape(1, 1, 1, 1, -1, 1)

    def diagnostics(f):
        rho = torch.sum(f, dim=(3, 4, 5)) * dv3
        mom_x = torch.sum(f * vx, dim=(3, 4, 5)) * dv3
        mom_y = torch.sum(f * vy, dim=(3, 4, 5)) * dv3
        ke = 0.5 * torch.sum((mom_x**2 + mom_y**2) / rho) * cell_vol
        h = torch.sum(entropy(f, cell_volume=dv3)) * cell_vol
        return torch.stack([torch.sum(rho) * cell_vol, ke, h])

    return diagnostics


def main(argv=None):
    from boltzfft_torch.cli import standard_parser, vhs_kwargs

    # Ns=12 default for the same reason as the 2D CLI: the mass drift is
    # the spherical design's quadrature error on bulk-shifted states.
    p = standard_parser(__doc__.splitlines()[0])
    p.set_defaults(Nv=16, Ns=12, impl="auto")
    p.add_argument("--cells", type=int, default=8,
                   help="spatial cells per axis (periodic cube)")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--x-length", type=float, default=1.0)
    p.add_argument("--knudsen", type=float, default=0.2)
    p.add_argument("--u0", type=float, default=0.8,
                   help="Taylor-Green bulk-velocity amplitude")
    p.add_argument("--temperature", type=float, default=3.0)
    p.add_argument("--dt", type=float, default=None,
                   help="time step (default: CFL-limited for the transport)")
    p.add_argument("--mesh", type=str, default=None, metavar="MXxMYxMZ",
                   help="spatial decomposition over MX x MY x MZ ranks, e.g. "
                        "2x2x2 (default: single device, cells batched)")
    p.add_argument("--scheme", choices=["muscl", "upwind"], default="muscl")
    p.add_argument("--conserve", action="store_true",
                   help="project every Q onto vanishing invariant moments\n(conservative): exact per-step mass/momentum/energy")
    p.add_argument("--mass-tol", type=float, default=1e-2,
                   help="relative mass-drift gate (gain-quadrature "
                        "mass-moment error on anisotropic states)")
    p.add_argument("--h-tol", type=float, default=0.01,
                   help="H-theorem gate: max allowed per-step H increase as "
                        "a fraction of the total dissipation |H_end - H_0|")
    args = p.parse_args(argv)

    from boltzfft_torch.cli import open_device, parse_mesh, ranks

    mesh_dims = parse_mesh(p, args.mesh, 3, args.cells) if args.mesh else None
    device = open_device(args.device)
    if not mesh_dims:
        return _run(args, device, None)

    import boltzfft_torch as bt

    with ranks(device):
        mesh = bt.make_mesh(list(zip(("cx", "cy", "cz"), mesh_dims)), device=device)
        return _run(args, device, mesh)


def _run(args, device, mesh):
    import torch

    import boltzfft_torch as bt
    from boltzfft_torch import transport
    from boltzfft_torch.cli import all_sum, march, report_h, resolve_impl, step_body, vhs_kwargs

    dtype = args.dtype
    cfg = bt.CollisionConfig(
        nv=args.Nv, nvy=args.Nvy, nvz=args.Nvz, ns=args.Ns,
        impl=resolve_impl(args.impl, device), dtype=dtype,
        node_chunk=args.node_chunk, n_radial=args.n_radial or args.Nv,
        **vhs_kwargs(args),
    )
    g = cfg.velocity_grid
    nc = args.cells
    d = args.x_length / nc
    dt = args.dt or transport.cfl_dt(float(np.abs(np.asarray(g.v)).max()), d)
    collide_fn, pre = bt.make_collision_operator(cfg, device=device)
    if args.conserve:
        collide_fn = bt.conservative(
            collide_fn,
            bt.build_conserve_precomp(cfg, temperature=args.temperature, device=device),
        )
    if mesh is not None:
        mx, my, mz = mesh.shape
        step = transport.make_sharded_step_3d(
            cfg, collide_fn, mesh, dx=d, dy=d, dz=d, dt=dt,
            knudsen=args.knudsen, x_axis="cx", y_axis="cy", z_axis="cz",
            scheme=args.scheme, jit=False,
        )
        mode = (f"spatial decomposition {mx}x{my}x{mz} devices, "
                f"{nc // mx}x{nc // my}x{nc // mz} cells/shard")
    else:
        step = transport.make_inhomogeneous_step_3d(
            cfg, collide_fn, dx=d, dy=d, dz=d, dt=dt, knudsen=args.knudsen,
            scheme=args.scheme,
        )
        mode = "single device, cells batched"

    f0 = taylor_green_f0_3d(cfg, nc, u0=args.u0, temperature=args.temperature,
                            length=args.x_length, device=device)
    if mesh is not None:
        f0 = bt.place_cells(f0, mesh, x_axis="cx", y_axis="cy", z_axis="cz")

    diagnostics = diagnostics_fn(cfg, d, device)
    n_cells = nc ** 3
    print(f"\nkinetic Taylor-Green 3D×3V: {nc}^3 cells x "
          f"{'x'.join(str(s) for s in cfg.grid_shape)} velocities, "
          f"Ns={args.Ns} impl={cfg.impl} dtype={dtype} scheme={args.scheme}")
    print(f"dt={dt:.4f} Kn={args.knudsen} U0={args.u0} ({mode})")

    mass0, ke0, h0 = (float(v) for v in all_sum(diagnostics(f0), mesh))
    body = step_body(step, diagnostics, device)  # one CUDA graph a step on the card
    for trial in range(args.trials):
        t0 = time.perf_counter()
        f, trace = march(body, f0, pre, args.steps)
        trace = all_sum(torch.stack(trace), mesh).cpu().numpy()  # waits for the card
        wall = time.perf_counter() - t0
        tag = " (kernel build)" if trial == 0 and args.trials > 1 else ""
        print(f"trial {trial}: {args.steps} steps in {wall:.2f}s = "
              f"{args.steps * n_cells * 2 / wall:.1f} collision evals/s "
              f"aggregate{tag}")
    mass1, ke1 = float(trace[-1, 0]), float(trace[-1, 1])

    drift = abs(mass1 - mass0) / mass0
    print(f"total mass: {mass0:.6f} -> {mass1:.6f} (rel drift {drift:.2e}; "
          f"gain-quadrature mass-moment error at Ns={cfg.ns})")
    print(f"bulk-KE: {ke0:.6f} -> {ke1:.6f} "
          f"({100.0 * ke1 / ke0:.1f}% of initial)")
    dissipated, worst_rise = report_h(h0, trace[:, 2], args.steps)
    if not (ke1 < ke0):
        print("FAIL: bulk kinetic energy must decay", file=sys.stderr)
        return 1
    if not np.isfinite(ke1) or drift > args.mass_tol:
        print("FAIL: conservation check", file=sys.stderr)
        return 1
    if not (dissipated > 0.0) or worst_rise > args.h_tol * dissipated:
        print("FAIL: H-theorem gate (entropy must dissipate monotonically "
              f"within --h-tol {args.h_tol})", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
