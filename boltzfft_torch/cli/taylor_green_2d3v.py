"""Space-inhomogeneous 2D×3V demo: the kinetic Taylor-Green vortex.

Solves ``df/dt + v·∇f = Q(f,f)/Kn`` on a periodic box with Strang splitting
(second-order MUSCL transport, per-cell spectral collisions).  The
Taylor-Green velocity field

    u(x, y) = U0 ( sin(2πx/L) cos(2πy/L), -cos(2πx/L) sin(2πy/L) )

initializes per-cell Maxwellians; the vortex decays through the coupled
kinetics (phase mixing + collisional viscosity).  One device: the collision
substep evaluates all cells in one operator call (at the default 16³
velocities with --impl auto on a card, one K1 launch), and on a card each
step and its diagnostics replay from one CUDA graph.  ``--mesh MXxMY``
decomposes the cells over MX x MY ranks (``transport.make_sharded_step_2d``:
halo exchanges between neighbours, each rank colliding its own cells).

    python -m boltzfft_torch.cli.taylor_green_2d3v --cells 16 --Nv 16 --steps 20
    torchrun --nproc-per-node 4 -m boltzfft_torch.cli.taylor_green_2d3v --mesh 2x2
"""

from __future__ import annotations

import sys
import time

import numpy as np


def taylor_green_f0(cfg, nc: int, *, u0: float, temperature: float,
                    length: float = 1.0, device="cuda"):
    """Per-cell Maxwellian initial data with the Taylor-Green bulk field.

    Returns ``(nc, nc, Nvx, Nvy, Nvz)`` on ``device`` (the card by default;
    ``device="cpu"`` for the plain versions).
    """
    import torch

    from boltzfft_torch.bkw import maxwellian

    g = cfg.velocity_grid
    x = (np.arange(nc) + 0.5) * (length / nc)
    two_pi = 2.0 * np.pi / length
    ux = u0 * np.sin(two_pi * x)[:, None] * np.cos(two_pi * x)[None, :]
    uy = -u0 * np.cos(two_pi * x)[:, None] * np.sin(two_pi * x)[None, :]
    vsq = (
        (g.vx[None, None, :, None, None] - ux[:, :, None, None, None]) ** 2
        + (g.vy[None, None, None, :, None] - uy[:, :, None, None, None]) ** 2
        + g.vz[None, None, None, None, :] ** 2
    )
    return torch.as_tensor(
        maxwellian(vsq, density=1.0, temperature=temperature),
        dtype=cfg.real_dtype, device=device,
    )


def diagnostics_fn(cfg, d: float, device):
    """The driver's per-step monitor ``f -> [mass, bulk KE, H]`` for cells
    of side ``d``: moments reduce on the device (sums over this rank's
    cells, summed over the ranks after the run), the host reads them after
    the run."""
    import torch

    from boltzfft_torch.moments import entropy

    g = cfg.velocity_grid
    dv3 = g.cell_volume
    vx = torch.as_tensor(g.vx, dtype=cfg.real_dtype, device=device).reshape(1, 1, -1, 1, 1)
    vy = torch.as_tensor(g.vy, dtype=cfg.real_dtype, device=device).reshape(1, 1, 1, -1, 1)

    def diagnostics(f):
        rho = torch.sum(f, dim=(2, 3, 4)) * dv3
        mom_x = torch.sum(f * vx, dim=(2, 3, 4)) * dv3
        mom_y = torch.sum(f * vy, dim=(2, 3, 4)) * dv3
        ke = 0.5 * torch.sum((mom_x**2 + mom_y**2) / rho) * d * d
        # total Boltzmann H = sum_cells H(f_cell) dx dy, non-increasing
        h = torch.sum(entropy(f, cell_volume=dv3)) * d * d
        return torch.stack([torch.sum(rho) * d * d, ke, h])

    return diagnostics


def main(argv=None):
    from boltzfft_torch.cli import standard_parser, vhs_kwargs

    # Ns=12 default: bulk-shifted states expose the k=0 gain/loss quadrature
    # mismatch, so mass(Q) carries the spherical design's quadrature error
    # (6.9e-3 at Ns=6, 4.7e-5 at 12, 9.6e-7 at 32 on the two-beam state).
    p = standard_parser(__doc__.splitlines()[0])
    p.set_defaults(Nv=16, Ns=12, impl="auto")
    p.add_argument("--cells", type=int, default=16,
                   help="spatial cells per axis (periodic square)")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--x-length", type=float, default=1.0)
    p.add_argument("--knudsen", type=float, default=0.2)
    p.add_argument("--u0", type=float, default=0.8,
                   help="Taylor-Green bulk-velocity amplitude")
    p.add_argument("--temperature", type=float, default=3.0)
    p.add_argument("--dt", type=float, default=None,
                   help="time step (default: CFL-limited for the transport)")
    p.add_argument("--mesh", type=str, default=None, metavar="MXxMY",
                   help="spatial decomposition over MX x MY ranks, e.g. 2x2 "
                        "(default: single device, cells batched)")
    p.add_argument("--scheme", choices=["muscl", "upwind"], default="muscl")
    p.add_argument("--conserve", action="store_true",
                   help="project every Q onto vanishing invariant moments\n(conservative): exact per-step mass/momentum/energy")
    p.add_argument("--mass-tol", type=float, default=1e-2,
                   help="relative mass-drift gate; the drift is the gain "
                        "quadrature's mass-moment error on anisotropic "
                        "states, not an advection error")
    p.add_argument("--h-tol", type=float, default=0.01,
                   help="H-theorem gate: max allowed per-step H increase as "
                        "a fraction of the total dissipation |H_end - H_0|")
    args = p.parse_args(argv)

    from boltzfft_torch.cli import open_device, parse_mesh, ranks

    mesh_dims = parse_mesh(p, args.mesh, 2, args.cells) if args.mesh else None
    device = open_device(args.device)
    if not mesh_dims:
        return _run(args, device, None)

    import boltzfft_torch as bt

    with ranks(device):
        mesh = bt.make_mesh([("cx", mesh_dims[0]), ("cy", mesh_dims[1])], device=device)
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
        mx, my = mesh.shape
        step = transport.make_sharded_step_2d(
            cfg, collide_fn, mesh, dx=d, dy=d, dt=dt, knudsen=args.knudsen,
            x_axis="cx", y_axis="cy", scheme=args.scheme, jit=False,
        )
        mode = (f"spatial decomposition {mx}x{my} devices, "
                f"{nc // mx}x{nc // my} cells/shard")
    else:
        step = transport.make_inhomogeneous_step_2d(
            cfg, collide_fn, dx=d, dy=d, dt=dt, knudsen=args.knudsen,
            scheme=args.scheme,
        )
        mode = "single device, cells batched"

    f0 = taylor_green_f0(cfg, nc, u0=args.u0, temperature=args.temperature,
                         length=args.x_length, device=device)
    if mesh is not None:
        f0 = bt.place_cells(f0, mesh, x_axis="cx", y_axis="cy")

    diagnostics = diagnostics_fn(cfg, d, device)
    print(f"\nkinetic Taylor-Green 2D×3V: {nc}x{nc} cells x "
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
              f"{args.steps * nc * nc * 2 / wall:.1f} collision evals/s "
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
