"""Space-inhomogeneous 1D×3V demo: a Sod-type kinetic shock tube.

Solves ``df/dt + v_x df/dx = Q(f,f)/Kn`` with Strang splitting (periodic
MUSCL/MC transport by default, first-order upwind via --scheme; collisions on
all cells in one operator call; on a card each step and its H replay from
one CUDA graph), printing density profiles and conservation diagnostics.  ``--mesh-cells N`` spreads the cells over N ranks: an
ensemble-sharded operator collides each rank's cells, and the advection
exchanges halos between neighbouring ranks.

    python -m boltzfft_torch.cli.sod_1d3v --Nv 16 --Ns 12 --nx 32 --steps 20
    torchrun --nproc-per-node 2 -m boltzfft_torch.cli.sod_1d3v --mesh-cells 2
"""

from __future__ import annotations

import sys
import time

import numpy as np


def main(argv=None):
    from boltzfft_torch.cli import standard_parser

    p = standard_parser(__doc__)
    p.set_defaults(impl="auto")
    p.add_argument("--nx", type=int, default=32, help="spatial cells (periodic)")
    p.add_argument("--x-length", type=float, default=1.0)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--knudsen", type=float, default=0.5)
    p.add_argument("--dt", type=float, default=None,
                   help="time step (default: CFL-limited for the transport)")
    p.add_argument("--mesh-cells", type=int, default=None,
                   help="shard cells over this many devices (ensemble axis)")
    p.add_argument("--scheme", choices=["muscl", "upwind"], default="muscl",
                   help="advection scheme (muscl = 2nd-order TVD, default)")
    p.add_argument("--conserve", action="store_true",
                   help="project every Q onto vanishing invariant moments\n(conservative): exact per-step conservation")
    p.add_argument("--h-tol", type=float, default=0.01,
                   help="H-theorem gate: max allowed per-step H increase as "
                        "a fraction of the total dissipation |H_end - H_0|")
    args = p.parse_args(argv)

    from boltzfft_torch.cli import open_device, ranks

    device = open_device(args.device)
    if not (args.mesh_cells and args.mesh_cells > 1):
        return _run(args, device, None)

    import boltzfft_torch as bt

    with ranks(device):
        mesh = bt.make_mesh([(bt.ENSEMBLE_AXIS, args.mesh_cells)], device=device)
        return _run(args, device, mesh)


def _run(args, device, mesh):
    import torch
    import torch.distributed as dist

    import boltzfft_torch as bt
    from boltzfft_torch import transport
    from boltzfft_torch.cli import all_sum, march, report_h, resolve_impl, step_body

    cfg = bt.CollisionConfig(nv=args.Nv, ns=args.Ns,
                             impl=resolve_impl(args.impl, device),
                             dtype=args.dtype, node_chunk=args.node_chunk,
                             n_radial=args.n_radial or args.Nv)
    g = cfg.velocity_grid
    dx = args.x_length / args.nx
    dt = args.dt or transport.cfl_dt(float(np.abs(np.asarray(g.v)).max()), dx)

    if mesh is not None:
        collide_fn, pre = bt.make_sharded_collision_operator(
            cfg, mesh, node_axis=None, ensemble_axis=bt.ENSEMBLE_AXIS)
    else:
        collide_fn, pre = bt.make_collision_operator(cfg, device=device)
    if args.conserve:
        collide_fn = bt.conservative(
            collide_fn, bt.build_conserve_precomp(cfg, temperature=1.0, device=device)
        )
    if mesh is not None:
        # each rank advects its block of cells, with halos from its neighbours
        step = transport._make_sharded_step_nd(
            cfg, collide_fn, mesh, deltas=(dx,), dt=dt, axes=(bt.ENSEMBLE_AXIS,),
            knudsen=args.knudsen, scheme=args.scheme, jit=False,
        )
    else:
        step = transport.make_inhomogeneous_step(
            cfg, collide_fn, dx=dx, dt=dt, knudsen=args.knudsen, scheme=args.scheme,
        )

    f = transport.sod_initial_condition(cfg, args.nx, device=device)
    mass0 = float(transport.density_profile(f, g.dv).sum())
    if mesh is not None:
        f = bt.place_cells(f, mesh, x_axis=bt.ENSEMBLE_AXIS)
    print(f"\nSod 1D×3V: nx={args.nx} dx={dx:.4f} dt={dt:.4f} "
          f"Kn={args.knudsen} Nv={args.Nv} Ns={args.Ns} impl={cfg.impl} "
          f"scheme={args.scheme}")

    def h_total(f):
        # total Boltzmann H = sum_cells H(f_cell) dx, non-increasing along
        # the kinetic evolution
        return torch.sum(bt.entropy(f, g.dv)) * dx

    h0 = float(all_sum(h_total(f), mesh))
    body = step_body(step, h_total, device)  # one CUDA graph a step on the card
    t0 = time.perf_counter()
    f, h_tr = march(body, f, pre, args.steps)
    rho = transport.density_profile(f, g.dv)
    if mesh is not None:  # the ranks' blocks of cells, in order
        parts = [torch.empty_like(rho) for _ in range(mesh.size())]
        dist.all_gather(parts, rho.contiguous(), group=mesh.get_group(bt.ENSEMBLE_AXIS))
        rho = torch.cat(parts)
    rho = rho.cpu().numpy()
    h_trace = all_sum(torch.stack(h_tr), mesh).cpu().numpy() if h_tr else np.zeros(0)
    wall = time.perf_counter() - t0
    mass1 = float(rho.sum())

    print(f"{args.steps} steps in {wall:.2f}s "
          f"({args.steps * args.nx * 2 / wall:.1f} collision evals/s aggregate)")
    print(f"total mass: {mass0:.6f} -> {mass1:.6f} "
          f"(rel drift {abs(mass1 - mass0) / mass0:.2e})")
    dissipated, worst_rise = report_h(h0, h_trace, args.steps)
    edges = np.linspace(0, args.x_length, 9)[:-1]
    sampled = rho[:: max(1, args.nx // 8)][:8]
    print("density profile (8 samples):")
    for x, r in zip(edges, sampled):
        print(f"  x={x:.3f}: rho={r:.5f}")
    if not (dissipated > 0.0) or worst_rise > args.h_tol * dissipated:
        print("FAIL: H-theorem gate (entropy must dissipate monotonically "
              f"within --h-tol {args.h_tol})", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
