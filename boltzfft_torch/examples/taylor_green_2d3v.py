"""Example: kinetic Taylor-Green vortex (2D×3V) on a spatial device mesh.

The classic incompressible Taylor-Green velocity field

    u(x, y) = U0 ( sin(2πx/L) cos(2πy/L), -cos(2πx/L) sin(2πy/L) )

initializes per-cell Maxwellians at uniform density/temperature.  The
vortex decays through the coupled kinetics: free-streaming phase mixing
damps the bulk flow while collisions (finite Knudsen) set the effective
viscosity of the decay (collisions alone conserve each cell's momentum —
compare a ``--knudsen 1e9`` collisionless run to see their effect on the
decay rate).  Mass is conserved to machine precision by the MUSCL
advection; the residual drift printed at the end is the gain
quadrature's mass-moment error on anisotropic (bulk-shifted) states
(vanishes with the design order: 6.9e-3 at Ns=6, 4.7e-5 at Ns=12,
9.6e-7 at Ns=32 — Nv-independent).  The cells are decomposed over the
ranks of ``torch.distributed`` (`transport.make_sharded_step_2d`: halo
exchanges between neighbouring ranks, each rank colliding its own cells,
no cross-rank traffic in the collision substep); a process started alone
is a mesh of one rank, and under a launcher there is one rank per card::

    python -m boltzfft_torch.examples.taylor_green_2d3v [--device cpu]
    torchrun --nproc-per-node 4 -m boltzfft_torch.examples.taylor_green_2d3v

Flags: --cells N (default 16), --steps N (default 12), --local runs the
unsharded single-device solver for comparison.

The command-line tool grown from this example is ``boltzfft_torch.cli.taylor_green_2d3v``
(timing trials, the full VHS/impl/aniso flag set); this file stays the
minimal readable walkthrough.
"""

import argparse
import sys

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cells", type=int, default=16, help="cells per axis")
    p.add_argument("--steps", type=int, default=12)
    p.add_argument("--nv", type=int, default=16)
    p.add_argument("--knudsen", type=float, default=0.2)
    p.add_argument("--local", action="store_true",
                   help="unsharded single-device solver")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (raises without a card) or cpu")
    args = p.parse_args(argv)

    from boltzfft_torch.cli import open_device, ranks

    from ._mesh import spatial_mesh

    device = open_device(args.device)
    if args.local:
        return _run(args, device, None)
    with ranks(device):
        return _run(args, device, spatial_mesh(args.cells, device))


def _run(args, device, mesh):
    import torch

    import boltzfft_torch as bt
    from boltzfft_torch import _graph, transport
    from boltzfft_torch.bkw import maxwellian
    from boltzfft_torch.cli import all_sum

    cfg = bt.CollisionConfig(nv=args.nv, ns=12, n_radial=6, impl="rfft")
    collide, pre = bt.make_collision_operator(cfg, device=device)
    g = cfg.velocity_grid

    nc = args.cells
    length = 1.0
    d = length / nc
    u0 = 0.8
    dt = transport.cfl_dt(float(np.abs(np.asarray(g.v)).max()), d)

    # per-cell Maxwellian with the Taylor-Green bulk velocity
    x = (np.arange(nc) + 0.5) * d
    two_pi = 2.0 * np.pi / length
    ux = u0 * np.sin(two_pi * x)[:, None] * np.cos(two_pi * x)[None, :]
    uy = -u0 * np.cos(two_pi * x)[:, None] * np.sin(two_pi * x)[None, :]
    vsq = (
        (g.vx[None, None, :, None, None] - ux[:, :, None, None, None]) ** 2
        + (g.vy[None, None, None, :, None] - uy[:, :, None, None, None]) ** 2
        + g.vz[None, None, None, None, :] ** 2
    )
    f0 = torch.as_tensor(
        maxwellian(vsq, density=1.0, temperature=3.0), dtype=cfg.real_dtype, device=device
    )  # (nc, nc, Nv, Nv, Nv)

    if mesh is None:
        step = transport.make_inhomogeneous_step_2d(
            cfg, collide, dx=d, dy=d, dt=dt, knudsen=args.knudsen
        )
        print(f"unsharded solver: {nc}x{nc} cells")
    else:
        mx, my = mesh.shape
        step = transport.make_sharded_step_2d(
            cfg, collide, mesh, dx=d, dy=d, dt=dt, knudsen=args.knudsen,
            x_axis="cx", y_axis="cy", jit=False,
        )
        f0 = bt.place_cells(f0, mesh, x_axis="cx", y_axis="cy")
        print(f"spatial decomposition: {mx}x{my} device mesh, "
              f"{nc // mx}x{nc // my} cells per shard")

    dv3 = g.cell_volume
    vx = torch.as_tensor(g.vx, dtype=cfg.real_dtype, device=device).reshape(-1, 1, 1)
    vy = torch.as_tensor(g.vy, dtype=cfg.real_dtype, device=device).reshape(1, -1, 1)

    def diagnostics(f):
        rho = torch.sum(f, dim=(2, 3, 4)) * dv3
        mx_ = torch.sum(f * vx[None, None], dim=(2, 3, 4)) * dv3
        my_ = torch.sum(f * vy[None, None], dim=(2, 3, 4)) * dv3
        # resolved (bulk-flow) kinetic energy per unit cell area, summed
        # over this rank's cells, then over the ranks
        ke = 0.5 * torch.sum((mx_**2 + my_**2) / rho) * d * d
        mass, ke = all_sum(torch.stack([torch.sum(rho) * d * d, ke]), mesh).tolist()
        return mass, ke

    # one CUDA graph a step on the card, as the JAX example jits its step
    run1 = _graph.jit(step, device)
    mass0, ke0 = diagnostics(f0)
    print(f"kinetic Taylor-Green: {nc}x{nc} cells x {cfg.nv}^3 velocities, "
          f"dt={dt:.4f}, Kn={args.knudsen}")
    print(f"step  0: mass {mass0:.6f}  bulk-KE {ke0:.6f}")
    f = f0
    for s in range(1, args.steps + 1):
        f = run1(f, pre)
        if s % max(1, args.steps // 4) == 0 or s == args.steps:
            mass, ke = diagnostics(f)
            print(f"step {s:2d}: mass {mass:.6f}  bulk-KE {ke:.6f} "
                  f"({100.0 * ke / ke0:.1f}% of initial)")
    mass1, ke1 = diagnostics(f)
    drift = abs(mass1 - mass0) / mass0
    print(f"mass drift {drift:.2e} (gain-quadrature mass-moment error at "
          f"Ns={cfg.ns}); vortex decayed to {100.0 * ke1 / ke0:.1f}% bulk-KE")
    assert ke1 < ke0, "bulk kinetic energy must decay"
    return 0


if __name__ == "__main__":
    sys.exit(main())
