"""Example: 2D×3V kinetic mixing — a density blob shearing in periodic flow.

Two Maxwellian populations with opposite bulk x-velocities stacked in y
shear a density perturbation while collisions (Kn = 0.5) drive each cell
toward local equilibrium.  Demonstrates the 2D Strang-split solver
(`transport.make_inhomogeneous_step_2d`: MUSCL advection along both
spatial axes + per-cell collisions) and conservation diagnostics.

    python -m boltzfft_torch.examples.mixing_2d3v [--device cpu]

Pass ``--shard`` to run the same problem spatially decomposed over the
ranks of ``torch.distributed`` (`transport.make_sharded_step_2d`: halo
exchanges between neighbouring ranks, each rank colliding its own cells);
a process started alone is a mesh of one rank, and under a launcher there
is one rank per card (``--device cpu``: gloo ranks)::

    torchrun --nproc-per-node 4 -m boltzfft_torch.examples.mixing_2d3v --shard
"""

import argparse
import sys

import numpy as np

CELLS = 12  # cells per spatial axis (the JAX example's nx = ny)
STEPS = 8


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--shard", action="store_true",
                   help="decompose the cells over the ranks of torch.distributed")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (raises without a card) or cpu")
    args = p.parse_args(argv)

    from boltzfft_torch.cli import open_device, ranks

    from ._mesh import spatial_mesh

    device = open_device(args.device)
    if not args.shard:
        return _run(device, None)
    with ranks(device):
        return _run(device, spatial_mesh(CELLS, device))


def _run(device, mesh):
    import torch

    import boltzfft_torch as bt
    from boltzfft_torch import _graph, transport
    from boltzfft_torch.bkw import maxwellian

    from ._mesh import gather_cells

    cfg = bt.CollisionConfig(nv=16, ns=6, n_radial=6, impl="rfft")
    collide, pre = bt.make_collision_operator(cfg, device=device)
    g = cfg.velocity_grid

    nx = ny = CELLS
    lx = ly = 1.0
    dx, dy = lx / nx, ly / ny
    dt = transport.cfl_dt(float(np.abs(np.asarray(g.v)).max()), min(dx, dy))
    steps = STEPS

    # density blob on a shear background: top half drifts +x, bottom -x
    x = (np.arange(nx) + 0.5) * dx
    y = (np.arange(ny) + 0.5) * dy
    blob = 1.0 + 0.5 * np.exp(
        -((x[:, None] - 0.5) ** 2 + (y[None, :] - 0.5) ** 2) / 0.02
    )  # (nx, ny)
    vsq_up = ((g.vx[:, None, None] - 1.0) ** 2 + g.vy[None, :, None] ** 2
              + g.vz[None, None, :] ** 2)
    vsq_dn = ((g.vx[:, None, None] + 1.0) ** 2 + g.vy[None, :, None] ** 2
              + g.vz[None, None, :] ** 2)
    m_up = maxwellian(vsq_up, density=1.0, temperature=3.0)
    m_dn = maxwellian(vsq_dn, density=1.0, temperature=3.0)
    shear = np.where((np.arange(ny) < ny // 2)[:, None, None, None], m_dn, m_up)
    f0 = torch.as_tensor(
        blob[:, :, None, None, None] * shear[None], dtype=cfg.real_dtype, device=device
    )  # (nx, ny, Nv, Nv, Nv)

    dv3 = g.cell_volume
    rho0 = (torch.sum(f0, dim=(2, 3, 4)) * dv3).cpu().numpy()
    if mesh is not None:
        mx, my = mesh.shape
        print(f"spatial decomposition: {mx}x{my} device mesh, "
              f"{nx // mx}x{ny // my} cells per shard")
        step = transport.make_sharded_step_2d(
            cfg, collide, mesh, dx=dx, dy=dy, dt=dt, knudsen=0.5,
            x_axis="cx", y_axis="cy", jit=False,
        )
        f0 = bt.place_cells(f0, mesh, x_axis="cx", y_axis="cy")
    else:
        step = transport.make_inhomogeneous_step_2d(
            cfg, collide, dx=dx, dy=dy, dt=dt, knudsen=0.5
        )

    # one CUDA graph a step on the card (the JAX example jits the step loop)
    run = _graph.jit(step, device)
    f1 = f0
    for _ in range(steps):
        f1 = run(f1, pre)
    rho1 = torch.sum(f1, dim=(2, 3, 4)) * dv3
    if mesh is not None:
        rho1 = gather_cells(rho1, mesh)
    rho1 = rho1.cpu().numpy()

    print(f"2D×3V mixing: {nx}x{ny} cells, {cfg.nv}^3 velocities, "
          f"{steps} Strang steps of dt={dt:.4f} (Kn=0.5)")
    print(f"total mass {rho0.sum():.6f} -> {rho1.sum():.6f} "
          f"(rel drift {abs(rho1.sum() - rho0.sum()) / rho0.sum():.2e})")
    print(f"density contrast (max/min): {rho0.max()/rho0.min():.3f} -> "
          f"{rho1.max()/rho1.min():.3f}  (shear + collisions mix the blob)")
    row = rho1[:, ny // 4]
    print("density sample (y = L/4 row):",
          " ".join(f"{r:.3f}" for r in row[:: max(1, nx // 8)]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
