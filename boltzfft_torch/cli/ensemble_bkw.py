"""Sharded-ensemble relaxation driver (BASELINE config 5).

Relaxes an ensemble of independent BKW distributions, a proxy for the cells
of a 0D-3V space-inhomogeneous solve, sharded over the ranks (ensemble x
node mesh dims), with the moments tracked on the device.  One rank per
device, under a launcher such as ``torchrun``; a single process is a mesh
of one rank.

    python -m boltzfft_torch.cli.ensemble_bkw --ensemble 256 --Nv 32 --impl fused --steps 2
    torchrun --nproc-per-node 4 -m boltzfft_torch.cli.ensemble_bkw --ensemble 256 --ens-mesh 2
"""

from __future__ import annotations

import sys
import time

import numpy as np


def main(argv=None):
    from boltzfft_torch.cli import standard_parser

    p = standard_parser(__doc__)
    p.add_argument("--ensemble", type=int, default=8, help="number of distributions")
    p.add_argument("--steps", type=int, default=5, help="RK4 steps")
    p.add_argument("--dt", type=float, default=0.1)
    p.add_argument("--ens-mesh", type=int, default=None,
                   help="ranks on the ensemble axis (default: all); the rest "
                        "shard the quadrature nodes")
    p.add_argument("--checkpoint-dir", default=None,
                   help="checkpoint directory; resumes from the latest step if "
                        "one exists")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="RK4 steps between checkpoints (0 = only at the end)")
    p.add_argument("--h-tol", type=float, default=0.01,
                   help="H-theorem gate: max allowed per-step H rise as a "
                        "fraction of that member's total dissipation (tail-"
                        "quadrature noise makes coarse grids, Nv<32, mildly "
                        "non-monotone on exact BKW data)")
    args = p.parse_args(argv)

    from boltzfft_torch.cli import open_device, ranks

    device = open_device(args.device)

    import torch.distributed as dist

    import boltzfft_torch as bt

    with ranks(device):
        world = dist.get_world_size() if dist.is_initialized() else 1
        ens_mesh = args.ens_mesh or world
        node_mesh = world // ens_mesh
        if args.ensemble % ens_mesh:
            raise SystemExit(f"--ensemble {args.ensemble} must divide by ensemble mesh {ens_mesh}")
        axes = [(bt.ENSEMBLE_AXIS, ens_mesh)]
        if node_mesh > 1:
            axes.append((bt.NODE_AXIS, node_mesh))
        return _run(args, bt.make_mesh(axes, device=device), node_mesh)


def _extremes(x):
    """(min, max) of a tensor over every rank."""
    import torch
    import torch.distributed as dist

    lo = torch.stack([x.min(), -x.max()]).to(torch.float64)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN)
    return float(lo[0]), -float(lo[1])


def _run(args, mesh, node_mesh):
    import torch
    import torch.distributed as dist

    import boltzfft_torch as bt
    from boltzfft_torch.cli import resolve_impl

    device = bt.sharding.mesh_device(mesh)
    dtype = args.dtype
    print(f"\nEnsemble relaxation: E={args.ensemble}, Nv={args.Nv}, Ns={args.Ns}, "
          f"mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))}, dtype={dtype}")

    cfg = bt.CollisionConfig(nv=args.Nv, ns=args.Ns, impl=resolve_impl(args.impl, device),
                             dtype=dtype, node_chunk=args.node_chunk)
    node_axis = bt.NODE_AXIS if node_mesh > 1 else None
    collide_fn, pre = bt.make_sharded_collision_operator(
        cfg, mesh, node_axis=node_axis, ensemble_axis=bt.ENSEMBLE_AXIS)
    pre = bt.place(pre, mesh, node_axis=node_axis)

    g = cfg.velocity_grid
    rsq = g.r_squared()
    # an ensemble of BKW states at staggered times (independent
    # distributions); this rank builds its own block
    ts = 5.5 + 2.0 * np.arange(args.ensemble) / max(args.ensemble, 1)
    size = args.ensemble // bt.sharding.axis_size(mesh, bt.ENSEMBLE_AXIS)
    start = bt.sharding.axis_index(mesh, bt.ENSEMBLE_AXIS) * size
    f0 = torch.as_tensor(np.stack([bt.bkw_f(rsq, t) for t in ts[start:start + size]]),
                         dtype=cfg.real_dtype, device=device)
    v = g.v

    if args.checkpoint_dir:
        return _run_checkpointed(args, bt, collide_fn, pre, f0, v, g)

    run = bt.make_relaxation(
        collide_fn, pre, dt=args.dt, n_steps=args.steps, method="rk4",
        record=lambda f: (bt.moments(f, v, g.dv), bt.entropy(f, g.dv)),
    )

    def timed():
        dist.barrier()
        t0 = time.perf_counter()
        traj = run(f0)
        traj.recorded[0].mass.cpu()  # waits for the card
        dist.barrier()
        return traj, time.perf_counter() - t0

    traj, first_call = timed()
    traj, run_time = timed()

    evals = args.ensemble * args.steps * 4  # RK4: 4 collision evals/step
    print(f"first call (compile+run): {first_call:.3f}s; steady run: {run_time:.4f}s")
    print(f"collision evals: {evals} -> {evals / run_time:.1f} evals/s aggregate")
    moms = traj.recorded[0]
    print("final mass range: [{:.6f}, {:.6f}]".format(*_extremes(moms.mass[-1])))
    print("final temperature range: [{:.6f}, {:.6f}]".format(
        *_extremes(moms.temperature[-1])))
    # H-theorem monitor: per-member H traces (steps, E) must dissipate
    # monotonically along the homogeneous relaxation
    h = traj.recorded[1].to(torch.float64)
    h0 = bt.entropy(f0, g.dv).to(torch.float64)
    h_steps = torch.diff(torch.cat([h0[None], h]), dim=0)
    dissipated = h0 - h[-1]  # per member
    h0_lo, h0_hi = _extremes(h0)
    h1_lo, h1_hi = _extremes(h[-1])
    worst = _extremes(h_steps)[1]
    print(f"H range: [{h0_lo:.6f}, {h0_hi:.6f}] -> [{h1_lo:.6f}, {h1_hi:.6f}] "
          f"(worst per-step rise {worst:.3e})")
    ok = torch.tensor(float(bool(
        torch.all(dissipated > 0.0)
        and torch.all(h_steps.max(dim=0).values <= args.h_tol * dissipated))),
        dtype=torch.float64, device=device)
    dist.all_reduce(ok, op=dist.ReduceOp.MIN)
    if not float(ok):
        print("FAIL: H-theorem gate (every member's H must dissipate "
              f"monotonically within --h-tol {args.h_tol})", file=sys.stderr)
        return 1
    return 0


def _run_checkpointed(args, bt, collide_fn, pre, f0, v, g):
    """Segmented relaxation with checkpoint/resume, the long-run path on
    capacity that can be taken away: resumes from the latest step in
    ``--checkpoint-dir`` when there is one."""
    seg = args.checkpoint_every or args.steps
    # a segment of k steps is k one-step runs: the last (or a resumed,
    # misaligned) segment is min(seg, remaining) steps, so the checkpointed
    # trajectory is step for step an uninterrupted run's (no overshoot past
    # --steps), and one step's CUDA graph serves every segment length
    run1 = bt.make_relaxation(
        collide_fn, pre, dt=args.dt, n_steps=1, method="rk4",
        record=lambda f: bt.moments(f, v, g.dv),
    )

    with bt.RelaxCheckpointer(args.checkpoint_dir) as ck:
        start, t_sim, f = 0, 0.0, f0
        latest = ck.latest_step()
        if latest is not None:
            f, t_sim = ck.restore(latest, template=f0)
            start = latest
            print(f"resumed from step {start} (t = {t_sim:.4f})")
        step = start
        t0 = time.perf_counter()
        while step < args.steps:
            this_seg = min(seg, args.steps - step)
            for _ in range(this_seg):
                traj = run1(f)
                f = traj.f
            step += this_seg
            t_sim += this_seg * args.dt
            ck.save(step, f, t_sim)
            print(f"step {step}/{args.steps} t={t_sim:.4f} "
                  "mass=[{:.6f}, {:.6f}]".format(*_extremes(traj.recorded.mass[-1])))
        ck.wait()
        wall = time.perf_counter() - t0
    done = max(args.steps - start, 0)
    evals = args.ensemble * done * 4
    if done:
        print(f"{done} steps ({evals} collision evals) in {wall:.2f}s "
              f"incl. checkpoint I/O; state in {args.checkpoint_dir}")
    else:
        print("nothing to do: checkpoint already at final step")
    return 0


if __name__ == "__main__":
    sys.exit(main())
