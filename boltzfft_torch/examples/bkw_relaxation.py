"""Example: relax a BKW distribution to equilibrium and track moments.

    python -m boltzfft_torch.examples.bkw_relaxation [--Nv 32 --Ns 12 --steps 12] [--device cpu]
"""

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--Nv", type=int, default=32)
    ap.add_argument("--Ns", type=int, default=12)
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (raises without a card) or cpu")
    args = ap.parse_args(argv)

    import torch

    import boltzfft_torch as bt
    from boltzfft_torch.cli import open_device

    device = open_device(args.device)
    cfg = bt.CollisionConfig(nv=args.Nv, ns=args.Ns)
    collide, pre = bt.make_collision_operator(cfg, device=device)
    g = cfg.velocity_grid
    v = torch.as_tensor(g.v, dtype=cfg.real_dtype, device=device)

    t0, dt, steps = 5.5, 0.25, args.steps
    f0 = torch.as_tensor(bt.bkw_f(g.r_squared(), t0), dtype=cfg.real_dtype, device=device)

    run = bt.make_relaxation(
        collide, pre, dt=dt, n_steps=steps, method="rk4",
        record=lambda f: bt.moments(f, v, g.dv),
    )
    traj = run(f0)
    m = traj.recorded

    print(f"BKW relaxation, Nv={cfg.nv}, Ns={cfg.ns}, dt={dt}")
    print(f"{'t':>6} {'mass':>12} {'energy':>12} {'temperature':>12}")
    for i in range(steps):
        t = t0 + (i + 1) * dt
        print(
            f"{t:6.2f} {float(m.mass[i]):12.8f} "
            f"{float(m.energy[i]):12.8f} {float(m.temperature[i]):12.8f}"
        )

    # compare endpoint against the analytic BKW solution
    t_end = t0 + steps * dt
    err = bt.error_norms(traj.f, bt.bkw_f(g.r_squared(), t_end), g.dv)
    print(f"\nLinf vs analytic BKW at t={t_end}: {err['Linf']:.3e}")


if __name__ == "__main__":
    sys.exit(main())
