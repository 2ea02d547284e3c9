"""BKW accuracy + performance driver.

Builds the BKW distribution for Maxwell molecules at t = 6.5, evaluates the
collision operator over timed trials, and prints the run statistics and the
L1/L2/Linf errors against the analytic df/dt in the reference's format.  With
``--steps N`` it instead integrates f_bkw(t0) by N RK4 steps of ``--dt`` and
compares the result with the analytic BKW f at t0 + N dt.  ``--impl ds``
runs the compensated double-single engine (both modes): the input is an exact
split of the host float64 state and the error norms are formed from the ds
result in float64.
"""

from __future__ import annotations

import sys
import time


def main(argv=None):
    from boltzfft_torch.cli import open_device, resolve_impl, standard_parser, vhs_kwargs

    p = standard_parser(__doc__)
    p.add_argument("--steps", type=int, default=0,
                   help="RK4 relaxation steps (0 = single operator eval)")
    p.add_argument("--dt", type=float, default=0.125, help="RK4 step size")
    p.add_argument("--t0", type=float, default=5.5,
                   help="BKW start time for relaxation mode")
    args = p.parse_args(argv)
    device = open_device(args.device)

    import torch

    import boltzfft_torch as bt

    print("\nRun arguments:")
    print(f"Nv = {args.Nv}")
    print(f"Ns = {args.Ns}")
    print(f"trials = {args.trials}")
    impl = resolve_impl(args.impl, device)
    print(f"dtype = {args.dtype}, impl = {impl}, device = {device}")
    if device.type == "cuda":
        print(f"card = {torch.cuda.get_device_name(device)}")
    if impl == "ds":
        return _run_ds(args, device)

    cfg = bt.CollisionConfig(
        nv=args.Nv, nvy=args.Nvy, nvz=args.Nvz, ns=args.Ns, impl=impl,
        dtype=args.dtype, node_chunk=args.node_chunk, n_radial=args.n_radial,
        **vhs_kwargs(args),
    )
    if args.gamma != 0.0:
        print("note: BKW error report is only meaningful for Maxwell molecules (gamma=0)")
    g = cfg.velocity_grid
    rsq = g.r_squared()

    t0 = time.perf_counter()
    collide, pre = bt.make_collision_operator(cfg, device=device)

    if args.steps > 0:
        # RK4 relaxation from f_bkw(t0), moments recorded after every step
        t_end = args.t0 + args.steps * args.dt
        f0 = torch.as_tensor(bt.bkw_f(rsq, args.t0), dtype=cfg.real_dtype, device=device)
        v = g.v if cfg.is_isotropic else (g.vx, g.vy, g.vz)
        run = bt.make_relaxation(
            collide, pre, dt=args.dt, n_steps=args.steps, method="rk4",
            record=lambda x: bt.moments(x, v, cell_volume=g.cell_volume),
        )
        traj = run(f0)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        mass = traj.recorded.mass
        energy = traj.recorded.energy
        print(f"Relaxation: {args.steps} RK4 steps of dt={args.dt} "
              f"(t {args.t0} -> {t_end}), build+run {time.perf_counter() - t0:.3g}s")
        print(f"mass drift: {float((mass - mass[0]).abs().max()):.3e}, "
              f"energy drift: {float((energy - energy[0]).abs().max()):.3e}")
        err = bt.error_norms_device(traj.f, bt.bkw_f(rsq, t_end), cell_volume=g.cell_volume)
        print("Relaxation errors vs analytic BKW f(t_end):")
        print(f"L1 error: {err['L1']:.6g}")
        print(f"L2 error: {err['L2']:.6g}")
        print(f"Linf error: {err['Linf']:.6g}\n")
        return 0

    f = torch.as_tensor(bt.bkw_f(rsq, 6.5), dtype=cfg.real_dtype, device=device)
    q = collide(f, pre)  # kernel build (first use) + first eval
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print(f"Initialization time (s): {time.perf_counter() - t0:.6g} seconds")

    if args.trials > 0:
        stats, q = bt.time_fn(
            collide, f, pre, device=device, trials=args.trials, warmup=1
        )
        print(stats.summary(f"boltzfft_torch/{impl}"))

    err = bt.error_norms_device(q, bt.bkw_dfdt(rsq, 6.5), cell_volume=g.cell_volume)
    print("Approximation errors:")
    print(f"L1 error: {err['L1']:.6g}")
    print(f"L2 error: {err['L2']:.6g}")
    print(f"Linf error: {err['Linf']:.6g}\n")
    return 0


def _run_ds(args, device):
    """Compensated double-single evaluation (``boltzfft_torch.ds_operator``):
    ``f`` split exactly from host float64, the norms of ``Q - Q_bkw`` (or of
    ``f(t_end) - f_bkw(t_end)``) from the ds pairs in float64."""
    import torch

    import boltzfft_torch as bt
    from boltzfft_torch import ds
    from boltzfft_torch.cli import vhs_kwargs
    from boltzfft_torch.ds_operator import make_ds_collision_operator

    cfg = bt.CollisionConfig(
        nv=args.Nv, nvy=args.Nvy, nvz=args.Nvz, ns=args.Ns, impl="c2c",
        dtype="float32", n_radial=args.n_radial, **vhs_kwargs(args),
    )
    g = cfg.velocity_grid
    rsq = g.r_squared()
    split = lambda a: ds.from_f64(a, torch.float32, device)
    dv3 = g.cell_volume

    def norms(x, exact):
        d = ds.sub(x, exact)
        ad = (d.hi.double() + d.lo.double()).abs()
        return (float(dv3 * ad.sum()), float(torch.sqrt(dv3 * (ad * ad).sum())), float(ad.max()))

    t0 = time.perf_counter()
    collide_fn, pre = make_ds_collision_operator(
        cfg, contract=args.ds_contract, oz_cmax=args.oz_cmax, g_stream=args.g_stream,
        group_batch=args.group_batch,
        oz_merge=None if args.oz_merge is None else args.oz_merge == "on",
        gmain_fused={"auto": None, "off": False}.get(args.gmain_fused, args.gmain_fused),
        g1_reversal=args.g1_reversal or None, device=device,
    )

    if args.steps > 0:
        t_end = args.t0 + args.steps * args.dt
        run = bt.make_relaxation(collide_fn, pre, dt=args.dt, n_steps=args.steps, method="rk4")
        traj = run(split(bt.bkw_f(rsq, args.t0)))
        l1, l2, linf = norms(traj.f, split(bt.bkw_f(rsq, t_end)))
        print(f"Relaxation (ds): {args.steps} RK4 steps of dt={args.dt} "
              f"(t {args.t0} -> {t_end}), build+run {time.perf_counter() - t0:.3g}s")
        print("Relaxation errors vs analytic BKW f(t_end):")
        print(f"L1 error: {l1:.6g}")
        print(f"L2 error: {l2:.6g}")
        print(f"Linf error: {linf:.6g}\n")
        return 0

    f_ds = split(bt.bkw_f(rsq, 6.5))
    q_ex = split(bt.bkw_dfdt(rsq, 6.5))
    q = collide_fn(f_ds, pre)  # kernel build (first use) + first eval
    l1, l2, linf = norms(q, q_ex)
    print(f"Initialization time (s): {time.perf_counter() - t0:.6g} seconds")
    if args.trials > 0:
        stats, _ = bt.time_fn(collide_fn, f_ds, pre, device=device, trials=args.trials, warmup=1)
        print(stats.summary("boltzfft_torch/ds"))
    print("Approximation errors:")
    print(f"L1 error: {l1:.6g}")
    print(f"L2 error: {l2:.6g}")
    print(f"Linf error: {linf:.6g}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
