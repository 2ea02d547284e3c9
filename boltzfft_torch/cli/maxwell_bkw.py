"""BKW accuracy + performance driver (single collision eval).

Builds the BKW distribution for Maxwell molecules at t = 6.5, evaluates the
collision operator over timed trials, and prints the run statistics and the
L1/L2/Linf errors against the analytic df/dt in the reference's format.
"""

from __future__ import annotations

import sys
import time


def main(argv=None):
    from boltzfft_torch.cli import open_device, resolve_impl, standard_parser, vhs_kwargs

    args = standard_parser(__doc__).parse_args(argv)
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
    collide, pre = bt.make_collision_operator(cfg, device)
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


if __name__ == "__main__":
    sys.exit(main())
