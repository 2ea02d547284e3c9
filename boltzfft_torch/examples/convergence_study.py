"""Example: spectral convergence of Q(f, f) against the analytic BKW rate.

Sweeps the velocity resolution at fixed quadrature and prints the L1/L2/Linf
error ladder, the study behind the reference's accuracy tables
(``Results/maxwell_bkw_fftw_atomics.txt``): the error falls spectrally
(faster than any power of 1/Nv) until it hits the quadrature or arithmetic
floor.  Each row is one float64 eval of the staged rfft pipeline (cuFFT on
the card), replayed from a CUDA graph there.

    python -m boltzfft_torch.examples.convergence_study [--max-nv 64] [--device cpu]
"""

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--max-nv", type=int, default=64,
                    help="largest grid in the ladder (64 = full study)")
    ap.add_argument("--Ns", type=int, default=12)
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (raises without a card) or cpu")
    args = ap.parse_args(argv)

    import torch

    import boltzfft_torch as bt
    from boltzfft_torch.cli import open_device

    device = open_device(args.device)
    print(f"{'Nv':>4} {'L1':>12} {'L2':>12} {'Linf':>12}")
    for nv in (8, 16, 24, 32, 48, 64):
        if nv > args.max_nv:
            break
        cfg = bt.CollisionConfig(nv=nv, ns=args.Ns, n_radial=nv)
        collide, pre = bt.make_collision_operator(cfg, device=device)
        g = cfg.velocity_grid
        rsq = g.r_squared()
        f = torch.as_tensor(bt.bkw_f(rsq, 6.5), dtype=cfg.real_dtype, device=device)
        q = collide(f, pre)
        err = bt.error_norms(q, bt.bkw_dfdt(rsq, 6.5), g.dv)
        print(f"{nv:4d} {err['L1']:12.4e} {err['L2']:12.4e} {err['Linf']:12.4e}")
        del collide, pre, q
    print("\n(spectral decay to the f64 floor; 64^3 reference: Linf 3.0685e-12)")


if __name__ == "__main__":
    sys.exit(main())
