"""Hot-loop (non-FFT) benchmark (mirror of ``boltzfft/cli/loop_benchmark.py``).

Times formulations of the two elementwise/contraction patterns of an eval:

  pattern 1: the broadcast multiply alpha1(b,l) * f_hat(l) (both alpha1 f
             and conj(alpha1) f), alpha built from its separable per-axis
             factors on the fly vs a materialized full table;
  pattern 2: the gain contraction sum_b w(b,l) * h_hat(b,l), as one
             reduction vs a loop accumulating node by node, and the port's
             K5 kernel (``kernels.gain_reduce``) swept over its node-block
             sizes (``--tile-size``); on the CPU K5's plain version runs.

The data are synthetic, drawn on the device from a seeded
``torch.Generator``.  Each formulation chains ``--chain`` passes per timed
call and reports the best over the trials per pass.
"""

from __future__ import annotations

import sys
import time


def main(argv=None):
    from boltzfft_torch.cli import open_device, standard_parser

    p = standard_parser(__doc__)
    p.add_argument("--chain", type=int, default=8)
    p.add_argument(
        "--tile-size", type=int, nargs="*", default=None,
        help="node-block sizes to sweep for the K5 gain_reduce kernel "
             "(default: 4 8 16)",
    )
    args = p.parse_args(argv)
    device = open_device(args.device)

    import torch

    import boltzfft_torch as bt
    from boltzfft_torch.kernels import gain_reduce as k5
    from boltzfft_torch.operator import _alpha_factors, _beta1

    cfg = bt.CollisionConfig(nv=args.Nv, ns=args.Ns, impl="c2c", dtype=args.dtype)
    pre = bt.build_precomp(cfg, device)
    n, b = cfg.nv, pre.rho.shape[0]
    trials = max(args.trials, 3)
    print(f"\nHot-loop benchmark: B={b} nodes, {n}^3 grid, dtype={args.dtype}, device={device}")

    cd, rd = cfg.complex_dtype, cfg.real_dtype
    gen = torch.Generator(device=device).manual_seed(0)

    def normal(*shape):
        return torch.randn(shape, generator=gen, dtype=rd, device=device)

    f_hat = torch.complex(normal(n, n, n), normal(n, n, n))
    h_hat = torch.complex(normal(b, n, n, n), normal(b, n, n, n))
    results = {}

    def clock():
        if device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def seconds(a, e):
        if device.type == "cuda":
            e.synchronize()
            return a.elapsed_time(e) * 1e-3
        return e - a

    def timed(label, fn, *fn_args):
        def chain():
            for _ in range(args.chain):
                fn(*fn_args)

        chain()
        best = float("inf")
        for _ in range(trials):
            a = clock()
            chain()
            best = min(best, seconds(a, clock()))
        results[label] = best / args.chain
        print(f"{label:44s} {best / args.chain:.4e} s/pass")

    # -- pattern 1: alpha-multiply ------------------------------------------
    def p1_separable(fh):
        ax, ay, az = _alpha_factors(cfg, pre, pre.rho, pre.sigma)
        a1 = ax[:, :, None, None] * ay[:, None, :, None] * az[:, None, None, :]
        return a1 * fh[None], torch.conj(a1) * fh[None]

    ax, ay, az = _alpha_factors(cfg, pre, pre.rho, pre.sigma)
    alpha_full = ax[:, :, None, None] * ay[:, None, :, None] * az[:, None, None, :]

    def p1_materialized(fh, alpha):
        return alpha * fh[None], torch.conj(alpha) * fh[None]

    timed("pattern1 alpha*f_hat (separable on-the-fly)", p1_separable, f_hat)
    timed("pattern1 alpha*f_hat (materialized table)", p1_materialized, f_hat, alpha_full)

    # -- pattern 2: gain contraction ----------------------------------------
    def weights():
        return (pre.gain_w[:, None, None, None] * _beta1(cfg, pre, pre.rho)).to(cd)

    def p2_sum(hh):
        return torch.sum(weights() * hh, dim=0)

    def p2_loop(hh):
        w = weights()
        acc = torch.zeros((n, n, n), dtype=cd, device=device)
        for i in range(b):
            acc = acc + w[i] * hh[i]
        return acc

    timed("pattern2 gain reduce (one reduction)", p2_sum, h_hat)
    timed("pattern2 gain reduce (loop accumulate)", p2_loop, h_hat)

    # -- pattern 2, the K5 kernel: node-block sweep -------------------------
    h2 = h_hat.reshape(b, -1)
    nl = pre.norm_l.reshape(-1)
    for tile in (args.tile_size if args.tile_size else (4, 8, 16)):
        def p2_k5(hh, _tile=tile):
            return k5.gain_reduce(hh, pre.rho, pre.gain_w, nl, length=cfg.domain_length,
                                  b_gamma=cfg.b_gamma, node_block=_tile)

        timed(f"pattern2 gain reduce (K5, tile={tile})", p2_k5, h2)

    best = min(results, key=results.get)
    print(f"\nFastest: {best}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
