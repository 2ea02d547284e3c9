"""Command-line drivers of the port (argparse, flags of the reference drivers).

    python -m boltzfft_torch.cli.maxwell_bkw --Nv 32 --Ns 12 --impl fused --trials 10
"""

from __future__ import annotations

import argparse
import math


def standard_parser(description: str) -> argparse.ArgumentParser:
    """Shared flags: grid, quadrature, trials, dtype, impl, device, VHS kernel."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--Nv", type=int, default=32, help="velocity grid points per axis")
    p.add_argument("--Nvy", type=int, default=None,
                   help="y-axis grid points (default: Nv)")
    p.add_argument("--Nvz", type=int, default=None,
                   help="z-axis grid points (default: Nv)")
    p.add_argument("--Ns", type=int, default=12, help="spherical design size")
    p.add_argument("-t", "--trials", type=int, default=1, help="timing trials")
    p.add_argument("--dtype", choices=["float32", "float64"], default="float64",
                   help="compute dtype")
    p.add_argument(
        "--impl", choices=["rfft", "c2c", "fused"], default="rfft",
        help="pipeline: rfft (real transforms), c2c (complex transforms), "
             "fused (the whole eval in the K1 CUDA kernel; its plain PyTorch "
             "version on --device cpu)",
    )
    p.add_argument(
        "--device", default="cuda",
        help="torch device: cuda (raises if there is no card) or cpu",
    )
    p.add_argument("--node-chunk", type=int, default=None,
                   help="quadrature nodes per staged chunk (memory/speed tradeoff)")
    p.add_argument("--n-radial", type=int, default=None,
                   help="Gauss-Legendre radial points (default: Nv)")
    p.add_argument("--gamma", type=float, default=0.0,
                   help="VHS velocity exponent (0=Maxwell, 1=hard spheres)")
    p.add_argument("--b-gamma", type=float, default=None,
                   help="VHS kernel coefficient (default 1/(4*pi))")
    p.add_argument(
        "--no-antipodal", dest="antipodal", action="store_false",
        help="evaluate all Ns spherical nodes instead of the exact "
             "antipodal-pair reduction (Ns/2 nodes, 2x weights)",
    )
    return p


def vhs_kwargs(args) -> dict:
    """CollisionConfig kwargs for the VHS kernel flags."""
    b_gamma = args.b_gamma if args.b_gamma is not None else 1.0 / (4.0 * math.pi)
    return {"gamma": args.gamma, "b_gamma": b_gamma, "antipodal": args.antipodal}
