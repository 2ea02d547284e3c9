"""Batched 3-D FFT microbenchmark (mirror of ``boltzfft/cli/fft_benchmark.py``).

Compares transform variants on one batch of ``Ns * Nv`` grids of ``Nv^3``
(the reference's batch size): c2c vs rfft round trips, the whole batch at
once vs a loop over 4 chunks.  Each variant chains ``--chain`` round trips
per timed call (CUDA events on a card, the host clock on the CPU) and
reports the best over the trials per round trip, with the round trip's mean
absolute error.  A variant that does not fit prints a ``FAILED`` line and
the sweep goes on.
"""

from __future__ import annotations

import sys
import time


def main(argv=None):
    from boltzfft_torch.cli import open_device, standard_parser

    p = standard_parser(__doc__)
    p.add_argument("--chain", type=int, default=8, help="FFT round trips per timed call")
    args = p.parse_args(argv)
    device = open_device(args.device)

    import torch

    import boltzfft_torch as bt

    n, batch = args.Nv, args.Ns * args.Nv
    trials = max(args.trials, 3)
    print(f"\nBatched 3D FFT benchmark: batch={batch} of {n}^3, dtype={args.dtype},"
          f" chain={args.chain}, device={device}")
    rd = torch.float64 if args.dtype == "float64" else torch.float32
    cd = torch.complex128 if args.dtype == "float64" else torch.complex64
    g = bt.VelocityGrid(nv=n, length=bt.domain_from_support()[1])
    one = torch.as_tensor(bt.bkw_f(g.r_squared(), 6.5), dtype=rd, device=device)
    x = one.expand(batch, n, n, n).contiguous()
    axes = (-3, -2, -1)
    results = {}

    def clock():
        if device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def seconds(a, b):
        if device.type == "cuda":
            b.synchronize()
            return a.elapsed_time(b) * 1e-3
        return b - a

    def timed(label, fn, arg):
        def chain():
            y = arg
            for _ in range(args.chain):
                y = fn(y)
            return y

        try:
            chain()
            best = float("inf")
            for _ in range(trials):
                a = clock()
                chain()
                best = min(best, seconds(a, clock()))
            per_pass = best / args.chain
            results[label] = per_pass
            err = float(torch.mean(torch.abs(fn(arg) - arg)))
            print(f"{label:34s} {per_pass:.4e} s/round-trip   L1 err {err:.3e}")
        except (RuntimeError, MemoryError) as e:  # e.g. out of device memory
            print(f"{label:34s} FAILED: {type(e).__name__}: {str(e)[:120]}")

    timed("c2c fftn+ifftn (one batch)",
          lambda y: torch.fft.ifftn(torch.fft.fftn(y, dim=axes), dim=axes), x.to(cd))
    timed("rfftn+irfftn (one batch)",
          lambda y: torch.fft.irfftn(torch.fft.rfftn(y, dim=axes), s=(n, n, n), dim=axes), x)

    n_chunks = 4 if batch % 4 == 0 else 1

    def chunked_roundtrip(y):
        return torch.cat([
            torch.fft.irfftn(torch.fft.rfftn(blk, dim=axes), s=(n, n, n), dim=axes)
            for blk in y.chunk(n_chunks)
        ])

    timed(f"rfftn+irfftn (loop over {n_chunks} chunks)", chunked_roundtrip, x)

    if not results:
        print("\nno variant fit this configuration")
        return 1
    best = min(results, key=results.get)
    print(f"\nFastest: {best} ({results[best]:.4e} s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
