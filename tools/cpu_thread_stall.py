"""Times ``boltzfft_torch.examples.mixing_2d3v`` on the CPU (8 x 8 cells, 2
steps, unsharded and on a 1-rank mesh) at several torch thread counts, on
an idle machine and beside ``--load`` processes that each keep ``--threads``
threads busy with small FFTs (as the other workers of a parallel test run
do).  Each timed run is a fresh process, cut after ``--limit`` seconds.

    python tools/cpu_thread_stall.py [--load 5] [--threads 8] [--counts 8 1]

Prints one line per run: load, torch threads, unsharded or --shard, seconds.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

LOAD = """
import time, torch
torch.set_num_threads({threads})
a = torch.randn(64, 16, 16, 16, dtype=torch.float64)
t = time.time()
while time.time() - t < {seconds}:
    b = torch.fft.fftn(a, dim=(1, 2, 3)); (b * b).real.sum(); a.mul_(1.0000001)
"""

RUN = """
import sys, time, torch
torch.set_num_threads({threads})
from boltzfft_torch.examples import mixing_2d3v
mixing_2d3v.CELLS, mixing_2d3v.STEPS = 8, 2
t = time.time()
mixing_2d3v.main({argv!r})
print(time.time() - t, file=sys.stderr)
"""


def timed(threads: int, argv: list, limit: float) -> str:
    env = dict(os.environ, PYTHONPATH=str(REPO))
    try:
        p = subprocess.run([sys.executable, "-c", RUN.format(threads=threads, argv=argv)],
                           cwd=REPO, env=env, capture_output=True, text=True, timeout=limit)
    except subprocess.TimeoutExpired:
        return f"over {limit:.0f}"
    if p.returncode:
        raise RuntimeError(p.stderr[-4000:])
    return f"{float(p.stderr.strip().splitlines()[-1]):.1f}"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--load", type=int, default=5, help="busy processes beside the runs")
    p.add_argument("--threads", type=int, default=os.cpu_count(),
                   help="torch threads of each busy process")
    p.add_argument("--counts", type=int, nargs="+", default=[os.cpu_count(), 1],
                   help="torch threads of the timed runs")
    p.add_argument("--limit", type=float, default=300.0)
    args = p.parse_args(argv)

    print(f"{os.cpu_count()} CPUs")
    for load in (0, args.load):
        seconds = 2 * len(args.counts) * args.limit + 60
        busy = [subprocess.Popen([sys.executable, "-c",
                                  LOAD.format(threads=args.threads, seconds=seconds)])
                for _ in range(load)]
        try:
            time.sleep(3 if load else 0)
            for n in args.counts:
                for what, flags in (("unsharded", []), ("--shard", ["--shard"])):
                    s = timed(n, flags + ["--device", "cpu"], args.limit)
                    print(f"load {load} x {args.threads} threads | torch threads {n} | {what}:"
                          f" {s} s", flush=True)
        finally:
            for b in busy:
                b.kill()
                b.wait()
    return 0


if __name__ == "__main__":
    sys.exit(main())
