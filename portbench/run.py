"""Run one cell of the benchmark of ``boltzfft_torch`` once.

    python3 portbench/run.py --workload bkw64.rk4 --seed 12345 --seconds 20 --trace 0

Loads, warms up, measures for ``--seconds`` seconds, compares what the
timed steps produced with the plain reference, and prints one JSON line
last on standard output (``--trace 1``: the per-layer metrics, from a
traced run).  Exits non-zero without a line where there is no card, fewer
cards than the cell asks for, or where the process holds JAX or the JAX
package once the window has closed.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
#: The caches of PyTorch's run-time compiled kernels (NVRTC) and of CUDA's
#: JIT: fixed paths inside the checkout, so that only a cell's first run there
#: compiles them (the program builds its own library into
#: build/boltzfft_torch/ by itself).  The ranks of a cell inherit them.
CACHES = {"PYTORCH_KERNEL_CACHE_PATH": ROOT / "build" / "portbench" / "torch_kernels",
          "CUDA_CACHE_PATH": ROOT / "build" / "portbench" / "cuda_cache"}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True, help="cell name in BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True, help="draws the cell's inputs")
    p.add_argument("--seconds", type=float, required=True, help="length of the measured window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0,
                   help="1: the per-layer metrics, from a traced run")
    args = p.parse_args(argv)
    for name, path in CACHES.items():  # before torch is imported
        path.mkdir(parents=True, exist_ok=True)
        os.environ[name] = str(path)

    from portbench import cells

    cell = cells.load_cell(args.workload)
    seed = args.seed % 2**63
    if cell["chips"] > 1:  # each rank checks the cards before it joins the others
        return cells.spawn(cell, seed, args.seconds, bool(args.trace), t_start=T_START)

    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print(f"portbench: cell {args.workload} needs a CUDA device, this machine has none",
              file=sys.stderr)
        return 2
    return harness.run_rank(cell, seed, args.seconds, bool(args.trace), t_start=T_START)


if __name__ == "__main__":
    sys.exit(main())
