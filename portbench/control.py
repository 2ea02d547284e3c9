"""The control of the comparison: the plain reference put in the program's
place, computed in float32 (the precision below the configurations'
float64), driven through the rest of a run.  Its numbers set the upper end
of each limit; every run of it has to come out not correct.

    python3 portbench/control.py --workload bkw64.rk4 --seeds 11 12 13 --seconds 5

One JSON line per seed: the seed and the compared numbers.  A cell on a
mesh of cards is controlled on one card, on its whole state (the control
replaces the program, its sharding with it).  Not part of a benchmark run.
"""

import argparse
import io
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def control_unit(problem, _mesh=None):
    import torch

    from portbench import solvers

    return solvers.reference_unit(problem, torch.float32)


def run(name: str, seed: int, seconds: float, device: str = "cuda", cell=None) -> dict:
    """One run of the control; its result line as a dict."""
    from portbench import cells, harness

    cell = cell or cells.load_cell(name)
    cell["traffic"] = dict(cell["traffic"], mesh=None)
    cell["chips"] = 1
    out = io.StringIO()
    harness.run_rank(cell, seed, seconds, False, device=device, unit_factory=control_unit, out=out)
    return json.loads(out.getvalue().strip().splitlines()[-1])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    args = p.parse_args(argv)
    for seed in args.seeds:
        line = run(args.workload, seed, args.seconds)
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": line["correct"],
                          "attempted": line["attempted"], "checks": line["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
