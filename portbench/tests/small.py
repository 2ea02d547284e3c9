"""Cells cut to a size a CPU test run holds: 8^3 velocities, 4 radial
nodes, a few cells, K1's plain version (the route ``auto`` takes on the
card)."""

import io
import json

from portbench import cells, harness

#: Per-cell cuts of the traffic (the velocity grid is cut for every cell).
CUTS = {"bkw64.rk4": {}, "tg2d.16x16.step": {"cells": [4, 4]},
        "tg2d.32x32.mesh2x2": {"cells": [8, 8]}}


def cell(name: str) -> dict:
    c = cells.load_cell(name)
    c["config"].update(nv=8, n_radial=4, impl="fused")
    c["traffic"].update(CUTS[name])
    return c


def run(name: str, seed: int = 12345, seconds: float = 0.5, trace: bool = False,
        unit_factory=None, the_cell=None) -> dict:
    """One single-process run on the CPU (of ``the_cell``, else the cut
    cell ``name``); its last line."""
    out = io.StringIO()
    rc = harness.run_rank(the_cell or cell(name), seed, seconds, trace, device="cpu",
                          unit_factory=unit_factory, out=out)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])
