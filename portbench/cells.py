"""A cell's files, found by name, and the processes of a cell on several
cards.  Imports no torch: the process that starts a cell's ranks spends no
set-up on it.

A cell is its entry in the checkout's ``BENCHMARK.json``, its configuration
file, its traffic file ``portbench/traffic/<traffic>.json`` and its own
settings ``portbench/workloads/<cell>.json`` (dispatch depth, the traced
sub-window's steps, the comparison's limits).
"""

from __future__ import annotations

import json
import socket
import sys
import time
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parent.parent
PKG = Path(__file__).resolve().parent
#: A rank that has not ended this long after the start is ended (a first run
#: in a fresh checkout builds the kernel library in every rank).
RANK_TIMEOUT_S = 1100


def _json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_cell(name: str, bench: Optional[dict] = None) -> dict:
    """The cell's entry of ``BENCHMARK.json`` with its files read:
    ``config``, ``traffic`` and ``settings`` dicts, and ``metrics``: the
    end-to-end and the per-layer entries that concern it."""
    bench = bench if bench is not None else _json(ROOT / "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json; have {sorted(entries)}")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in e2e_names)]
    return {
        "name": name,
        "chips": int(entry["chips"]),
        "config": _json(ROOT / configs[entry["config"]]["file"]),
        "traffic": _json(PKG / "traffic" / f"{entry['traffic']}.json"),
        "settings": _json(PKG / "workloads" / f"{name}.json"),
        "metrics": {"end_to_end": e2e, "per_layer": per_layer},
    }


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_entry(cell, seed, seconds, trace, device, rank, world, port, t_start, factory):
    from portbench import harness

    sys.exit(harness.run_rank(cell, seed, seconds, trace, device=device, rank=rank,
                              world=world, port=port, t_start=t_start, unit_factory=factory))


def spawn(cell: dict, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
          t_start: Optional[float] = None, unit_factory=None, entry=_rank_entry) -> int:
    """One process a chip (``spawn`` start), rendezvous on a free port of
    this host; waits for every rank and returns 0 only if every rank
    returned 0.  A rank still running after :data:`RANK_TIMEOUT_S` is
    ended."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    world, port = cell["chips"], free_port()
    t_start = time.time() if t_start is None else t_start
    procs = [ctx.Process(target=entry, args=(cell, seed, seconds, trace, device, r, world, port,
                                             t_start, unit_factory))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = t_start + RANK_TIMEOUT_S
    for p in procs:
        p.join(max(1.0, deadline - time.time()))
    code = 0
    for p in procs:
        if p.is_alive():
            p.terminate()
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
            code = code or 124
        code = code or (p.exitcode or 0)
    return code
