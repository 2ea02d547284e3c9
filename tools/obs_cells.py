"""Run one portbench cell with ``boltzfft_torch.obs`` on, on the card, and
print what its spans and counters read, or check the device marks' clock.

    python3 tools/obs_cells.py --workload tg2d.16x16.step --seed 7 --seconds 20 \
        --trace 1 [--obs 1]
    python3 tools/obs_cells.py --check

A cell run is ``portbench/run.py``'s run (``harness.run_rank``, one rank a
card through ``cells.spawn``) with these changes, made here and not in the
benchmark's files: ``--obs 1`` enables obs before the step unit is built;
with ``--trace 1`` obs is reset after the traced sub-window's prelude, its
summary taken right after the sub-window, and reset again after the
standalone operator's capture, before the ``collision_ms`` calls.  Rank 0 prints the harness's line and then one
line ``{"obs": ...}``: the span and counter metrics of
``portbench/metrics`` (on several cards each rank's, and their mean), the
sub-window's device time per step (window / steps) against the sum of the
step's parts, the marks written and lost, the standalone operator's
``collide`` span, K1's ``collide/k1.chunk`` spans (per chunk, and chunks
per eval: their count over the ``collide`` spans'), and the step unit's
counters.  ``--obs 0`` is the
benchmark's own run, for the cost of obs: compare ``step_ms``.

``--check`` times the marks themselves: 2000 empty spans launched back to
back (4000 marks: their spacing and the smallest step of ``%globaltimer``),
on an idle card and queued behind a ~100 ms kernel (then the card runs
them back to back), and device spans around a ~1 ms kernel
(``torch.cuda._sleep``), a float64 GEMM and a small add against CUDA
events around the same launches, on an idle card and queued.
"""

import argparse
import json
import os
import statistics
import sys
import time
from pathlib import Path

T_START = time.time()
ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SPAN_METRICS = ("step_collide_ms", "step_advect_ms", "step_halo_ms", "step_self_ms",
                "step_gap_us", "replay_launch_ms")
COUNTER_METRICS = ("step_graph_nodes", "step_captures", "k1_chunks_per_eval", "k1_stream_gib")
_STASH = {}


def _patch(on: bool) -> None:
    """obs on (or not) in this rank, reset after the traced prelude and read
    after the sub-window."""
    from boltzfft_torch import obs
    from portbench import devtrace, harness, spans

    if not on:
        return
    obs.enable()
    profile, gather, finish = devtrace.profile, harness._gather, harness._finish
    collision = harness._collision_ms

    def traced(run_steps, device, prelude=None):
        def then_reset():
            if prelude is not None:
                prelude()
            obs.reset()

        out = profile(run_steps, device, then_reset)
        _STASH["spans"] = obs.summary()
        return out

    def collision_ms(unit, x, device, calls):
        unit.collide_fn(x.reshape(unit.batch_shape), unit.pre)  # its graph's capture
        obs.reset()  # the sub-window's summary is kept: the operator's replays alone from here
        return collision(unit, x, device, calls)

    def gathered(run, items, problem, rank, world, group):
        import torch.distributed as dist

        every = [None] * world
        dist.all_gather_object(every, _STASH.get("spans"), group=group)
        _STASH["ranks"] = every
        return gather(run, items, problem, rank, world, group)

    def finished(cell, problem, run, items, error, trace, out):
        code = finish(cell, problem, run, items, error, trace, out)
        if not trace:  # the window's host spans (no profiler), the marks since the start
            live = obs.summary()
            unit = spans.step_unit(live)
            print(json.dumps({"obs": {"unit": unit, "host": live["host"].get(unit),
                                      "marks": live["marks"]}}), file=out, flush=True)
            return code
        if "spans" not in _STASH or run.profile is None:
            return code
        ranks = _STASH.get("ranks") or [_STASH["spans"]]
        per_rank = []
        for s in ranks:
            run.spans = s
            per_rank.append({m: harness.reader(m)(run) for m in SPAN_METRICS + COUNTER_METRICS})
        mean = {m: (statistics.mean(r[m] for r in per_rank) if per_rank[0][m] is not None else None)
                for m in SPAN_METRICS}
        mean.update({m: max((r[m] for r in per_rank if r[m] is not None), default=None)
                     for m in COUNTER_METRICS})
        step_dev = run.profile["window_s"] * 1e3 / run.profile["steps"]
        parts = sum(mean[m] or 0.0 for m in ("step_collide_ms", "step_advect_ms", "step_self_ms"))
        parts += (mean["step_gap_us"] or 0.0) / 1e3
        live = obs.summary()  # the standalone operator's graph, replayed after the sub-window
        alone = live["device"].get("collide", {}).get("step/collide")  # its 21 replays
        s0 = ranks[0]
        unit = spans.step_unit(s0)

        def k1_chunks(dev):
            chunk, evals = dev.get("collide/k1.chunk"), dev.get("step/collide")
            if not chunk or not evals:
                return None
            return {"count": chunk["count"], "ms_per_chunk": chunk["total_ms"] / chunk["count"],
                    "max_ms": chunk["max_ms"], "chunks_per_eval": chunk["count"] / evals["count"]}
        line = {"obs": {
            "metrics": mean, "per_rank": per_rank if len(per_rank) > 1 else None,
            "window_ms_per_step": step_dev, "parts_ms_per_step": parts,
            "closure": parts / step_dev - 1.0,
            "collision_ms": run.collision_ms, "evals_per_step": run.evals_per_step,
            "collide_alone_ms": alone["total_ms"] / alone["count"] if alone else None,
            "collide_alone_count": alone["count"] if alone else None,
            "k1_chunk": k1_chunks(s0["device"].get(unit) or {}),
            "k1_chunk_alone": k1_chunks(live["device"].get("collide", {})),
            "marks": [s["marks"] for s in ranks], "dropped": [s["dropped"] for s in ranks],
            "unit": unit, "device": s0["device"].get(unit), "gaps": s0["gaps"].get(unit),
            "host": s0["host"].get(unit),
            "counters": {k: s0["counters"][k] for k in ("captures", "evictions", "graph_nodes",
                                                         "k1_plan", "library")},
        }}
        print(json.dumps(line), file=out, flush=True)
        return code

    devtrace.profile, harness._gather, harness._finish = traced, gathered, finished
    harness._collision_ms = collision_ms


def _rank_entry(cell, seed, seconds, trace, device, rank, world, port, t_start, factory, on):
    from portbench import harness

    _patch(on)
    sys.exit(harness.run_rank(cell, seed, seconds, trace, device=device, rank=rank, world=world,
                              port=port, t_start=t_start, unit_factory=factory))


def _entry_with(on):
    import functools

    return functools.partial(_rank_entry, on=on)


def check() -> dict:
    """The marks' spacing, ``%globaltimer``'s step and spans against events."""
    import torch

    from boltzfft_torch import obs

    dev = torch.device("cuda")
    obs.enable()
    obs.prepare(dev)
    out = {"card": torch.cuda.get_device_name(dev)}
    # back-to-back marks: one span opened and closed 2000 times
    x = torch.zeros(1, device=dev)
    for _ in range(10):
        with obs.span("warm", like=x):
            pass
    torch.cuda.synchronize()
    obs.reset()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(2000):
        with obs.span("empty", like=x):
            pass
    b.record()
    torch.cuda.synchronize()
    ring, head = obs._rings[dev.index if dev.index is not None else torch.cuda.current_device()]
    n = int(head.item())
    stamps = [t for _code, t in ring[:n].cpu().tolist()]
    deltas = [q - p for p, q in zip(stamps, stamps[1:])]
    positive = [d for d in deltas if d > 0]
    out["marks"] = {"n": n, "events_ms": a.elapsed_time(b), "ns_per_mark_events": a.elapsed_time(b) * 1e6 / n,
                    "ns_per_mark_stamps": (stamps[-1] - stamps[0]) / (n - 1),
                    "zero_deltas": sum(d == 0 for d in deltas),
                    "min_positive_delta_ns": min(positive) if positive else None,
                    "distinct_deltas": sorted(set(deltas))[:12],
                    "empty_span_us": obs.summary()["device"]["main"]["empty"]["total_ms"] * 1e3 / 2000}
    # the same marks queued behind a ~100 ms kernel, so the card runs them back to back
    obs.reset()
    torch.cuda._sleep(200_000_000)
    for _ in range(2000):
        with obs.span("queued", like=x):
            pass
    torch.cuda.synchronize()
    n = int(head.item())
    stamps = [t for _code, t in ring[:n].cpu().tolist()]
    deltas = [q - p for p, q in zip(stamps, stamps[1:])]
    positive = [d for d in deltas if d > 0]
    out["queued_marks"] = {"n": n, "ns_per_mark_stamps": (stamps[-1] - stamps[0]) / (n - 1),
                           "zero_deltas": sum(d == 0 for d in deltas),
                           "min_positive_delta_ns": min(positive) if positive else None,
                           "median_delta_ns": statistics.median(deltas),
                           "distinct_deltas": sorted(set(deltas))[:12]}
    # spans around kernels of known length against events around the same launches,
    # queued behind a ~30 ms kernel (device-paced) and launched on an idle card
    big = torch.randn(4096, 4096, device=dev, dtype=torch.float64)
    for label, fn, queued in (("sleep_1ms", lambda: torch.cuda._sleep(2_000_000), False),
                              ("dgemm_4096", lambda: big @ big, False),
                              ("add_1M", lambda: big[:256].add_(1.0), False),
                              ("sleep_1ms_queued", lambda: torch.cuda._sleep(2_000_000), True),
                              ("dgemm_4096_queued", lambda: big @ big, True),
                              ("add_1M_queued", lambda: big[:256].add_(1.0), True)):
        fn()
        torch.cuda.synchronize()
        obs.reset()
        if queued:
            torch.cuda._sleep(50_000_000)
        evs = []
        for _ in range(20):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            with obs.span(label, like=x):
                fn()
            e1.record()
            evs.append((e0, e1))
        torch.cuda.synchronize()
        ev = [e0.elapsed_time(e1) for e0, e1 in evs]
        sp = obs.summary()["device"]["main"][label]
        out[label] = {"events_ms": statistics.mean(ev), "span_ms": sp["total_ms"] / sp["count"],
                      "span_max_ms": sp["max_ms"], "count": sp["count"]}
    obs.disable()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--trace", type=int, choices=(0, 1), default=1)
    p.add_argument("--obs", type=int, choices=(0, 1), default=1)
    p.add_argument("--check", action="store_true", help="time the marks themselves")
    args = p.parse_args(argv)
    from portbench import run as bench_run

    for name, path in bench_run.CACHES.items():
        path.mkdir(parents=True, exist_ok=True)
        os.environ[name] = str(path)
    if args.check:
        print(json.dumps({"check": check()}), flush=True)
        return 0
    from portbench import cells

    cell = cells.load_cell(args.workload)
    seed = args.seed % 2**63
    if cell["chips"] > 1:
        return cells.spawn(cell, seed, args.seconds, bool(args.trace), t_start=T_START,
                           entry=_entry_with(bool(args.obs)))
    from portbench import harness

    _patch(bool(args.obs))
    return harness.run_rank(cell, seed, args.seconds, bool(args.trace), t_start=T_START)


if __name__ == "__main__":
    sys.exit(main())
