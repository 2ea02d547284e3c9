"""One run of one cell (:func:`portbench.cells.load_cell`) on one rank:
set-up, the measured window, the traced extras, the comparison, and the
result line, whose metrics the readers ``portbench/metrics/<metric>.py``
take from a :class:`Run`.  A cell on several cards runs one rank a card
(:func:`portbench.cells.spawn`); rank 0 prints the line.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import sys
import time
import traceback
from typing import Callable, Optional

import torch
import torch.distributed as dist

from . import cells, check, devtrace, solvers

#: Top-level modules that no process of the benchmark may hold.
FORBIDDEN = ("jax", "jaxlib", "flax", "boltzfft")
#: Steps of the window kept for the comparison besides the first and the last.
SAMPLES = 6
#: Back-to-back operator calls that ``collision_ms`` times.
COLLISION_CALLS = 20
#: On several ranks, the steps between the ranks' agreements on whether the
#: window has closed (rank 0's clock decides); one rank decides every step.
AGREE_EVERY = 16


# ------------------------------------------------------------ readers
def reader(metric: str) -> Callable:
    """``read(run)`` of ``portbench/metrics/<metric>.py``."""
    path = cells.PKG / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    """Top-level names in ``sys.modules`` of :data:`FORBIDDEN` (compared
    whole: ``boltzfft_torch`` is not ``boltzfft``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


# ------------------------------------------------------------ timing
class _HostEvent:
    """A CUDA event's interface over the host clock, for the CPU, where
    every operation has ended when its call returns."""

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end) -> float:
        return (end.t - self.t) * 1e3


def _event(device):
    return torch.cuda.Event(enable_timing=True) if device.type == "cuda" else _HostEvent()


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Run:
    """What the metric readers read (rank 0's view; per-step times are the
    slowest rank's, device readings the mean or the largest over ranks)."""

    config: dict
    chips: int
    steps: int
    window_s: float
    step_ms: list  # each step's ms between CUDA events
    host_call_ms: list  # host ms of each step call, no synchronise
    setup_s: float
    capture_s: float
    precomp_s: float
    evals_per_step: int
    batch: int
    memory_peak_bytes: int
    collision_ms: Optional[float] = None
    profile: Optional[dict] = None  # devtrace summary: busy_s, window_s, nccl_s, steps


def dispatch(unit: solvers.Unit, x, device, depth: int, keep_going: Callable, samples=None,
             on_step: Optional[Callable] = None):
    """Steps from ``x`` back to back, at most ``depth`` in flight: before
    dispatching step n wait on the event of step n - depth, then ask
    ``keep_going(elapsed_s, n)``.  Every ``unit.restart_every`` steps the
    state starts again from ``unit.x0``.  Returns ``(steps, wall_s,
    step_ms, host_ms, x_last, error)``; the wall runs from a synchronise
    before the first dispatch to the synchronise after the last step."""
    events, host, n, error = [], [], 0, None
    start = _event(device)
    _sync(device)
    t0 = time.perf_counter()
    if on_step is not None:
        on_step()
    start.record()
    while True:
        if n >= depth:
            events[n - depth].synchronize()
        if not keep_going(time.perf_counter() - t0, n):
            break
        if unit.restart_every and n and n % unit.restart_every == 0:
            x = unit.x0
        h = time.perf_counter()
        try:
            y, rec = unit.step(x, unit.pre)
        except Exception as err:  # a failed step ends the window; it counts as failed
            traceback.print_exc(file=sys.stderr)
            error = err
            break
        host.append((time.perf_counter() - h) * 1e3)
        ev = _event(device)
        ev.record()
        events.append(ev)
        if samples is not None:
            samples.offer(n, x, y, rec)
        x, n = y, n + 1
    _sync(device)
    wall = time.perf_counter() - t0
    step_ms = [a.elapsed_time(b) for a, b in zip([start] + events[:-1], events)]
    return n, wall, step_ms, host, x, error


# ------------------------------------------------------------ one rank
def run_rank(cell: dict, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
             rank: int = 0, world: int = 1, port: Optional[int] = None,
             t_start: Optional[float] = None, unit_factory: Optional[Callable] = None,
             out=None) -> int:
    """One rank of a run; rank 0 prints the result line.  Returns the exit
    code.  ``unit_factory(problem, mesh)`` replaces the program's step unit
    (the control and the planted faults of the tests)."""
    t_start = time.time() if t_start is None else t_start
    stamps = [("start", time.time())]  # set-up phases, printed on standard error
    out = out or sys.stdout
    if device == "cuda" and (not torch.cuda.is_available() or torch.cuda.device_count() < world):
        print(f"portbench: {world} CUDA device(s) needed, this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    dev = torch.device(device, rank) if device == "cuda" else torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.empty(0, device=dev)
    torch.set_num_threads(2 if world > 1 else 4)
    traffic, settings = cell["traffic"], cell["settings"]
    mesh = gloo = None
    if world > 1:
        backend = "nccl" if dev.type == "cuda" else "gloo"
        kw = {"device_id": dev} if dev.type == "cuda" else {}
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                                world_size=world, rank=rank, **kw)
        gloo = dist.new_group(backend="gloo") if backend == "nccl" else dist.group.WORLD
    stamps.append(("device", time.time()))
    try:
        problem = solvers.Problem(cell["config"], traffic, seed, dev)
        if world > 1:
            mesh = problem.kind.make_mesh(problem)
        stamps.append(("inputs", time.time()))
        unit = (unit_factory or solvers.port_unit)(problem, mesh)
        stamps.append(("operator", time.time()))

        # set-up: the first call captures the step's graph, the second replays it
        _sync(dev)
        t = time.perf_counter()
        y, _ = unit.step(unit.x0, unit.pre)
        _sync(dev)
        capture_s = time.perf_counter() - t
        stamps.append(("capture", time.time()))
        unit.step(y, unit.pre)
        del y

        def keep_going(elapsed: float, n: int) -> bool:
            if gloo is None:
                return elapsed < seconds
            if n % AGREE_EVERY:
                return True
            flag = torch.tensor([int(elapsed >= seconds)])
            dist.broadcast(flag, src=0, group=gloo)
            return not flag.item()

        setup_end = {}
        samples = check.Samples(SAMPLES, seed)
        n, wall, step_ms, host_ms, x, error = dispatch(
            unit, unit.x0, dev, int(settings["depth"]),
            keep_going, samples,
            on_step=lambda: setup_end.setdefault("t", time.time()))
        peak = torch.cuda.max_memory_reserved(dev) if dev.type == "cuda" else 0
        stamps.append(("replay", setup_end["t"]))
        if rank == 0:
            phases = " ".join(f"{b[0]} {b[1] - a[1]:.3f}" for a, b in zip(stamps, stamps[1:]))
            print(f"portbench setup s: imports {stamps[0][1] - t_start:.3f} {phases}",
                  file=sys.stderr)
        run = Run(cell["config"], world, n, wall, step_ms, host_ms,
                  setup_end["t"] - t_start, capture_s, unit.precomp_s, unit.evals_per_step,
                  problem.batch, peak)
        if trace and error is None:
            depth = int(settings["depth"])

            def prelude():  # two steps with the profiler on, then the ranks start together
                dispatch(unit, x, dev, depth, _count(2))
                if gloo is not None:
                    dist.barrier(group=gloo)

            run.profile = devtrace.profile(
                lambda: dispatch(unit, x, dev, depth, _count(int(settings["profile_steps"]))),
                dev, prelude)
            run.profile["steps"] = int(settings["profile_steps"])
            run.collision_ms = _collision_ms(unit, x, dev, COLLISION_CALLS)

        items = samples.items()
        del unit, x
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        if world > 1:
            run, items = _gather(run, items, problem, rank, world, gloo)
            dist.destroy_process_group()
        if rank != 0:
            return 0
        return _finish(cell, problem, run, items, error, trace, out)
    finally:
        if world > 1 and dist.is_initialized():
            dist.destroy_process_group()


def _count(k: int) -> Callable:
    left = [k]

    def keep_going(_elapsed, _n):
        left[0] -= 1
        return left[0] >= 0

    return keep_going


def _collision_ms(unit: solvers.Unit, x, device, calls: int) -> float:
    """ms per call of the step's operator at the step's batch shape, CUDA
    events around ``calls`` back-to-back calls (its first call, which
    captures its graph, untimed)."""
    f = x.reshape(unit.batch_shape)
    unit.collide_fn(f, unit.pre)
    a, b = _event(device), _event(device)
    _sync(device)
    a.record()
    for _ in range(calls):
        unit.collide_fn(f, unit.pre)
    b.record()
    _sync(device)
    return a.elapsed_time(b) / calls


def _gather(run: Run, items: list, problem: solvers.Problem, rank: int, world: int, gloo):
    """Rank 0's view: the slowest rank's time for each step, the fullest
    card's memory, device readings averaged over the cards, and the kept
    steps as whole states (blocks laid out by the mesh)."""
    every = [None] * world
    dist.all_gather_object(every, run, group=gloo)
    if rank == 0:
        run.step_ms = [max(r.step_ms[i] for r in every) for i in range(run.steps)]
        run.memory_peak_bytes = max(r.memory_peak_bytes for r in every)
        if run.collision_ms is not None:
            run.collision_ms = sum(r.collision_ms for r in every) / world
        if run.profile is not None:
            for key in ("busy_s", "window_s", "nccl_s"):
                run.profile[key] = sum(r.profile[key] for r in every) / world
    whole = []
    for n, x, y, _rec in items:
        parts = []
        for t in (x, y):
            blocks = [torch.empty_like(t) for _ in range(world)]
            dist.all_gather(blocks, t.contiguous())
            parts.append(problem.kind.whole(problem, blocks))
        whole.append((n, parts[0], parts[1], None))
    return run, whole


def _finite(v: float) -> float:
    return v if math.isfinite(v) else 1e300


def _finish(cell: dict, problem, run: Run, items: list, error, trace: bool, out) -> int:
    """Compare, read the metrics, print the result line (rank 0).  A
    process that holds a module of :data:`FORBIDDEN` prints no line."""
    held = forbidden_modules()
    if held:
        print(f"portbench: this process holds {held} after the window", file=sys.stderr)
        return 3
    attempted = run.steps + (error is not None)
    first_bad = next((n for n, _x, y, _r in items if not bool(torch.isfinite(y).all())), None)
    failed = (error is not None) + (run.steps - first_bad if first_bad is not None else 0)
    limits = cell["settings"]["limits"]
    found = check.compare(problem, items) if items else {}
    numbers = {k: found.get(k, math.inf) for k in limits}
    checks = {k: {"value": _finite(v), "limit": limits[k]} for k, v in numbers.items()}
    correct = failed == 0 and all(v <= limits[k] for k, v in numbers.items())

    kind = "end_to_end" if not trace else "per_layer"
    metrics = {}
    for m in cell["metrics"][kind]:
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if problem.device.type == "cuda" else problem.device.type,
              "kind": torch.cuda.get_device_name(problem.device) if problem.device.type == "cuda"
              else "cpu",
              "count": run.chips, "memory_peak_bytes": int(run.memory_peak_bytes)}
    line = {"correct": bool(correct), "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": device}
    if trace and run.profile is not None:
        device["busy_s"] = run.profile["busy_s"]
        device["window_s"] = run.profile["window_s"]
        line["breakdown"] = {"device_ops": run.profile["device_ops"],
                             "idle_gaps": run.profile["idle_gaps"]}
    line["checks"] = checks
    for k, c in checks.items():
        print(f"portbench check {k} = {c['value']:.6e} (limit {c['limit']:.3e})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), file=out, flush=True)
    return 0
