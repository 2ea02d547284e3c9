"""Run-timing statistics, tracing and error norms (mirror of ``boltzfft/stats.py``).

``RunStats`` is the reference's min/max/mean/stdev summary over trial times;
``time_fn`` times a function on the device that it runs on; ``trace`` records
a block with ``torch.profiler``; ``error_norms`` and ``error_norms_device``
are the reference's L1/L2/Linf conventions.
"""

from __future__ import annotations

import dataclasses
import os
import socket
import time
from typing import Callable, Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class RunStats:
    mean: float
    minimum: float
    maximum: float
    stdev: float
    n: int

    @classmethod
    def from_times(cls, times: Sequence[float]) -> "RunStats":
        arr = np.asarray(times, dtype=np.float64)
        # Sample stdev (ddof=1) like the reference; 0 for a single trial.
        stdev = float(arr.std(ddof=1)) if arr.size > 1 else 0.0
        return cls(
            mean=float(arr.mean()),
            minimum=float(arr.min()),
            maximum=float(arr.max()),
            stdev=stdev,
            n=int(arr.size),
        )

    def summary(self, label: str) -> str:
        """Scientific-notation summary in the reference's format."""
        return (
            f"Statistics for {label} (s):\n"
            f"mean: {self.mean:.4e}\n"
            f"min: {self.minimum:.4e}\n"
            f"max: {self.maximum:.4e}\n"
            f"stdev: {self.stdev:.4e}\n"
        )


def time_fn(
    fn: Callable,
    *args,
    device,
    trials: int = 10,
    warmup: int = 2,
    **kwargs,
) -> tuple[RunStats, object]:
    """Time ``fn(*args, **kwargs)`` over ``trials`` runs on ``device``.

    Runs ``warmup`` untimed calls first.  On a CUDA device each call is
    bracketed by two ``torch.cuda.Event``s on the current stream (device time,
    no host-side wait inside the bracket); on the CPU by the host clock.
    Returns the stats in seconds and the last result.
    """
    device = torch.device(device)
    out = None
    for _ in range(warmup):
        out = fn(*args, **kwargs)
    times = []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        for _ in range(trials):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) * 1e-3)
    elif device.type == "cpu":
        for _ in range(trials):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            times.append(time.perf_counter() - t0)
    else:
        raise ValueError(f"time_fn: no timer for device {device}")
    return RunStats.from_times(times), out


class trace:
    """Context manager around ``torch.profiler.profile``: the block's CPU
    activity always, and its CUDA activity (kernels, copies) whenever
    ``torch.cuda.is_available()``.  On exit it writes one Chrome-trace JSON
    under ``log_dir`` (``<host>_<pid>.<ns>.pt.trace.json``, the name
    ``torch.profiler.tensorboard_trace_handler`` gives; Perfetto and
    TensorBoard read it); its path is ``self.path``.  Exceptions raised in
    the block pass through; a profiler that fails to start raises.

    Usage::

        with bt.trace("/tmp/boltz-trace"):
            collide(f, pre)
    """

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self.path = None
        self._prof = None

    def __enter__(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        os.makedirs(self.log_dir, exist_ok=True)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
        self._prof = prof
        return self

    def __exit__(self, *exc):
        prof, self._prof = self._prof, None
        if torch.cuda.is_available():
            torch.cuda.synchronize()  # the block's kernels end inside the trace
        prof.__exit__(None, None, None)
        name = f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}.pt.trace.json"
        self.path = os.path.join(self.log_dir, name)
        prof.export_chrome_trace(self.path)
        return False


def _vol(dv, cell_volume) -> float:
    if (dv is None) == (cell_volume is None):
        raise ValueError("pass exactly one of dv / cell_volume")
    return float(cell_volume) if cell_volume is not None else float(dv) ** 3


def error_norms(
    q, q_exact, dv: float = None, *, cell_volume: float = None,
) -> dict[str, float]:
    """L1/L2/Linf error norms with the reference's scaling conventions:
    L1 = dv^3 sum|diff|; L2 = sqrt(dv^3 sum diff^2); Linf = max|diff|.
    Anisotropic grids pass ``cell_volume=dx*dy*dz`` instead of ``dv``."""
    vol = _vol(dv, cell_volume)
    if isinstance(q, torch.Tensor):
        q = q.detach().cpu().numpy()
    if isinstance(q_exact, torch.Tensor):
        q_exact = q_exact.detach().cpu().numpy()
    diff = np.abs(np.asarray(q, dtype=np.float64) - np.asarray(q_exact, dtype=np.float64))
    return {
        "L1": float(vol * diff.sum()),
        "L2": float(np.sqrt(vol * (diff**2).sum())),
        "Linf": float(diff.max()),
    }


def error_norms_device(
    q: torch.Tensor, q_exact, dv: float = None, *, cell_volume: float = None
) -> dict[str, float]:
    """The same norms reduced on ``q``'s device; only three scalars cross to
    the host."""
    vol = _vol(dv, cell_volume)
    q_exact = torch.as_tensor(q_exact, dtype=q.dtype, device=q.device)
    diff = torch.abs(q - q_exact)
    return {
        "L1": float(vol * torch.sum(diff)),
        "L2": float(torch.sqrt(vol * torch.sum(diff**2))),
        "Linf": float(torch.max(diff)),
    }
