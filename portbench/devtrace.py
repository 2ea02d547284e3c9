"""The traced sub-window: ``torch.profiler`` over a steady run of steps,
reduced to the device's busy time, its idle gaps and its operations.

The trace is exported as Chrome JSON under ``TMPDIR``, read back and
deleted.  Device operations are the events of categories ``kernel``,
``gpu_memcpy`` and ``gpu_memset`` (a replayed CUDA graph's kernels appear
there too); the window is the ``portbench.window`` annotation, which ends
after a synchronise.
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict
from pathlib import Path

import torch

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "cuda_runtime", "cuda_driver"}
WINDOW = "portbench.window"
TOP = 10


def profile(run_steps, device: torch.device, prelude=None) -> dict:
    """Run ``prelude()`` and then ``run_steps()`` (which dispatches the
    sub-window's steps and synchronises) under the profiler; the summary
    (:func:`summarize`) of the second alone."""
    from torch.profiler import ProfilerActivity, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with torch.profiler.profile(activities=acts) as prof:
        if prelude is not None:
            prelude()
        with record_function(WINDOW):
            run_steps()
    fd, name = tempfile.mkstemp(prefix="portbench_trace_", suffix=".json")
    os.close(fd)
    path = Path(name)
    try:
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    finally:
        path.unlink(missing_ok=True)
    return summarize(events)


def _union(intervals: list) -> list:
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def summarize(events: list) -> dict:
    """Seconds of the window, of device busy time (the union of the device
    operations' intervals inside it) and of NCCL kernels; the ``TOP``
    device operations by total time and the ``TOP`` longest idle gaps,
    each named by the innermost host operation running at its middle."""
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in spans if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError(f"the trace holds no {WINDOW!r} annotation")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    ops, per_name, nccl = [], defaultdict(float), 0.0
    for e in spans:
        if e.get("cat") not in DEVICE_CATS:
            continue
        a, b = max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]), w1)
        if b <= a:
            continue
        ops.append((a, b))
        per_name[e["name"]] += b - a
        if "nccl" in e["name"].lower():
            nccl += b - a
    busy = _union(ops)
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if w1 > t:
        gaps.append((t, w1))
    host = [e for e in spans if e.get("cat") in HOST_CATS]

    def label(a, b):
        mid = 0.5 * (a + b)
        inside = [e for e in host if float(e["ts"]) <= mid <= float(e["ts"]) + float(e["dur"])]
        return min(inside, key=lambda e: float(e["dur"]))["name"] if inside else "(no host operation)"

    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": sum(b - a for a, b in busy) * 1e-6,
        "nccl_s": nccl * 1e-6,
        "device_ops": [[n, s * 1e-6] for n, s in sorted(per_name.items(), key=lambda kv: -kv[1])[:TOP]],
        "idle_gaps": [[label(a, b), (b - a) * 1e-6] for a, b in longest],
    }
