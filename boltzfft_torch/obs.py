"""Spans and counters inside the port, off by default.

    from boltzfft_torch import obs
    obs.enable()          # before the units are built and captured
    ...                   # warm up
    obs.reset()           # then the steps to read
    ...
    print(obs.summary())

**Host spans** (host clock, ``time.perf_counter_ns``) are opened with
:func:`span` at the port's layer boundaries: ``replay`` (children
``replay.copy_in``, ``replay.launch``, ``replay.clone_out``) and ``capture``
(``capture.warmup``, ``capture.graph``) in :class:`_graph.Replayed`,
``precomp`` around the operators' tables, ``library`` around the kernel
library's build or load, and the device spans below.  Each is kept as (unit,
name, parent, start, end) and folded into per-unit aggregates (count, total,
max) keyed ``"<parent>/<name>"``.  The unit is the name of the outermost
:class:`_graph.Replayed` being called (``relaxation.step``, ``step_body``,
``sharded_step_2d``, ``collide``, ``collide_ds``, ...), ``"main"`` outside
one.  While a torch profiler is active each host span is also a
``record_function`` range ``boltzfft.<name>``, so a Chrome trace (``bt.trace``)
shows what the program was doing around each device gap.

**Device spans**: a span given a CUDA tensor (``span(name, like=f)``) also
launches a one-thread kernel (``csrc/obs_mark.cu``) at its begin and end on
the tensor's current stream, which reads ``%globaltimer`` and appends (span
id, ns) to a ring on the device.  Under a capture the marks become graph
nodes, so every replay stamps its own spans with no host synchronise.  They
are ``step`` (the unit's first and last node, opened by ``Replayed``),
``collide`` (every operator eval, at its entry), ``advect.<axis>`` and, on a
mesh, its child ``halo.<axis>``; and ``k1.chunk``, child of ``collide``, one
span per node chunk of K1, whose marks the kernel's own chunk loop launches
(:func:`marks` hands it the ring and the span's code).  :func:`summary`
synchronises once, pairs the marks and reports device ms per span, self
time (less the child spans), the gaps between one ``step`` span and the
next of a unit, and marks lost to the ring's wrap (:data:`RING`).  A graph captured with obs on keeps its
marks after :func:`disable`; one captured off has none.

**Counters** are always on (they count at capture, launch-plan or build
time, never on the replay path): captures, evictions and graph nodes
(``cudaGraphGetNodes`` on the capture's graph) per unit, K1's node chunking
per launch shape, library builds and loads; ``summary()["counters"]
["kernels"]`` is a view of the kernel modules' own ``LAUNCHES``, ``COPIES``,
``REFERENCE_CALLS`` and ``PHASED_LAUNCHES``.

Off, an instrumented site costs one call that tests :data:`on`, and
``Replayed``'s replay path one test of it: no span is kept, no
``record_function`` entered and no mark launched, so graphs are captured
with the same nodes as without this module.
"""

from __future__ import annotations

import ctypes
import importlib
import pkgutil
import time
from contextlib import nullcontext

import torch

#: The switch (read by every instrumented site).
on = False
#: Marks each device's ring holds (16 bytes each).
RING = 1 << 16
#: Host spans kept between resets (past it they are counted as dropped).
KEEP_SPANS = 200_000
#: The unit of spans opened outside any replayed unit.
MAIN = "main"
#: The kernel modules' counters that the counter view lists.
KERNEL_COUNTERS = ("LAUNCHES", "COPIES", "REFERENCE_CALLS", "PHASED_LAUNCHES")

_NULL = nullcontext()
_stack: list = []  # open spans, innermost last
_units: list = []  # replayed units being called, innermost last
_spans: list = []  # kept host spans: (unit, name, parent, t0_ns, t1_ns, attrs)
_dropped = 0
_host: dict = {}  # (unit, "<parent>/<name>") -> [count, total_ns, max_ns]
_sites: list = []  # device span id -> (unit, key)
_site_ids: dict = {}  # (unit, key) -> id
_rings: dict = {}  # device index -> (ring (RING, 2) int64, head (1,) int64)
_counters = {"captures": {}, "evictions": {}, "graph_nodes": {}, "k1_plan": {}, "library": {}}


def enable() -> None:
    """Record spans from now on."""
    global on
    on = True


def disable() -> None:
    """Stop recording spans (counters stay on; kept data stays readable)."""
    global on
    on = False


def enabled() -> bool:
    return on


def _key(parent, name: str) -> str:
    return f"{parent}/{name}" if parent else name


class _Span:
    __slots__ = ("name", "like", "attrs", "unit", "parent", "site", "rf", "t0")

    def __init__(self, name, like, attrs):
        self.name, self.like, self.attrs = name, like, attrs

    def __enter__(self):
        self.unit = _units[-1] if _units else MAIN
        self.parent = _stack[-1].name if _stack else None
        self.rf = None
        if torch._C._autograd._profiler_enabled():
            self.rf = torch.autograd.profiler.record_function("boltzfft." + self.name)
            self.rf.__enter__()
        self.site = None
        if self.like is not None and self.like.is_cuda:
            self.site = _device_site(self.unit, self.name)
            _mark(self.like.device, 2 * self.site)
        _stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        global _dropped
        t1 = time.perf_counter_ns()
        _stack.pop()
        if self.site is not None:
            _mark(self.like.device, 2 * self.site + 1)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        agg = _host.setdefault((self.unit, _key(self.parent, self.name)), [0, 0, 0])
        dt = t1 - self.t0
        agg[0] += 1
        agg[1] += dt
        agg[2] = max(agg[2], dt)
        if len(_spans) < KEEP_SPANS:
            _spans.append((self.unit, self.name, self.parent, self.t0, t1, self.attrs))
        else:
            _dropped += 1
        return False


def span(name: str, like=None, **attrs):
    """A span around a block (a context manager); with ``like`` a CUDA
    tensor, a device span on its stream too.  Off: a shared no-op."""
    if not on:
        return _NULL
    return _Span(name, like, attrs or None)


class _Unit:
    __slots__ = ("name",)

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        _units.append(self.name)

    def __exit__(self, *exc):
        _units.pop()
        return False


def unit(name: str):
    """The spans opened inside belong to the replayed unit ``name``."""
    return _Unit(name)


# ------------------------------------------------------------ device marks
def _site(unit_name: str, key: str) -> int:
    site = _site_ids.get((unit_name, key))
    if site is None:
        site = _site_ids[(unit_name, key)] = len(_sites)
        _sites.append((unit_name, key))
    return site


def _device_site(unit_name: str, name: str) -> int:
    """The site of device span ``name`` opened now: its parent is the
    innermost open span that has device marks."""
    dparent = next((s.name for s in reversed(_stack) if s.site is not None), None)
    return _site(unit_name, _key(dparent, name))


def _index(device) -> int:
    return torch.cuda.current_device() if device.index is None else device.index


def prepare(device) -> None:
    """Load the kernel library and make ``device``'s ring (outside any
    capture: a capture must not allocate it, nor zero it on every replay)."""
    if torch.device(device).type != "cuda":
        return
    from . import _build

    _build.load_library()
    index = _index(torch.device(device))
    if index not in _rings:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("obs: the device ring must be made before a capture "
                               "(obs.prepare(device) outside it)")
        _rings[index] = (torch.zeros((RING, 2), dtype=torch.int64, device=device),
                         torch.zeros(1, dtype=torch.int64, device=device))


def _mark(device, code: int) -> None:
    from . import _build

    index = _index(device)
    if index not in _rings:
        prepare(device)
    ring, head = _rings[index]
    lib = _build.load_library()
    with _build.on_device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.bfft_obs_mark(ring.data_ptr(), head.data_ptr(), RING, code, stream)
    if rc != 0:
        raise RuntimeError(f"obs: the mark kernel failed with cudaError {rc}")


def marks(name: str, like):
    """``(ring, head, capacity, code)`` for a device span ``name`` whose
    marks a kernel launches itself, on ``like``'s device, under the innermost
    open device span: the ring's and head's addresses, the ring's size and the
    begin mark's code (the end's is code + 1).  None while obs is off or off
    the card: the kernel then launches no mark."""
    if not on or not like.is_cuda:
        return None
    site = _device_site(_units[-1] if _units else MAIN, name)
    index = _index(like.device)
    if index not in _rings:
        prepare(like.device)
    ring, head = _rings[index]
    return ring.data_ptr(), head.data_ptr(), RING, 2 * site


def capture_nodes(device):
    """Nodes of the graph being captured on ``device``'s current stream (the
    count its ``cudaGraph_t`` will have), or None off the card."""
    if torch.device(device).type != "cuda":
        return None
    from . import _build

    lib = _build.load_library()
    out = ctypes.c_longlong(-1)
    rc = lib.bfft_capture_nodes(torch.cuda.current_stream(device).cuda_stream, ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(f"obs: cudaStreamGetCaptureInfo/cudaGraphGetNodes failed with cudaError {rc}")
    return out.value if out.value >= 0 else None


def graph_nodes(graph) -> int:
    """``cudaGraphGetNodes`` of a ``torch.cuda.CUDAGraph`` that kept its graph
    (captured with obs on)."""
    from . import _build

    out = ctypes.c_longlong(-1)
    rc = _build.load_library().bfft_graph_nodes(graph.raw_cuda_graph(), ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(f"obs: cudaGraphGetNodes failed with cudaError {rc}")
    return out.value


# ------------------------------------------------------------ counters
def count(kind: str, key, n: int = 1) -> None:
    """Add ``n`` to counter ``kind[key]`` (always on)."""
    d = _counters[kind]
    d[key] = d.get(key, 0) + n


def note(kind: str, key, value) -> None:
    """Set ``kind[key]`` (always on): the last capture's nodes, a launch plan."""
    _counters[kind][key] = value


def _kernel_counters() -> dict:
    from . import kernels

    view = {}
    for info in pkgutil.iter_modules(kernels.__path__):
        mod = importlib.import_module(f"{kernels.__name__}.{info.name}")
        found = {k: getattr(mod, k) for k in KERNEL_COUNTERS if hasattr(mod, k)}
        if found:
            view[info.name] = {k: dict(v) if isinstance(v, dict) else v for k, v in found.items()}
    return view


# ------------------------------------------------------------ reading
def reset() -> None:
    """Clear the spans and their aggregates (host and device) from here on.
    What captures and builds recorded stays: captures, evictions, graph
    nodes, K1's plans, library builds and loads."""
    global _dropped
    _spans.clear()
    _host.clear()
    _dropped = 0
    for index, (_ring, head) in _rings.items():
        torch.cuda.synchronize(index)
        head.zero_()


def _device_spans() -> tuple:
    """Per-unit device aggregates, the gaps between a unit's steps, and the
    marks' bookkeeping, from every ring."""
    agg, gaps = {}, {}
    marks = {"written": 0, "lost": 0, "unpaired": 0}
    for index, (ring, head) in _rings.items():
        torch.cuda.synchronize(index)
        n = int(head.item())
        kept = min(n, RING)
        data = (ring if n > RING else ring[:n]).cpu().tolist()
        start = n % RING if n > RING else 0
        marks["written"] += n
        marks["lost"] += n - kept
        begun, last_end = {}, {}
        for i in range(kept):
            code, t = data[(start + i) % RING]
            site, end = divmod(code, 2)
            if site >= len(_sites):
                marks["unpaired"] += 1
                continue
            if not end:
                marks["unpaired"] += site in begun
                begun[site] = t
                continue
            t0 = begun.pop(site, None)
            if t0 is None:
                marks["unpaired"] += 1
                continue
            unit_name, key = _sites[site]
            a = agg.setdefault((unit_name, key), [0, 0, 0])
            a[0] += 1
            a[1] += t - t0
            a[2] = max(a[2], t - t0)
            if key == "step":
                if site in last_end:
                    g = gaps.setdefault(unit_name, [0, 0, 0])
                    g[0] += 1
                    g[1] += t0 - last_end[site]
                    g[2] = max(g[2], t0 - last_end[site])
                last_end[site] = t
        marks["unpaired"] += len(begun)
    return agg, gaps, marks


def _ms(a) -> dict:
    return {"count": a[0], "total_ms": a[1] * 1e-6, "max_ms": a[2] * 1e-6}


def summary() -> dict:
    """A plain dict: ``host[unit][key]`` and ``device[unit][key]`` (key
    ``"<parent>/<name>"``: count, total_ms, max_ms; device entries also
    ``self_ms``, less their child spans), ``gaps[unit]`` (one ``step`` span's
    end to the next one's begin), ``marks`` (written, lost to the ring's
    wrap, unpaired), ``spans`` (the kept host spans, ``dropped`` past
    :data:`KEEP_SPANS`) and ``counters``.  Synchronises the devices that
    hold a ring."""
    host = {}
    for (unit_name, key), a in _host.items():
        host.setdefault(unit_name, {})[key] = _ms(a)
    agg, gaps, marks = _device_spans()
    device = {}
    for (unit_name, key), a in agg.items():
        device.setdefault(unit_name, {})[key] = _ms(a)
    for unit_name, spans in device.items():
        for key, s in spans.items():
            name = key.rsplit("/", 1)[-1]
            children = sum(c["total_ms"] for k, c in spans.items()
                           if k.rsplit("/", 1)[0] == name and "/" in k)
            s["self_ms"] = s["total_ms"] - children
    counters = {k: dict(v) for k, v in _counters.items()}
    counters["kernels"] = _kernel_counters()
    return {
        "enabled": on,
        "host": host,
        "device": device,
        "gaps": {u: _ms(g) for u, g in gaps.items()},
        "marks": marks,
        "spans": [list(s) for s in _spans],
        "dropped": _dropped,
        "counters": counters,
    }
