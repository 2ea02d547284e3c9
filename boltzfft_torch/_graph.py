"""CUDA-graph replay of a compile unit: the card's counterpart of ``jax.jit``.

:class:`Replayed` wraps ``fn(x, pre)``, where ``x`` is a tree of CUDA
tensors (a :class:`boltzfft_torch.ds.DS`, or one tensor f) and ``pre`` the
tables.  Its units are those the JAX package jits: the eval (every route of
``make_collision_operator``, ``make_ds_collision_operator`` and the sharded
operators), one step of ``make_relaxation`` (with its ``record``), a
sharded Strang step built with ``jit=True``, and the spatial drivers'
step-plus-diagnostics body.  The
first call for a (``pre`` object, ``x``'s shapes and dtypes) runs ``fn`` once
eagerly on a side stream, which builds and loads the kernel library and
fills the plan caches outside capture, then captures one ``fn`` into a
``torch.cuda.CUDAGraph``.  Every call copies ``x`` into the graph's static
input, replays the graph and returns a clone of its static output: a caller
that keeps results across calls (RK4's k1..k4) never sees one overwritten.
The replay launches the captured kernels with the same arguments, so its
result has the same bits as an eager call.

A replay reads every tensor the capture used in place.  The graph keeps
``pre``, its static input and its static output alive; a tensor the eval
takes from a cache of its own (``ds_operator._grid_consts``, the K3 tables
in ``pre.derived``) it passes
through :func:`hold`, which keeps it alive with the graph being captured,
so a cache that evicts or is cleared never frees memory a replay reads.

Replayed units nest as nested ``jax.jit`` calls do: while one runs its
warm-up or its capture, a :class:`Replayed` it calls (a step's operator)
runs its eager ``fn``, so the outer graph captures the inner kernels, and
the inner one captures no graph of its own (a second pool that would never
be replayed).  The inner eval settles its chunks as it does eagerly, so the
bits are the same.

A capture that fails raises, with the cause: there is no eager fallback.
The kernel wrappers' launch counters count Python calls, so a replay moves
none of them; the warm-up and the capture each count once.

Each unit has a name (``relaxation.step``, ``step_body``,
``sharded_step_2d``, ``collide``, ``collide_ds``, ...), under which
:mod:`boltzfft_torch.obs` counts its captures, evictions and graph nodes,
and, while obs is on, keeps its spans: ``replay`` (``replay.copy_in``,
``replay.launch``, ``replay.clone_out``), ``capture`` (``capture.warmup``,
``capture.graph``) and the device span ``step`` around the captured ``fn``
(its graph's first and last nodes).  A capture made with obs on keeps its
``cudaGraph_t`` (``CUDAGraph(keep_graph=True)``), so ``debug_dump`` and
``raw_cuda_graph`` can read its nodes; off, it is freed once built.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, NamedTuple

import torch

from . import obs
from .ds import tree_map

#: Graphs a :class:`Replayed` keeps alive, the least recently used going first.
KEEP = 2

# what the capture under way holds (None outside a capture)
_held: list | None = None
# warm-ups and captures under way (a Replayed called inside one runs eagerly)
_depth = 0


def jit(fn: Callable, device, name: str | None = None) -> Callable:
    """``fn(x, pre)`` as ``jax.jit`` makes it: a :class:`Replayed` (named
    ``name``) on a CUDA ``device``, ``fn`` itself elsewhere."""
    return Replayed(fn, name) if torch.device(device).type == "cuda" else fn


def hold(obj):
    """``obj``, kept alive as long as the graph being captured (if any)."""
    if _held is not None:
        _held.append(obj)
    return obj


def _leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


class _Captured(NamedTuple):
    pre: object  # held: the graph reads its tensors in place (and its id stays unique)
    graph: object  # torch.cuda.CUDAGraph
    x: object  # the static input tree
    out: object  # the static output tree
    held: list  # what the eval passed through hold() during the capture


class Replayed:
    """``fn(x, pre)`` replayed from a CUDA graph per (``pre``, ``x``'s
    shapes, dtypes and device); at most :data:`KEEP` graphs stay alive.
    ``name`` (``fn``'s own by default) names the unit in :mod:`obs`."""

    def __init__(self, fn: Callable, name: str | None = None):
        self.fn = fn
        self.name = name or getattr(fn, "__name__", "fn")
        self._graphs: OrderedDict = OrderedDict()

    def __call__(self, x, pre):
        if _depth:  # inside an outer unit's warm-up or capture: its graph takes our kernels
            return self.fn(x, pre)
        if obs.on:
            return self._observed(x, pre)
        leaves = _leaves(x)
        entry = self._entry(leaves, x, pre)
        for dst, src in zip(_leaves(entry.x), leaves):
            dst.copy_(src)
        entry.graph.replay()
        return tree_map(torch.clone, entry.out)

    def _observed(self, x, pre):
        """``__call__`` with its spans (obs on)."""
        with obs.unit(self.name):
            leaves = _leaves(x)
            entry = self._entry(leaves, x, pre)
            with obs.span("replay"):
                with obs.span("replay.copy_in"):
                    for dst, src in zip(_leaves(entry.x), leaves):
                        dst.copy_(src)
                with obs.span("replay.launch"):
                    entry.graph.replay()
                with obs.span("replay.clone_out"):
                    return tree_map(torch.clone, entry.out)

    def _entry(self, leaves, x, pre) -> _Captured:
        key = (id(pre),) + tuple((t.shape, t.dtype, t.device) for t in leaves)
        entry = self._graphs.get(key)
        if entry is None or entry.pre is not pre:
            entry = self._graphs[key] = self._capture(x, pre, leaves[0].device)
            while len(self._graphs) > KEEP:
                self._graphs.popitem(last=False)
                obs.count("evictions", self.name)
        self._graphs.move_to_end(key)
        return entry

    def _step(self, x, pre, like):
        with obs.span("step", like=like):
            return self.fn(x, pre)

    def _capture(self, x, pre, dev: torch.device) -> _Captured:
        global _held, _depth
        static = tree_map(torch.clone, x)
        observed = obs.on
        like = _leaves(static)[0]
        _depth += 1
        try:
            with torch.cuda.device(dev), obs.span("capture"):
                if observed:
                    obs.prepare(dev)
                side = torch.cuda.Stream()
                side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(side), obs.span("capture.warmup"):
                    self._step(static, pre, like)  # warm-up, outside capture
                torch.cuda.current_stream().wait_stream(side)
                obs.capture_nodes(dev)  # the library's runtime starts outside the capture
                graph = torch.cuda.CUDAGraph(keep_graph=observed)
                _held = held = []
                try:
                    with obs.span("capture.graph"):
                        with torch.cuda.graph(graph):
                            out = self._step(static, pre, like)
                            nodes = obs.capture_nodes(dev)
                        if observed:
                            graph.instantiate()
                except RuntimeError as err:
                    raise RuntimeError(f"capturing {getattr(self.fn, '__name__', 'fn')} into a"
                                       f" CUDA graph failed: {err}") from err
                finally:
                    _held = None
        finally:
            _depth -= 1
        obs.count("captures", self.name)
        if nodes is not None:
            obs.note("graph_nodes", self.name, nodes)
        return _Captured(pre, graph, static, out, held)
