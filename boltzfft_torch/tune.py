"""Timing-probe autotuners (mirror of ``boltzfft/tune.py``).

The analog of the reference's FFTW planner and wisdom file: each probe times
a short chained run per candidate and memoizes the winner in-process
(``_MEMO``) and, when ``cache_file`` is given, in a JSON wisdom file.

* :func:`autotune`: the staged impls (rfft, with or without ``use_pallas``,
  c2c, dft) probe ``node_chunk``, the nodes per chunk of the node sum;
  ``impl="fused"`` goes to :func:`autotune_fused`.
* :func:`autotune_fused`: probes nothing (see its docstring).
* :func:`autotune_ds`: the ds engine's ``sub_batch`` (nodes of a radial
  group in flight at once).

Each candidate's operator replays its eval from a CUDA graph (``jit=True``):
one untimed chain captures it, then ``trials`` chains of ``k`` evals with
the data dependency ``x = x + 1e-3 Q(x)`` are each bracketed by two CUDA
events (the host clock on the CPU); the best chain over ``k`` is the
candidate's seconds per eval.  The candidate's operator, tables and graph
pool are released before the next one is built.

Only ``torch.cuda.OutOfMemoryError`` (a candidate that does not fit) skips a
candidate; any other error raises, so a tuner never hides a broken kernel.
Keys carry the device's kind, so a winner timed on one device is never
reused on another, and the staged key carries ``use_pallas`` (the JAX
package's does not, so there rfft and rfft + use_pallas share a winner)::

    cfg = bt.autotune(bt.CollisionConfig(nv=64, ns=12, impl="rfft", use_pallas=True),
                      cache_file="wisdom.json")
    collide_fn, pre = bt.make_collision_operator(cfg)
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import time
from pathlib import Path
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .operator import node_chunk_for
from .weights import CollisionConfig

_MEMO: dict = {}


def _open(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but torch.cuda.is_available() is False")
    return device


def _device_kind(device: torch.device) -> str:
    """``torch.cuda.get_device_name`` of a card, else the device type."""
    return torch.cuda.get_device_name(device) if device.type == "cuda" else device.type


def _chunk_key(cfg: CollisionConfig, device: torch.device) -> tuple:
    return (
        "chunk", cfg.impl, cfg.use_pallas, cfg.nv, cfg.nvy, cfg.nvz, cfg.ns, cfg.n_gl,
        cfg.dtype, cfg.antipodal, _device_kind(device),
    )


def _ds_key(cfg: CollisionConfig, contract: str, device: torch.device) -> tuple:
    return (
        "ds", contract, cfg.nv, cfg.nvy, cfg.nvz, cfg.ns, cfg.n_gl, cfg.antipodal,
        _device_kind(device),
    )


def _recall(key: tuple, cache_file: Optional[str]):
    """``(True, winner)`` from the memo or the wisdom file, else ``(False, None)``."""
    if key in _MEMO:
        return True, _MEMO[key]
    if cache_file and Path(cache_file).exists():
        store = json.loads(Path(cache_file).read_text())
        skey = "/".join(map(str, key))
        if skey in store:
            _MEMO[key] = store[skey]
            return True, store[skey]
    return False, None


def _remember(key: tuple, winner, cache_file: Optional[str]) -> None:
    _MEMO[key] = winner
    if cache_file:
        p = Path(cache_file)
        store = json.loads(p.read_text()) if p.exists() else {}
        store["/".join(map(str, key))] = winner
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(store, indent=1))


def _release(device: torch.device) -> None:
    """Return a released candidate's memory (its graph pool too) to the card."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _timed_chains(step: Callable, x0, k: int, trials: int, device: torch.device) -> float:
    """Seconds per step: the best of ``trials`` chains of ``k`` steps from
    ``x0``, after one untimed chain (which captures the graphs)."""

    def chain():
        x = x0
        for _ in range(k):
            x = step(x)
        return x

    chain()
    best = math.inf
    for _ in range(trials):
        if device.type == "cuda":
            with torch.cuda.device(device):
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                chain()
                end.record()
                end.synchronize()
                t = start.elapsed_time(end) * 1e-3
        else:
            t0 = time.perf_counter()
            chain()
            t = time.perf_counter() - t0
        best = min(best, t)
    return best / k


def _bkw_f64(cfg: CollisionConfig) -> np.ndarray:
    from .bkw import bkw_f

    return np.asarray(bkw_f(cfg.velocity_grid.r_squared(), 6.5), np.float64)


def _time_candidate(cfg: CollisionConfig, k: int, trials: int, *, device) -> float:
    """Best-of-``trials`` seconds per eval of ``make_collision_operator(cfg,
    jit=True)``, k-chained, on the BKW f at t = 6.5."""
    from .operator import make_collision_operator

    device = torch.device(device)
    collide_fn, pre = make_collision_operator(cfg, jit=True, device=device)
    try:
        f0 = torch.as_tensor(_bkw_f64(cfg), dtype=cfg.real_dtype, device=device)
        return _timed_chains(lambda x: x + 1e-3 * collide_fn(x, pre), f0, k, trials, device)
    finally:
        del collide_fn, pre
        _release(device)


def autotune_fused(
    cfg: CollisionConfig,
    candidates=None,
    k: int = 8,
    trials: int = 2,
    verbose: bool = False,
    cache_file: Optional[str] = None,
    *,
    device="cuda",
) -> CollisionConfig:
    """Return ``cfg`` unchanged: nothing to probe.

    The JAX package probes its TPU kernel's blocking (``fused_nodes_per_step``,
    ``fused_sub_batch``; ``fused_radix`` beside them), VMEM footprint against
    matmul width.  The port leaves those knobs out: K1-K4 chunk their nodes
    for their buffers only (the chunk moves no bit of the result), from the
    free device memory (``operator.kernel_chunk``).  ``candidates`` for the
    left-out knobs raise ``ValueError``.
    """
    _open(device)
    if candidates is not None:
        raise ValueError(
            "autotune_fused: the port has no fused_nodes_per_step / fused_sub_batch /"
            " fused_radix (the TPU kernels' VMEM tiling) to probe; K1-K4 chunk nodes by"
            " free device memory")
    if verbose:
        print("autotune_fused: nothing to probe (K1-K4 chunk their nodes by free device"
              " memory); cfg unchanged")
    return cfg


def _chunk_candidates(cfg: CollisionConfig, device: torch.device) -> list:
    """Distinct node_chunk values worth probing: the memory-derived auto
    chunk, its halvings, its doubling and the whole batch, normalized
    through the chunk the operator really runs (the precomp's padded node
    count and ``operator.node_chunk_for``'s divisor rule): two values that
    settle to one chunk are probed once."""
    auto = cfg.auto_chunk(device)
    b = cfg.n_nodes
    raw = {auto, max(1, auto // 2), max(1, auto // 4), min(b, 2 * auto), b}
    seen, cands = set(), []
    for c in sorted(raw):
        eff = node_chunk_for(dataclasses.replace(cfg, node_chunk=c), device)
        if eff in seen:
            continue
        seen.add(eff)
        cands.append(c)
    return cands


def autotune(
    cfg: CollisionConfig,
    candidates: Optional[Sequence] = None,
    k: int = 8,
    trials: int = 2,
    verbose: bool = False,
    cache_file: Optional[str] = None,
    *,
    device="cuda",
) -> CollisionConfig:
    """Measured-best blocking parameters for any impl on ``device`` (see the
    module docstring).

    Returns ``cfg`` updated with the winning ``node_chunk``; memoized
    in-process and in ``cache_file`` when given.
    """
    device = _open(device)
    if cfg.impl == "fused":
        return autotune_fused(
            cfg, candidates=candidates, k=k, trials=trials,
            verbose=verbose, cache_file=cache_file, device=device,
        )
    key = _chunk_key(cfg, device)
    found, winner = _recall(key, cache_file)
    if found:
        return dataclasses.replace(cfg, node_chunk=winner)

    cands = list(candidates) if candidates is not None else _chunk_candidates(cfg, device)
    best, best_t = cfg.node_chunk, math.inf
    for c in cands:
        trial_cfg = dataclasses.replace(cfg, node_chunk=c)
        try:
            t = _time_candidate(trial_cfg, k, trials, device=device)
        except torch.cuda.OutOfMemoryError as e:  # the candidate does not fit: skip it
            if verbose:
                print(f"autotune: node_chunk={c} does not fit: {e}")
            del e
            _release(device)
            continue
        if verbose:
            print(f"autotune: node_chunk={c} (chunk {node_chunk_for(trial_cfg, device)})"
                  f" -> {t:.4e} s/eval")
        if t < best_t:
            best, best_t = c, t
    _remember(key, best, cache_file)
    return dataclasses.replace(cfg, node_chunk=best)


def _time_ds_candidate(cfg: CollisionConfig, pre, sub_batch: int, contract: str,
                       k: int, trials: int, *, device) -> float:
    """Best-of-``trials`` seconds per ds eval at ``sub_batch`` on the tables
    ``pre``, k-chained (``s = s + 1e-3 Q(s)`` in ds arithmetic), through an
    operator of its own (its own graph)."""
    from . import ds
    from .ds_operator import ds_collide_fn

    device = torch.device(device)
    collide_fn = ds_collide_fn(cfg, jit=True, sub_batch=sub_batch, contract=contract,
                               device=device)
    try:
        f0 = ds.from_f64(_bkw_f64(cfg), device=device)
        h = torch.tensor(1e-3, dtype=f0.hi.dtype, device=device)
        return _timed_chains(lambda s: ds.add(s, ds.mul_f(collide_fn(s, pre), h)), f0, k,
                             trials, device)
    finally:
        del collide_fn
        _release(device)


def autotune_ds(
    cfg: CollisionConfig,
    contract: Optional[str] = None,
    candidates: Optional[Sequence[int]] = None,
    k: int = 2,
    trials: int = 2,
    verbose: bool = False,
    cache_file: Optional[str] = None,
    *,
    device="cuda",
) -> int:
    """Measured-best ``sub_batch`` for the compensated (ds) pipeline on
    ``device``.

    Pass the result to :func:`boltzfft_torch.make_ds_collision_operator`.
    The candidates cover divisors-ish of the per-radial-group node count
    (``cfg.ns_eff``); the ds tables are built once per call, and each
    candidate is timed through an operator of its own.  Winners are
    memoized like the other autotuners'.
    """
    from .ds_operator import build_ds_precomp, default_contract

    device = _open(device)
    engine = contract or default_contract(device)
    key = _ds_key(cfg, engine, device)
    found, winner = _recall(key, cache_file)
    if found:
        return winner

    ns = cfg.ns_eff
    if candidates is None:
        candidates = sorted({c for c in (1, 2, 3, 4, 6, 8, ns) if c <= ns})
    best, best_t = min(4, ns), math.inf
    pre = build_ds_precomp(cfg, device=device)
    try:
        for sb in candidates:
            try:
                t = _time_ds_candidate(cfg, pre, sb, engine, k, trials, device=device)
            except torch.cuda.OutOfMemoryError as e:  # does not fit: skip it
                if verbose:
                    print(f"autotune_ds: sub_batch={sb} does not fit: {e}")
                del e
                _release(device)
                continue
            if verbose:
                print(f"autotune_ds: sub_batch={sb} -> {t:.4e} s/eval")
            if t < best_t:
                best, best_t = sb, t
    finally:
        del pre
        _release(device)
    _remember(key, best, cache_file)
    return best
