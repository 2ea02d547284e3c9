"""Checkpoint and resume for long relaxation runs (mirror of
``boltzfft/checkpoint.py``, on ``torch.save`` instead of orbax).

The state is the distribution ``f`` (a tensor, or a :class:`ds.DS` pair),
the simulation time ``t`` and an optional ``extra`` (tensors, numbers,
lists, dicts), saved under integer step numbers.  Every rank saves its own
block of ``f``::

    ck = RelaxCheckpointer(dir, max_to_keep=3)
    step = ck.latest_step()
    if step is not None:
        f, t = ck.restore(step, template=f)     # template: device, dtype, shape
    ...
    ck.save(step, f, t)
    ck.close()

A step is the directory ``<dir>/<step>`` holding ``rank<r>.pt`` (rank r's
block) and ``meta.pt`` (``t``, ``extra``, the number of ranks).  It is
written as ``<dir>/<step>.tmp`` and committed by rank 0 with one
``os.replace`` after a barrier of every rank, so a run cut mid-save leaves
the last committed step.  Saves are synchronous.
"""

from __future__ import annotations

import os
import shutil
from pathlib import Path
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from . import ds as _ds

_TMP = ".tmp"


def _world() -> Tuple[int, int]:
    if not dist.is_initialized():
        return 1, 0
    return dist.get_world_size(), dist.get_rank()


def _barrier() -> None:
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def _host(x):
    """``x`` with every tensor detached on the CPU (lists, tuples, dicts
    walked)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_host(v) for v in x] if isinstance(x, list) else tuple(_host(v) for v in x)
    return x


def _like(x, template):
    """``x`` on the template's device and dtype, its shape checked (tensors
    of matching dicts, lists and tuples likewise); ``x`` as saved where the
    template is None."""
    if template is None:
        return x
    if isinstance(template, torch.Tensor):
        if tuple(x.shape) != tuple(template.shape):
            raise ValueError(
                f"checkpoint holds shape {tuple(x.shape)}, the template {tuple(template.shape)}")
        return x.to(device=template.device, dtype=template.dtype)
    if isinstance(template, dict):
        return {k: _like(x[k], template[k]) for k in template}
    if isinstance(template, (list, tuple)):
        out = [_like(a, b) for a, b in zip(x, template)]
        if isinstance(template, list):
            return out
        return type(template)(*out) if hasattr(template, "_fields") else tuple(out)
    return x


class RelaxCheckpointer:
    """Saves and restores ``{"f", "t", "extra"}`` under integer steps, with
    atomic directory commits and ``max_to_keep`` retention (the oldest
    committed steps go first)."""

    def __init__(self, directory: str | Path, max_to_keep: int = 3):
        self.directory = Path(directory).expanduser().resolve()
        self.max_to_keep = max_to_keep
        self.directory.mkdir(parents=True, exist_ok=True)

    def _steps(self) -> list:
        return sorted(int(p.name) for p in self.directory.iterdir()
                      if p.is_dir() and p.name.isdigit())

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def save(self, step: int, f, t: float, extra: Any = None) -> None:
        """Write this rank's ``f`` (and, on rank 0, ``t`` and ``extra``) as
        step ``step``; every rank calls it."""
        world, rank = _world()
        tmp = self.directory / f"{int(step)}{_TMP}"
        if rank == 0:
            shutil.rmtree(tmp, ignore_errors=True)
            tmp.mkdir()
        _barrier()
        if isinstance(f, _ds.DS):
            state = {"kind": "ds", "leaves": [f.hi.detach().cpu(), f.lo.detach().cpu()]}
        else:
            state = {"kind": "tensor", "leaves": [f.detach().cpu()]}
        torch.save(state, tmp / f"rank{rank}.pt")
        if rank == 0:
            torch.save({"t": float(t), "extra": _host(extra), "world": world}, tmp / "meta.pt")
        _barrier()
        if rank == 0:
            final = self.directory / str(int(step))
            shutil.rmtree(final, ignore_errors=True)
            os.replace(tmp, final)
            for old in self._steps()[: -self.max_to_keep] if self.max_to_keep else ():
                shutil.rmtree(self.directory / str(old), ignore_errors=True)
        _barrier()

    def restore(
        self, step: Optional[int] = None, template=None, extra_template: Any = None
    ) -> Tuple[Any, float]:
        """Restore ``(f, t)`` (or ``(f, t, extra)`` when ``extra_template``
        is given) of this rank.  ``template`` (a tensor or a ``DS``) sets the
        device and dtype of ``f`` and must have its shape; without one, ``f``
        comes back on the CPU as saved."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError("no checkpoint found")
        world, rank = _world()
        where = self.directory / str(int(step))
        meta = torch.load(where / "meta.pt", weights_only=True)
        if meta["world"] != world:
            raise ValueError(
                f"checkpoint step {step} was written by {meta['world']} ranks, restoring on {world}")
        state = torch.load(where / f"rank{rank}.pt", weights_only=True)
        leaves = state["leaves"]
        f = _ds.DS(*leaves) if state["kind"] == "ds" else leaves[0]
        f = _like(f, template)
        if extra_template is not None:
            return f, float(meta["t"]), _like(meta["extra"], extra_template)
        return f, float(meta["t"])

    def wait(self) -> None:
        """Nothing to wait for: :meth:`save` returns once the step is
        committed (kept for the JAX package's interface)."""

    def close(self) -> None:
        """Nothing to release (kept for the JAX package's interface)."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
