"""Explicit time integration of the space-homogeneous Boltzmann equation
``df/dt = Q(f, f)`` (mirror of ``boltzfft/timestepper.py``).

The steppers are classic explicit RK schemes written as plain functions of a
right-hand side; :func:`relax` runs them in a Python loop (``boltzfft`` runs
the same loop as one ``lax.scan``) and stacks what ``record`` returns after
every step along a leading time axis, field by field, as ``scan`` stacks a
pytree.  A :class:`boltzfft_torch.ds.DS` state (the compensated ds engine)
steps in double-single arithmetic.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from . import ds as _ds

RHS = Callable[[torch.Tensor], torch.Tensor]


def _axpy(f, a: float, k):
    """``f + a * k`` in the state's own arithmetic."""
    if isinstance(f, _ds.DS):
        # the scalar is split too: fl32(dt/6) alone costs 2^-24 relative per
        # stage, swamping the ds state's 2^-48
        return _ds.add(f, _ds.mul(k, _ds.from_f64(np.float64(a), k.hi.dtype, k.hi.device)))
    return f + a * k


def euler_step(rhs: RHS, f, dt: float):
    return _axpy(f, dt, rhs(f))


def rk2_step(rhs: RHS, f, dt: float):
    """Midpoint (SSP-friendly 2nd order) step."""
    k1 = rhs(f)
    return _axpy(f, dt, rhs(_axpy(f, 0.5 * dt, k1)))


def rk4_step(rhs: RHS, f, dt: float):
    """Classic 4th-order Runge-Kutta step."""
    k1 = rhs(f)
    k2 = rhs(_axpy(f, 0.5 * dt, k1))
    k3 = rhs(_axpy(f, 0.5 * dt, k2))
    k4 = rhs(_axpy(f, dt, k3))
    if isinstance(f, _ds.DS):
        out = _axpy(f, dt / 6.0, k1)
        out = _axpy(out, dt / 3.0, k2)
        out = _axpy(out, dt / 3.0, k3)
        return _axpy(out, dt / 6.0, k4)
    return f + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


_STEPPERS = {"euler": euler_step, "rk2": rk2_step, "rk4": rk4_step}


class Trajectory(NamedTuple):
    f: torch.Tensor  # final state
    recorded: Optional[Any]  # per-step records stacked along dim 0 (or None)


def _stack(records: list):
    """Stack a list of records along a new leading axis: tensors directly,
    named tuples (e.g. ``Moments``) field by field."""
    first = records[0]
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(_stack(list(col)) for col in zip(*records)))
    if isinstance(first, (tuple, list)):
        return type(first)(_stack(list(col)) for col in zip(*records))
    return torch.stack(records)


def relax(
    rhs: RHS,
    f0: torch.Tensor,
    dt: float,
    n_steps: int,
    method: str = "rk4",
    record: Optional[Callable[[torch.Tensor], Any]] = None,
) -> Trajectory:
    """Integrate ``df/dt = rhs(f)`` for ``n_steps`` of size ``dt``.

    ``record(f)`` (e.g. a moments closure) is evaluated after every step and
    stacked along a leading time axis."""
    if method not in _STEPPERS:
        raise ValueError(f"method must be one of {sorted(_STEPPERS)}, got {method!r}")
    step = _STEPPERS[method]
    f = f0
    recs = []
    for _ in range(n_steps):
        f = step(rhs, f, dt)
        if record is not None:
            recs.append(record(f))
    recorded = _stack(recs) if record is not None and recs else None
    return Trajectory(f=f, recorded=recorded)


def make_relaxation(
    collide_fn: Callable,
    pre,
    dt: float,
    n_steps: int,
    method: str = "rk4",
    record: Optional[Callable[[torch.Tensor], Any]] = None,
) -> Callable[[torch.Tensor], Trajectory]:
    """Bind a collision operator into a relaxation loop ``f0 -> Trajectory``."""

    def rhs(f):
        return collide_fn(f, pre)

    def run(f0):
        return relax(rhs, f0, dt, n_steps, method=method, record=record)

    return run
