"""Explicit time integration of the space-homogeneous Boltzmann equation
``df/dt = Q(f, f)`` (mirror of ``boltzfft/timestepper.py``).

The steppers are classic explicit RK schemes written as plain functions of a
right-hand side; :func:`relax` runs them in an eager Python loop (``boltzfft``
runs the same loop as one ``lax.scan``) and stacks what ``record`` returns
after every step along a leading time axis, field by field, as ``scan``
stacks a pytree.  :func:`make_relaxation` binds an operator into that loop
and, on the card, replays each step (with its ``record``) from one CUDA
graph (:class:`boltzfft_torch._graph.Replayed`), as the JAX package jits
its ``run``: the operator's kernels are captured into the step's graph,
and N replays give the bits of N eager steps.  A
:class:`boltzfft_torch.ds.DS` state (the compensated ds engine) steps in
double-single arithmetic.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from . import _graph
from . import ds as _ds

RHS = Callable[[torch.Tensor], torch.Tensor]


def ds_coefs(dt: float, dtype=torch.float32, device="cuda") -> dict:
    """The ds scalars of every coefficient a step multiplies by (``dt``,
    ``dt/2``, ``dt/3``, ``dt/6``, each formed as the steppers form it), split
    from host float64 once: an upload from the host cannot be captured."""
    return {a: _ds.from_f64(np.float64(a), dtype, device)
            for a in (dt, 0.5 * dt, dt / 3.0, dt / 6.0)}


def _axpy(f, a: float, k, coefs: Optional[dict] = None):
    """``f + a * k`` in the state's own arithmetic; a ds state takes the ds
    scalar of ``a`` from ``coefs`` (:func:`ds_coefs`) or splits it here."""
    if isinstance(f, _ds.DS):
        # the scalar is split too: fl32(dt/6) alone costs 2^-24 relative per
        # stage, swamping the ds state's 2^-48
        s = coefs[a] if coefs is not None else _ds.from_f64(np.float64(a), k.hi.dtype, k.hi.device)
        return _ds.axpy(f, k, s)  # add(f, mul(k, s)): one launch on the card
    return f + a * k


def euler_step(rhs: RHS, f, dt: float, coefs: Optional[dict] = None):
    return _axpy(f, dt, rhs(f), coefs)


def rk2_step(rhs: RHS, f, dt: float, coefs: Optional[dict] = None):
    """Midpoint (SSP-friendly 2nd order) step."""
    k1 = rhs(f)
    return _axpy(f, dt, rhs(_axpy(f, 0.5 * dt, k1, coefs)), coefs)


def rk4_step(rhs: RHS, f, dt: float, coefs: Optional[dict] = None):
    """Classic 4th-order Runge-Kutta step."""
    k1 = rhs(f)
    k2 = rhs(_axpy(f, 0.5 * dt, k1, coefs))
    k3 = rhs(_axpy(f, 0.5 * dt, k2, coefs))
    k4 = rhs(_axpy(f, dt, k3, coefs))
    if isinstance(f, _ds.DS):
        out = _axpy(f, dt / 6.0, k1, coefs)
        out = _axpy(out, dt / 3.0, k2, coefs)
        out = _axpy(out, dt / 3.0, k3, coefs)
        return _axpy(out, dt / 6.0, k4, coefs)
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


def _stepper(method: str):
    if method not in _STEPPERS:
        raise ValueError(f"method must be one of {sorted(_STEPPERS)}, got {method!r}")
    return _STEPPERS[method]


def _coefs_for(f, dt: float) -> Optional[dict]:
    """:func:`ds_coefs` for a ds state, on its device; None for a tensor."""
    if isinstance(f, _ds.DS):
        return ds_coefs(dt, f.hi.dtype, f.hi.device)
    return None


def _march(one: Callable, f0, n_steps: int, record) -> Trajectory:
    """``n_steps`` calls of the one-step unit ``one(f) -> (f_next,
    record(f_next))``, the records stacked (None without a ``record``)."""
    f, recs = f0, []
    for _ in range(n_steps):
        f, rec = one(f)
        recs.append(rec)
    return Trajectory(f=f, recorded=_stack(recs) if record is not None and recs else None)


def relax(
    rhs: RHS,
    f0: torch.Tensor,
    dt: float,
    n_steps: int,
    method: str = "rk4",
    record: Optional[Callable[[torch.Tensor], Any]] = None,
) -> Trajectory:
    """Integrate ``df/dt = rhs(f)`` for ``n_steps`` of size ``dt``, eagerly.

    ``record(f)`` (e.g. a moments closure) is evaluated after every step and
    stacked along a leading time axis."""
    step = _stepper(method)
    coefs = _coefs_for(f0, dt)

    def one(f):
        f = step(rhs, f, dt, coefs)
        return f, (record(f) if record is not None else None)

    return _march(one, f0, n_steps, record)


def make_relaxation(
    collide_fn: Callable,
    pre,
    dt: float,
    n_steps: int,
    method: str = "rk4",
    record: Optional[Callable[[torch.Tensor], Any]] = None,
    *,
    jit: bool = True,
) -> Callable[[torch.Tensor], Trajectory]:
    """Bind a collision operator into a relaxation loop ``f0 -> Trajectory``.

    ``jit=True`` on a CUDA state replays one step and its ``record`` from a
    CUDA graph per ``pre`` and state shape (the first call runs one eager
    step, then captures one; an operator built with ``jit=True`` runs
    eagerly inside them, so the step's graph holds its kernels), once per
    step: the bits of ``jit=False``, which runs every step eagerly.  A graph
    has no backward: a state that requires grad raises under ``jit=True``
    (differentiate with ``jit=False``).  On the CPU ``jit`` changes nothing.
    The ds scalars of a ds state's coefficients are split once per
    ``run``, outside the capture.  ``run.step`` is the one-step unit
    ``(f, pre) -> (f_next, record(f_next))`` that ``run`` calls."""
    stepper = _stepper(method)
    coefs = {}  # (dtype, device) of a ds state -> its ds_coefs

    def body(f, p):
        c = _graph.hold(coefs[(f.hi.dtype, f.hi.device)]) if isinstance(f, _ds.DS) else None
        f = stepper(lambda x: collide_fn(x, p), f, dt, c)
        return f, (record(f) if record is not None else None)

    replayed = _graph.Replayed(body, "relaxation.step") if jit else None

    def run(f0):
        lead = f0.hi if isinstance(f0, _ds.DS) else f0
        if isinstance(f0, _ds.DS):
            coefs[(lead.dtype, lead.device)] = _coefs_for(f0, dt)
        one = body
        if replayed is not None and lead.is_cuda:
            if torch.is_grad_enabled() and lead.requires_grad:
                raise RuntimeError(
                    "make_relaxation(jit=True) replays a CUDA graph, which has no backward;"
                    " build it with jit=False to differentiate")
            one = replayed
        return _march(lambda f: one(f, pre), f0, n_steps, record)

    run.step = replayed if replayed is not None else body
    return run
