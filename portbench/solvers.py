"""The general generator: a cell's inputs from its seed, the program's
step unit that the window drives, and the plain reference's step.

A traffic file ``portbench/traffic/<mix>.json`` names a ``solver`` and
holds its parameters; the solver is a module of its own,
``portbench/traffic/<solver>.py``, found by that name.  The configuration
file holds the velocity discretisation and the physics.  A solver module
provides, each taking the :class:`Problem`:

* ``draw(problem, rng)``: the numbers the seed draws (a dict);
* ``dt``, ``evals_per_step``, ``batch`` (distributions per eval on one
  rank) and ``initial_state`` (the whole state, float64, on the device);
* ``port_unit(problem, mesh)``: the program's :class:`Unit`;
* ``reference_step(problem, x, tab)`` and ``reference_record(problem, y,
  tab)``: the plain reference's step and record, in ``tab``'s precision;
* ``program_record(problem, rec)``: the program's record as the
  reference's dict of tensors (None where nothing is recorded);
* on a mesh of ranks, ``make_mesh(problem)`` and ``whole(problem,
  blocks)`` (the whole state from the ranks' blocks).

The program is reached through its public entry points only; the route is
the program's own choice (``impl = cli.resolve_impl("auto", device)``)
unless a configuration names one (the CPU tests name ``"fused"``, K1's
plain version, the route ``auto`` takes on the card).
"""

from __future__ import annotations

import dataclasses
import functools
import importlib.util
import time
from typing import Callable, Optional

import numpy as np
import torch

from . import cells
from .reference import spectral


@dataclasses.dataclass
class Unit:
    """What the window drives: ``step(x, pre) -> (x_next, record)``."""

    step: Callable
    pre: object
    collide_fn: Callable  # the operator the step calls, ``collide_fn(f, pre)``
    x0: torch.Tensor  # this rank's initial state
    batch_shape: tuple  # the shape of f in each collide_fn call of a step
    evals_per_step: int
    precomp_s: float  # building the operator's tables, to a synchronise
    #: Steps after which the window starts again from ``x0`` (None: never).
    restart_every: Optional[int] = None


@functools.lru_cache(maxsize=None)
def kind(name: str):
    """The solver module ``portbench/traffic/<name>.py``."""
    path = cells.PKG / "traffic" / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no solver {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(f"portbench_solver_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Problem:
    """A cell's numbers, its inputs and its reference step."""

    config: dict
    traffic: dict
    seed: int
    device: torch.device
    grid: spectral.Grid = dataclasses.field(init=False)
    params: dict = dataclasses.field(init=False)  # what the seed drew

    def __post_init__(self):
        self.grid = spectral.grid(self.config, self.device)
        self.params = self.kind.draw(self, np.random.default_rng(self.seed))

    @property
    def solver(self) -> str:
        return self.traffic["solver"]

    @property
    def kind(self):
        return kind(self.solver)

    @functools.cached_property
    def tab(self) -> spectral.Tables:
        """The reference's float64 tables, built on first use: after the
        window, so that their seconds stay out of ``setup_s``."""
        return spectral.tables(self.config, self.device)

    @property
    def dt(self) -> float:
        return self.kind.dt(self)

    @property
    def evals_per_step(self) -> int:
        return self.kind.evals_per_step(self)

    @property
    def batch(self) -> int:
        return self.kind.batch(self)

    def initial_state(self) -> torch.Tensor:
        return self.kind.initial_state(self)

    def reference_step(self, x: torch.Tensor, tab: Optional[spectral.Tables] = None):
        """``(x_next, record)`` of the plain reference from state ``x`` (the
        whole state), in ``tab``'s precision (float64 by default)."""
        tab = tab or self.tab
        y = self.kind.reference_step(self, x.to(tab.dtype), tab)
        return y, self.reference_record(y, tab)

    def reference_record(self, y: torch.Tensor, tab: Optional[spectral.Tables] = None):
        tab = tab or self.tab
        return self.kind.reference_record(self, y.to(tab.dtype), tab)


def program_record(problem: Problem, rec):
    """The program's record as the reference's dict of tensors."""
    if rec is None or isinstance(rec, dict):
        return rec
    return problem.kind.program_record(problem, rec)


def port_unit(problem: Problem, mesh=None) -> Unit:
    """The program's step unit for the cell (``mesh``: this rank's mesh of a
    sharded cell)."""
    return problem.kind.port_unit(problem, mesh)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def collision_operator(problem: Problem):
    """``(cfg, collide_fn, pre, precomp_s)``: the program's operator for the
    configuration; every key of the configuration file that names a field
    of ``CollisionConfig`` is passed, ``impl`` through ``cli.resolve_impl``
    (``auto`` unless the file names a route)."""
    import boltzfft_torch as bt
    from boltzfft_torch import cli

    dev, numbers = problem.device, problem.config
    fields = {f.name for f in dataclasses.fields(bt.CollisionConfig)} - {"impl"}
    cfg = bt.CollisionConfig(impl=cli.resolve_impl(numbers.get("impl", "auto"), dev),
                             **{k: v for k, v in numbers.items() if k in fields})
    _sync(dev)
    t = time.perf_counter()
    collide_fn, pre = bt.make_collision_operator(cfg, device=dev)
    _sync(dev)
    return cfg, collide_fn, pre, time.perf_counter() - t


def reference_unit(problem: Problem, dtype=torch.float32) -> Unit:
    """The plain reference put in the program's place, in ``dtype``: the
    control of the comparison (the whole state, on one device)."""
    tab = spectral.tables(problem.config, problem.device, dtype)

    def step(x, _pre):
        return problem.reference_step(x, tab)

    def collide_fn(f, _pre):
        return spectral.collide(f, tab)

    x0 = problem.initial_state().to(dtype)
    shape = (-1,) + tuple(problem.grid.shape)
    batch_shape = tuple(x0.reshape(shape).shape) if x0.dim() > 3 else tuple(x0.shape)
    return Unit(step, None, collide_fn, x0, batch_shape, problem.evals_per_step, 0.0,
                problem.traffic.get("restart_every"))
