"""Solver ``relaxation``: the space-homogeneous equation ``df/dt = Q(f, f)``
for ``batch`` distributions (default 1), stepped by
``make_relaxation(...).step`` (one CUDA graph a step on the card), with the
moments recorded after every step when ``record`` is ``"moments"``.

Parameters: ``method`` (``euler``, ``rk2``, ``rk4``), ``dt``, ``record``,
``initial``, ``batch`` and ``restart_every``.  ``initial: "bkw"``: each
distribution the BKW state at its own time drawn from the seed in ``t0``.
``restart_every``: the window starts again from the initial state after
that many steps, as back-to-back driver runs of that many steps do, so
that the steps compared lie in the same stretch of the relaxation however
many steps a window holds.
"""

import torch

from portbench import solvers
from portbench.reference import spectral, stepping

EVALS = {"euler": 1, "rk2": 2, "rk4": 4}


def draw(problem, rng) -> dict:
    if problem.traffic["initial"] != "bkw":
        raise ValueError(f"unknown initial state {problem.traffic['initial']!r}")
    lo, hi = problem.traffic["t0"]
    return {"t0": [float(t) for t in rng.uniform(lo, hi, size=batch(problem))]}


def dt(problem) -> float:
    return float(problem.traffic["dt"])


def evals_per_step(problem) -> int:
    return EVALS[problem.traffic["method"]]


def batch(problem) -> int:
    return int(problem.traffic.get("batch", 1))


def initial_state(problem) -> torch.Tensor:
    """(Nx, Ny, Nz) for one distribution, (E, Nx, Ny, Nz) for a batch."""
    r2 = stepping.r_squared(problem.grid)
    fs = [stepping.bkw_f(r2, t) for t in problem.params["t0"]]
    return fs[0] if batch(problem) == 1 else torch.stack(fs)


def port_unit(problem, mesh=None) -> solvers.Unit:
    import boltzfft_torch as bt

    cfg, collide_fn, pre, precomp_s = solvers.collision_operator(problem)
    x0 = initial_state(problem).to(cfg.real_dtype)
    g = cfg.velocity_grid
    v = g.v if cfg.is_isotropic else (g.vx, g.vy, g.vz)
    record = (lambda f: bt.moments(f, v, cell_volume=g.cell_volume)) \
        if problem.traffic.get("record") == "moments" else None
    # jit only on the card: off it, run.step would still be the graph unit
    run = bt.make_relaxation(collide_fn, pre, dt=dt(problem), n_steps=1,
                             method=problem.traffic["method"], record=record,
                             jit=problem.device.type == "cuda")
    return solvers.Unit(run.step, pre, collide_fn, x0, tuple(x0.shape), evals_per_step(problem),
                        precomp_s, problem.traffic.get("restart_every"))


def reference_step(problem, x: torch.Tensor, tab: spectral.Tables) -> torch.Tensor:
    return stepping.rk_step(lambda f: spectral.collide(f, tab), x, dt(problem),
                            problem.traffic["method"])


def reference_record(problem, y: torch.Tensor, tab: spectral.Tables):
    return stepping.moments(y, tab) if problem.traffic.get("record") == "moments" else None


def program_record(problem, rec) -> dict:
    return {k: getattr(rec, k) for k in ("mass", "momentum", "energy", "temperature")}
