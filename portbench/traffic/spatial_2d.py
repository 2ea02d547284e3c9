"""Solver ``spatial_2d``: ``df/dt + v . grad f = Q/Kn`` on a periodic square
of ``cells`` (Cx, Cy), stepped by the CLIs' body ``cli.step_body(...)``
(the step and its monitor), or on a ``mesh`` (Mx, My) of ranks by the
sharded step ``make_sharded_step_2d(..., jit=True)``, each rank a block of
the cells.  The time step is the configuration's CFL step.

Parameters: ``cells``, ``mesh``, ``initial`` and ``restart_every`` (as in
``relaxation``).  ``initial: "taylor_green"``: per-cell Maxwellians carrying
the Taylor-Green vortex, its phase drawn from the seed.
"""

import math

import torch

from portbench import solvers
from portbench.reference import spectral, stepping


def draw(problem, rng) -> dict:
    if problem.traffic["initial"] != "taylor_green":
        raise ValueError(f"unknown initial state {problem.traffic['initial']!r}")
    ln = problem.config["x_length"]
    return {"phase_x": float(rng.uniform(0.0, ln)), "phase_y": float(rng.uniform(0.0, ln))}


def cell_side(problem) -> float:
    return problem.config["x_length"] / problem.traffic["cells"][0]


def dt(problem) -> float:
    v_max = max(float(abs(v).max()) for v in problem.grid.v)
    return problem.config["cfl_safety"] * cell_side(problem) / v_max


def evals_per_step(problem) -> int:
    return 2  # the collision substep's RK2 midpoint


def _mesh_dims(problem) -> tuple:
    return tuple(problem.traffic.get("mesh") or (1, 1))


def batch(problem) -> int:
    (cx, cy), (mx, my) = problem.traffic["cells"], _mesh_dims(problem)
    return (cx // mx) * (cy // my)


def initial_state(problem) -> torch.Tensor:
    """(Cx, Cy, Nx, Ny, Nz), float64."""
    cx, cy = problem.traffic["cells"]
    cfg, dev = problem.config, problem.device
    ln, u0 = cfg["x_length"], cfg["u0"]
    k = 2.0 * math.pi / ln
    x = (torch.arange(cx, dtype=torch.float64, device=dev) + 0.5) * (ln / cx)
    y = (torch.arange(cy, dtype=torch.float64, device=dev) + 0.5) * (ln / cy)
    sx = torch.sin(k * (x + problem.params["phase_x"]))[:, None]
    cxv = torch.cos(k * (x + problem.params["phase_x"]))[:, None]
    sy = torch.sin(k * (y + problem.params["phase_y"]))[None, :]
    cyv = torch.cos(k * (y + problem.params["phase_y"]))[None, :]
    return stepping.maxwellian(u0 * sx * cyv, -u0 * cxv * sy, problem.grid, cfg["density"],
                               cfg["temperature"])


def make_mesh(problem):
    """This rank's (Mx, My) mesh of cards, or None for one rank."""
    if not problem.traffic.get("mesh"):
        return None
    import boltzfft_torch as bt

    mx, my = problem.traffic["mesh"]
    return bt.make_mesh([("cx", mx), ("cy", my)], device=problem.device.type)


def whole(problem, blocks: list) -> torch.Tensor:
    """The whole (Cx, Cy, ...) state from the ranks' blocks, rank order."""
    mx, my = _mesh_dims(problem)
    rows = [torch.cat(blocks[i * my:(i + 1) * my], dim=1) for i in range(mx)]
    return torch.cat(rows, dim=0)


def port_unit(problem, mesh=None) -> solvers.Unit:
    import boltzfft_torch as bt
    from boltzfft_torch import cli, transport
    from boltzfft_torch.cli.taylor_green_2d3v import diagnostics_fn

    cfg, collide_fn, pre, precomp_s = solvers.collision_operator(problem)
    x0 = initial_state(problem).to(cfg.real_dtype)
    d, dev = cell_side(problem), problem.device
    kw = dict(dx=d, dy=d, dt=dt(problem), knudsen=problem.config["knudsen"],
              scheme=problem.config["scheme"])
    if mesh is None:
        step = transport.make_inhomogeneous_step_2d(cfg, collide_fn, **kw)
        body = cli.step_body(step, diagnostics_fn(cfg, d, dev), dev)
    else:
        x0 = bt.place_cells(x0, mesh, x_axis="cx", y_axis="cy")
        sharded = transport.make_sharded_step_2d(cfg, collide_fn, mesh, x_axis="cx",
                                                 y_axis="cy", jit=True, **kw)

        def body(f, p):
            return sharded(f, p), None
    batch_shape = (x0.shape[0] * x0.shape[1],) + tuple(x0.shape[2:])
    return solvers.Unit(body, pre, collide_fn, x0, batch_shape, evals_per_step(problem),
                        precomp_s, problem.traffic.get("restart_every"))


def reference_step(problem, x: torch.Tensor, tab: spectral.Tables) -> torch.Tensor:
    return stepping.strang_step_2d(x, tab, d=cell_side(problem), dt=dt(problem),
                                   knudsen=problem.config["knudsen"])


def reference_record(problem, y: torch.Tensor, tab: spectral.Tables):
    if problem.traffic.get("mesh"):
        return None
    mon = stepping.taylor_green_monitor(y, tab, cell_side(problem))
    return {"mass": mon[0], "kinetic_energy": mon[1], "entropy": mon[2]}


def program_record(problem, rec) -> dict:
    return {"mass": rec[0], "kinetic_energy": rec[1], "entropy": rec[2]}
