"""Faults planted under the timed path, for the tests that see ``correct``
come out false.  Module level, so that spawned ranks can run them."""

import torch

from portbench import cells, solvers


def unchanged(problem, mesh=None):
    """A step that returns its state unchanged."""
    unit = solvers.port_unit(problem, mesh)
    step = unit.step

    def stuck(x, pre):
        _y, rec = step(x, pre)
        return x.clone(), rec

    unit.step = stuck
    return unit


def altered(problem, mesh=None):
    """One value of every step's state altered where it is produced."""
    unit = solvers.port_unit(problem, mesh)
    step = unit.step

    def bent(x, pre):
        y, rec = step(x, pre)
        y = y.clone()
        y.view(-1)[y.numel() // 3] += 1e-3 * y.abs().max()
        return y, rec

    unit.step = bent
    return unit


def altered_record(problem, mesh=None):
    """The recorded mass altered where it is produced."""
    unit = solvers.port_unit(problem, mesh)
    step = unit.step

    def bent(x, pre):
        y, rec = step(x, pre)
        if problem.solver == "relaxation":
            rec = rec._replace(mass=rec.mass * (1.0 + 1e-4))
        else:
            rec = rec * torch.tensor([1.0 + 1e-4, 1.0, 1.0], dtype=rec.dtype)
        return y, rec

    unit.step = bent
    return unit


def half_batch(problem, mesh=None):
    """The collision operator evaluates half of the cells; the other half
    take the mean of those."""
    import boltzfft_torch as bt

    make = bt.make_collision_operator

    def make_half(cfg, *a, **kw):
        collide_fn, pre = make(cfg, *a, **kw)

        def half(f, p):
            q = collide_fn(f[: f.shape[0] // 2], p)
            return torch.cat([q, q.mean(0, keepdim=True).expand_as(q)[: f.shape[0] - q.shape[0]]])

        return half, pre

    bt.make_collision_operator = make_half
    try:
        return solvers.port_unit(problem, mesh)
    finally:
        bt.make_collision_operator = make


def no_exchange_entry(*args):
    """A rank whose halo exchange is left out: each block takes its own
    edges as its halos, as a mesh dim of one rank does."""
    import boltzfft_torch.transport as tr

    def own_edges(f, axis, width, mesh, axis_name):
        lo = f.narrow(axis, 0, width)
        hi = f.narrow(axis, f.shape[axis] - width, width)
        return torch.cat([hi, f, lo], dim=axis)

    tr._halo_exchange = own_edges
    cells._rank_entry(*args)
