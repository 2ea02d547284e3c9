"""The 32^3 BKW cell's configuration as an ensemble on the CPU (BASELINE
config 5's traffic: a batch of distributions, each its own t0 in [5.5, 7.5]),
cut to 8^3 velocities, 4 radial nodes and 4 members (K1's plain version):
the program's batched step is correct, and a step that leaves one member
unchanged is not."""

from portbench import cells, solvers
from portbench.tests import small


def _cell() -> dict:
    c = cells.load_cell("bkw32.rk4")
    c["config"].update(nv=8, n_radial=4, impl="fused")
    c["traffic"].update(batch=4, t0=[5.5, 7.5])
    return c


def one_member_unchanged(problem, mesh=None):
    """A step that returns one member of the batch as it was given."""
    unit = solvers.port_unit(problem, mesh)
    step = unit.step

    def stuck(x, pre):
        y, rec = step(x, pre)
        y = y.clone()
        y[1] = x[1]
        return y, rec

    unit.step = stuck
    return unit


def test_ensemble_program_is_correct():
    line = small.run("bkw32.rk4", seed=2**31 + 9, the_cell=_cell())
    assert line["correct"] is True and line["failed"] == 0
    assert all(c["value"] <= c["limit"] for c in line["checks"].values())


def test_one_member_left_unchanged_is_not_correct():
    line = small.run("bkw32.rk4", unit_factory=one_member_unchanged, the_cell=_cell())
    assert line["correct"] is False
    # the member's own change is missing: a large share of the largest change
    # of all (1 where that member's is the largest)
    assert 0.1 < line["checks"]["step_err"]["value"] <= 1.0 + 1e-12
