"""The comparison fails the control and every fault the cells can have,
and passes the program (CPU, cut cells, K1's plain version)."""

import pytest

from portbench import cells, control, harness
from portbench.tests import faults, small

ONE_CARD = ["bkw64.rk4", "tg2d.16x16.step"]


@pytest.mark.parametrize("name", ONE_CARD)
def test_program_is_correct(name):
    line = small.run(name, seed=2**31 + 5)
    assert line["correct"] is True
    assert all(c["value"] <= c["limit"] for c in line["checks"].values())


@pytest.mark.parametrize("name", ONE_CARD + ["tg2d.32x32.mesh2x2"])
def test_control_in_float32_is_not_correct(name):
    line = control.run(name, 7, 0.5, "cpu", small.cell(name))
    assert line["correct"] is False
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


@pytest.mark.parametrize("fault", ["unchanged", "altered", "altered_record"])
@pytest.mark.parametrize("name", ONE_CARD)
def test_fault_is_not_correct(name, fault):
    line = small.run(name, unit_factory=getattr(faults, fault))
    assert line["correct"] is False
    if fault == "unchanged":
        assert line["checks"]["step_err"]["value"] == pytest.approx(1.0)


def test_half_batch_is_not_correct():
    line = small.run("tg2d.16x16.step", unit_factory=faults.half_batch)
    assert line["correct"] is False


def _mesh_line(capfd, entry):
    rc = cells.spawn(small.cell("tg2d.32x32.mesh2x2"), 31, 1.0, False, device="cpu",
                       entry=entry)
    out = capfd.readouterr().out.strip().splitlines()
    assert rc == 0
    import json

    return json.loads(out[-1])


def test_mesh_program_is_correct(capfd):
    line = _mesh_line(capfd, cells._rank_entry)
    assert line["correct"] is True and line["device"]["count"] == 4
    # the ranks agree on the window's close every AGREE_EVERY steps only
    assert line["attempted"] % harness.AGREE_EVERY == 0


def test_mesh_without_the_exchange_is_not_correct(capfd):
    line = _mesh_line(capfd, faults.no_exchange_entry)
    assert line["correct"] is False
