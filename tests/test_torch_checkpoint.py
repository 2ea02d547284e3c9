"""The port's ``RelaxCheckpointer`` (``torch.save`` step directories,
committed whole) in one process and on two gloo ranks, and the ensemble
driver's checkpointed run resumed bitwise equal to an uninterrupted one."""

import os

import numpy as np
import pytest
import torch

import boltzfft_torch as bt
from boltzfft_torch import ds
from torch_rank_worker import launch


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return launch(2, ["ckpt_blocks", "ckpt_cli"], tmp_path_factory.mktemp("ranks"))


def test_save_restore_and_retention(tmp_path):
    with bt.RelaxCheckpointer(tmp_path / "ck", max_to_keep=3) as ck:
        assert ck.latest_step() is None
        with pytest.raises(FileNotFoundError):
            ck.restore()
        f = torch.linspace(0.0, 1.0, 24, dtype=torch.float64).reshape(2, 3, 4)
        for step in range(1, 5):
            ck.save(step, f * step, 0.25 * step, extra={"k": torch.tensor([step])})
        ck.wait()
        assert ck.latest_step() == 4
        assert sorted(os.listdir(tmp_path / "ck")) == ["2", "3", "4"]
        g, t = ck.restore()
        assert torch.equal(g, 4 * f) and t == 1.0
        g, t, extra = ck.restore(3, template=f.to(torch.float32), extra_template={"k": None})
        assert g.dtype == torch.float32 and torch.equal(g, (3 * f).to(torch.float32))
        assert t == 0.75 and int(extra["k"]) == 3
        with pytest.raises(ValueError, match="shape"):
            ck.restore(template=f[0])


def test_a_step_is_committed_whole(tmp_path):
    ck = bt.RelaxCheckpointer(tmp_path)
    ck.save(1, torch.ones(3), 0.1)
    (tmp_path / "2.tmp").mkdir()  # a save cut before its commit
    assert ck.latest_step() == 1
    ck.save(2, torch.full((3,), 2.0), 0.2)
    assert sorted(os.listdir(tmp_path)) == ["1", "2"]
    assert torch.equal(ck.restore()[0], torch.full((3,), 2.0))


def test_ds_state_round_trip(tmp_path):
    x = ds.from_f64(np.linspace(1.0, 2.0, 10) / 3.0, device="cpu")
    ck = bt.RelaxCheckpointer(tmp_path)
    ck.save(7, x, 3.5)
    y, t = ck.restore(template=x)
    assert isinstance(y, ds.DS) and t == 3.5
    assert torch.equal(y.hi, x.hi) and torch.equal(y.lo, x.lo)


def test_each_rank_saves_its_block(ranks):
    for rank, r in enumerate(ranks):
        c = r["ckpt_blocks"]
        assert c["latest"] == 4 and c["kept"] == ["3", "4"]
        want = (np.arange(6.0).reshape(2, 3) + 10 * rank) * 3
        np.testing.assert_array_equal(c["f"], want.astype(np.float32))
        assert c["dtype"] == "torch.float32" and c["t"] == 1.5
        np.testing.assert_array_equal(c["extra"], [3, 0])  # t and extra: rank 0's
        assert c["ds_bitwise"]


def test_ensemble_driver_resumes_bitwise(ranks):
    for r in ranks:
        c = r["ckpt_cli"]
        assert c["bitwise"] and c["steps"] == (4, 4)
        assert c["t"][0] == pytest.approx(0.2) and c["t"][0] == c["t"][1]
    whole, first, resumed = ranks[0]["ckpt_cli"]["lines"]
    assert "step 4/4 t=0.2000" in whole
    assert "step 2/2" in first and "resumed from step 2 (t = 0.1000)" in resumed
    # the mass line of the last step is the same either way
    last = lambda text: [ln for ln in text.splitlines() if ln.startswith("step 4/4")][0]
    assert last(whole) == last(resumed)
    assert ranks[1]["ckpt_cli"]["lines"] == ["", "", ""]  # rank 0 prints
