"""``boltzfft_torch.trace`` (``torch.profiler`` around a block, a
Chrome-trace JSON written under ``log_dir``) on the CPU."""

import json
import os

import pytest
import torch

import boltzfft_torch as bt


def _events(path):
    with open(path) as fh:
        return json.load(fh)["traceEvents"]


def test_trace_writes_the_collide_ops(tmp_path):
    cfg = bt.CollisionConfig(nv=8, ns=6, n_radial=4, impl="rfft")
    collide, pre = bt.make_collision_operator(cfg, device="cpu")
    f = torch.as_tensor(bt.bkw_f(cfg.velocity_grid.r_squared(), 6.5))
    log_dir = tmp_path / "trace"
    with bt.trace(str(log_dir)) as tr:
        q = collide(f, pre)
    assert torch.isfinite(q).all()
    assert os.path.dirname(tr.path) == str(log_dir) and tr.path.endswith(".pt.trace.json")
    assert os.listdir(log_dir) == [os.path.basename(tr.path)]
    names = {e.get("name", "") for e in _events(tr.path)}
    assert any("fft_r2c" in n or "rfftn" in n for n in names), sorted(names)[:40]
    assert any("fft_c2r" in n or "irfftn" in n for n in names)


def test_exception_propagates_and_the_trace_is_written(tmp_path):
    tr = bt.trace(str(tmp_path))
    with pytest.raises(ZeroDivisionError):
        with tr:
            torch.ones(3).sum()
            1 / 0
    assert tr.path is not None and os.path.exists(tr.path)
    assert any("aten::sum" in e.get("name", "") for e in _events(tr.path))


def test_profiler_that_fails_to_start_raises(tmp_path, monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("profiler already running")

    monkeypatch.setattr(torch.profiler.profile, "__enter__", broken)
    ran = []
    with pytest.raises(RuntimeError, match="already running"):
        with bt.trace(str(tmp_path)):
            ran.append(1)
    assert ran == []
