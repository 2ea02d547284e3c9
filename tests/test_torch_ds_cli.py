"""The ds engine's entry points in the port: ``maxwell_bkw --impl ds`` (one
eval and ``--steps``) against the JAX package's CLI, and the known-answer
probe ``health.selfcheck_ds`` on the CPU (oz route through the kernels'
plain versions against the vpu engine).

The JAX CLI reduces its error norms in float32 (``|d.hi + d.lo|`` summed
in float32); the port forms them from the ds pairs in float64.  Their
printed six digits agree; the values are held to 1e-5 relative, float32's
reduction error over these grids, while the collision results under them
agree at 1e-12 (``tests/test_torch_ds_operator.py``).  The JAX CLI's
``--steps`` case compiles its relaxation for ~22 s on the CPU and is in the
``slow`` tier; the tier-1 case holds the port's ``--steps`` lines to the
port's relaxation, which ``tests/test_torch_ds.py`` holds to JAX's.
"""

import re

import numpy as np
import pytest
import torch

from boltzfft.cli import maxwell_bkw as j_maxwell_bkw

import boltzfft_torch as bt
from boltzfft_torch import ds, health
from boltzfft_torch.cli import maxwell_bkw


def _norms(out):
    return [float(re.search(rf"^{k} error: (\S+)$", out, re.M).group(1))
            for k in ("L1", "L2", "Linf")]


@pytest.mark.parametrize("extra", [[], pytest.param(["--steps", "1"], marks=pytest.mark.slow)])
def test_maxwell_bkw_ds_matches_jax(capsys, monkeypatch, extra):
    monkeypatch.setenv("BOLTZFFT_NO_CACHE", "1")
    small = ["--impl", "ds", "--Nv", "8", "--Ns", "6", "--n-radial", "4", "--trials", "1"]
    assert j_maxwell_bkw.main(small + extra) == 0
    want = capsys.readouterr().out
    assert maxwell_bkw.main(small + extra + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    heading = "Relaxation errors vs analytic BKW f(t_end):" if extra else "Approximation errors:"
    assert heading in got and heading in want
    np.testing.assert_allclose(_norms(got), _norms(want), rtol=1e-5, atol=0)


def test_maxwell_bkw_ds_steps_lines(capsys):
    """``--steps``: the printed norms are those of the library relaxation."""
    argv = ["--impl", "ds", "--Nv", "8", "--Ns", "6", "--n-radial", "4", "--steps", "2",
            "--device", "cpu"]
    assert maxwell_bkw.main(argv) == 0
    got = _norms(capsys.readouterr().out)
    cfg = bt.CollisionConfig(nv=8, ns=6, n_radial=4, impl="c2c", dtype="float32")
    collide, pre = bt.make_ds_collision_operator(cfg, device="cpu")
    rsq = cfg.velocity_grid.r_squared()
    traj = bt.make_relaxation(collide, pre, dt=0.125, n_steps=2)(ds.from_f64(bt.bkw_f(rsq, 5.5), device="cpu"))
    d = ds.to_f64(traj.f) - bt.bkw_f(rsq, 5.75)
    dv3 = cfg.velocity_grid.cell_volume
    want = [dv3 * np.abs(d).sum(), np.sqrt(dv3 * (d * d).sum()), np.abs(d).max()]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    assert isinstance(traj.f, ds.DS) and traj.f.hi.dtype == torch.float32


def test_maxwell_bkw_ds_oz_route(capsys):
    """The oz route's flags on the CPU (plain versions of K7-K12: the half
    route with K9 or K10, the full streams) print the vpu route's digits."""
    small = ["--impl", "ds", "--Nv", "8", "--Ns", "6", "--n-radial", "4", "--trials", "0",
             "--device", "cpu"]
    assert maxwell_bkw.main(small) == 0
    vpu = _norms(capsys.readouterr().out)
    argv = small + ["--ds-contract", "ozk", "--g-stream", "half", "--gmain-fused", "3",
                    "--group-batch", "2", "--oz-merge", "on"]
    assert maxwell_bkw.main(argv) == 0
    np.testing.assert_allclose(_norms(capsys.readouterr().out), vpu, rtol=1e-9, atol=0)
    for extra in (["--g-stream", "full"], ["--g-stream", "half", "--gmain-fused", "12"]):
        assert maxwell_bkw.main(small + ["--ds-contract", "oz", *extra]) == 0
        np.testing.assert_allclose(_norms(capsys.readouterr().out), vpu, rtol=1e-9, atol=0)


@pytest.mark.parametrize("kw", [{}, {"symmetrize": True, "g1_reversal": True, "g_stream": "half"},
                                {"gmain_fused": "3", "group_batch": 2, "g_stream": "half"}])
def test_selfcheck_ds_on_cpu(kw):
    r = health.selfcheck_ds(nv=8, ns=6, n_radial=4, device="cpu", **kw)
    assert r["ok"] and r["finite"] and r["backend"] == "cpu", r
    assert r["rel_linf"] < 1e-12
