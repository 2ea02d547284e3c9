"""RK relaxation of the PyTorch port (``boltzfft_torch.timestepper``)
against ``boltzfft.make_relaxation``, ``maxwell_bkw --steps``, and the
known-answer probe ``health.selfcheck`` against ``boltzfft.health``."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import boltzfft as bz
from boltzfft import health as bz_health

import boltzfft_torch as bt
from boltzfft_torch import health
from boltzfft_torch.cli import maxwell_bkw


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("method", ["euler", "rk2", "rk4"])
@pytest.mark.parametrize("nv", [8, 16])
def test_relax_matches_boltzfft(nv, method):
    kw = dict(nv=nv, ns=6, n_radial=nv // 2, impl="rfft")
    cfg_j = bz.CollisionConfig(**kw)
    g = cfg_j.velocity_grid
    f0 = bt.bkw_f(g.r_squared(), 5.5)
    collide_j, pre_j = bz.make_collision_operator(cfg_j)
    v_j = jnp.asarray(g.v)
    run_j = bz.make_relaxation(collide_j, pre_j, dt=0.1, n_steps=3, method=method,
                               record=lambda x: bz.moments(x, v_j, g.dv))
    traj_j = run_j(jnp.asarray(f0))

    cfg = bt.CollisionConfig(**kw)
    collide, pre = bt.make_collision_operator(cfg, device="cpu")
    run = bt.make_relaxation(collide, pre, dt=0.1, n_steps=3, method=method,
                             record=lambda x: bt.moments(x, g.v, g.dv))
    traj = run(torch.as_tensor(f0))
    assert isinstance(traj, bt.Trajectory) and isinstance(traj.recorded, bt.Moments)
    assert _rel(traj.f.numpy(), traj_j.f) <= 1e-12
    mass = np.abs(np.asarray(traj_j.recorded.mass)).max()
    for name in bt.Moments._fields:
        got, want = getattr(traj.recorded, name), np.asarray(getattr(traj_j.recorded, name))
        assert tuple(got.shape) == want.shape  # (steps,) or (steps, 3)
        # the momentum of the centred BKW state is round-off: hold it to the mass
        scale = mass if name == "momentum" else np.abs(want).max()
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12 * scale, err_msg=name)


def test_steppers_and_relax_options():
    rhs = lambda f: -f  # noqa: E731
    f = torch.tensor([1.0, 2.0], dtype=torch.float64)
    assert torch.allclose(bt.euler_step(rhs, f, 0.1), 0.9 * f)
    assert torch.allclose(bt.rk2_step(rhs, f, 0.1), (1 - 0.1 + 0.005) * f)
    assert torch.allclose(bt.rk4_step(rhs, f, 0.1), float(np.exp(-0.1)) * f, rtol=1e-7)
    traj = bt.relax(rhs, f, 0.1, 4, method="rk4")
    assert traj.recorded is None
    traj = bt.relax(rhs, f, 0.1, 4, method="euler", record=lambda x: (x.sum(), x[0]))
    assert traj.recorded[0].shape == (4,) and traj.recorded[1].shape == (4,)
    with pytest.raises(ValueError, match="method must be one of"):
        bt.relax(rhs, f, 0.1, 1, method="rk3")


def test_maxwell_bkw_steps(capsys):
    argv = ["--Nv", "8", "--Ns", "6", "--n-radial", "4", "--impl", "fused", "--device", "cpu",
            "--steps", "3", "--dt", "0.1", "--t0", "5.5"]
    assert maxwell_bkw.main(argv) == 0
    out = capsys.readouterr().out
    assert "Relaxation: 3 RK4 steps of dt=0.1 (t 5.5 -> 5.8" in out
    assert "mass drift:" in out and "energy drift:" in out
    assert "Relaxation errors vs analytic BKW f(t_end):" in out
    linf = float(out.split("Linf error:")[1].split()[0])
    # the same relaxation through the library
    cfg = bt.CollisionConfig(nv=8, ns=6, n_radial=4, impl="c2c")
    g = cfg.velocity_grid
    collide, pre = bt.make_collision_operator(cfg, device="cpu")
    traj = bt.make_relaxation(collide, pre, dt=0.1, n_steps=3)(
        torch.as_tensor(bt.bkw_f(g.r_squared(), 5.5)))
    want = bt.error_norms(traj.f, bt.bkw_f(g.r_squared(), 5.5 + 0.3), g.dv)["Linf"]
    assert linf == pytest.approx(want, rel=1e-5)


def test_selfcheck_defaults_match_boltzfft():
    r = health.selfcheck(device="cpu")
    assert r["ok"] and r["finite"] and r["config"]["impl"] == "rfft" and r["backend"] == "cpu"
    r_j = bz_health.selfcheck(dtype="float64")
    assert r_j["ok"]
    assert r["rel_linf"] == pytest.approx(r_j["rel_linf"], rel=1e-10)


def test_selfcheck_detects_a_fault():
    r = health.selfcheck(device="cpu",
                         pre_transform=lambda p: dataclasses.replace(p, beta2=2.0 * p.beta2))
    assert not r["ok"] and r["rel_linf"] > 1.0


@pytest.mark.parametrize("impl,kw", [("dft", {}), ("rfft", dict(use_pallas=True)),
                                     ("fused", dict(fused_scheme="transpose"))])
def test_selfcheck_compare_impl(impl, kw):
    r = health.selfcheck(nv=8, ns=6, device="cpu", impl=impl, cfg_kwargs=kw,
                         compare_impl="c2c", rel_tol=1e-12)
    assert r["ok"] and r["rel_linf"] <= 1e-12
