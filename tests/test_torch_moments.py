"""Moments, entropy and the conservative projection of the PyTorch port
against ``boltzfft.moments`` and ``boltzfft.conserve``, and the analogs of
``tests/test_conserve.py`` (vanishing moments, idempotence and linearity,
batch broadcast)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import boltzfft as bz

import boltzfft_torch as bt


def _q(nv=16, ns=6):
    cfg = bt.CollisionConfig(nv=nv, ns=ns)
    collide, pre = bt.make_collision_operator(cfg, "cpu")
    g = cfg.velocity_grid
    return cfg, g, collide(torch.as_tensor(bt.bkw_f(g.r_squared(), 6.5)), pre)


def _random_f(shape, seed=5):
    return np.random.default_rng(seed).random(shape) - 0.05  # a few f <= 0


@pytest.mark.parametrize("grid", [(8, 8, 8), (8, 10, 12)])
def test_moments_match_boltzfft(grid):
    g = bt.VelocityGrid(nv=grid[0], length=7.0, nvy=grid[1], nvz=grid[2])
    f = _random_f((3,) + grid)
    if g.is_isotropic:
        a = bz.moments(jnp.asarray(f), jnp.asarray(g.v), g.dv)
        b = bt.moments(torch.as_tensor(f), g.v, g.dv)
    else:
        v = (g.vx, g.vy, g.vz)
        a = bz.moments(jnp.asarray(f), tuple(jnp.asarray(c) for c in v),
                       cell_volume=g.cell_volume)
        b = bt.moments(torch.as_tensor(f), v, cell_volume=g.cell_volume)
    for name in bt.Moments._fields:
        # sums in another order: within 1e-13 of each moment's largest entry
        want = np.asarray(getattr(a, name))
        np.testing.assert_allclose(getattr(b, name).numpy(), want, rtol=0,
                                   atol=1e-13 * np.abs(want).max(), err_msg=name)
    assert b.momentum.shape == (3, 3)


def test_moments_need_a_weight():
    f = torch.ones(4, 4, 4)
    with pytest.raises(ValueError, match="dv or cell_volume"):
        bt.moments(f, np.arange(4.0))
    with pytest.raises(ValueError, match="cell_volume"):
        bt.moments(f, (np.arange(4.0),) * 3, 0.5)


def test_entropy_matches_boltzfft():
    f = _random_f((2, 8, 8, 8))
    a = np.asarray(bz.entropy(jnp.asarray(f), 0.3))
    b = bt.entropy(torch.as_tensor(f), 0.3).numpy()
    np.testing.assert_allclose(b, a, rtol=1e-13)
    # f <= 0 contributes 0
    assert float(bt.entropy(torch.zeros(4, 4, 4), cell_volume=1.0)) == 0.0


def test_conserve_precomp_and_project_match_boltzfft():
    kw = dict(nv=8, nvy=10, nvz=12, ns=6)
    cp_j = bz.build_conserve_precomp(bz.CollisionConfig(**kw), temperature=2.0)
    cp_t = bt.build_conserve_precomp(bt.CollisionConfig(**kw), temperature=2.0, device="cpu")
    for name in ("psi", "corr"):
        assert np.array_equal(getattr(cp_t, name).numpy(), np.asarray(getattr(cp_j, name)))
    q = _random_f((2, 8, 10, 12))
    a = np.asarray(bz.project(jnp.asarray(q), cp_j))
    b = bt.project(torch.as_tensor(q), cp_t).numpy()
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-14 * np.abs(a).max())


def test_conserved_moments_vanish_to_roundoff():
    cfg, g, q = _q()
    qp = bt.project(q, bt.build_conserve_precomp(cfg, device="cpu"))
    m0, m = bt.moments(q, g.v, g.dv), bt.moments(qp, g.v, g.dv)
    defect = abs(float(m0.energy))
    assert defect > 1e-2
    assert abs(float(m.mass)) < 1e-13 * defect
    assert float(m.momentum.abs().max()) < 1e-13 * defect
    assert abs(float(m.energy)) < 1e-12 * defect


def test_projection_is_idempotent_and_linear():
    cfg, _, q = _q()
    cp = bt.build_conserve_precomp(cfg, device="cpu")
    qp = bt.project(q, cp)
    np.testing.assert_allclose(bt.project(qp, cp).numpy(), qp.numpy(),
                               atol=1e-14 * float(q.abs().max()))
    np.testing.assert_allclose(bt.project(2.0 * q, cp).numpy(), 2.0 * qp.numpy(), rtol=1e-12)


def test_projection_batch_broadcast():
    cfg, _, q = _q()
    cp = bt.build_conserve_precomp(cfg, device="cpu")
    qb = bt.project(torch.stack([q, 3.0 * q]), cp)
    np.testing.assert_allclose(qb[0].numpy(), bt.project(q, cp).numpy(), rtol=1e-12)
    np.testing.assert_allclose(qb[1].numpy(), 3.0 * bt.project(q, cp).numpy(), rtol=1e-12)


def test_conservative_wrapper():
    cfg = bt.CollisionConfig(nv=8, ns=6, impl="fused")
    collide, pre = bt.make_collision_operator(cfg, "cpu")
    cp = bt.build_conserve_precomp(cfg, device="cpu")
    f = torch.as_tensor(bt.bkw_f(cfg.velocity_grid.r_squared(), 6.5))
    fs = torch.stack([f, 0.5 * f])
    assert torch.equal(bt.conservative(collide, cp)(fs, pre), bt.project(collide(fs, pre), cp))
