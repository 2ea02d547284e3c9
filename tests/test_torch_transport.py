"""The spatially inhomogeneous solver of the PyTorch port
(``boltzfft_torch.transport``) against ``boltzfft.transport``: the advection
stencils and the 1D/2D/3D Strang steps on the staged c2c operator, the Sod
initial data, and the analogs of ``tests/test_transport.py`` (fixed point,
conservation, exact shift, uniform cells = homogeneous RK2).  The steps on
the kron route (K3) are held against boltzfft in
``tests/test_torch_transport_kron.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import boltzfft as bz
from boltzfft import transport as bz_tr

import boltzfft_torch as bt
from boltzfft_torch import transport as bt_tr

CELLS = {1: (4,), 2: (2, 2), 3: (2, 2, 2)}
STEPS = {
    1: (bz_tr.make_inhomogeneous_step, bt_tr.make_inhomogeneous_step, dict(dx=0.25)),
    2: (bz_tr.make_inhomogeneous_step_2d, bt_tr.make_inhomogeneous_step_2d,
        dict(dx=0.5, dy=0.4)),
    3: (bz_tr.make_inhomogeneous_step_3d, bt_tr.make_inhomogeneous_step_3d,
        dict(dx=0.5, dy=0.4, dz=0.3)),
}


def small_kw(**kw):
    return dict(dict(nv=8, ns=6, n_radial=4, impl="rfft"), **kw)


def cell_data(cfg, shape, seed=0):
    """BKW cells scaled and shifted per cell, made with numpy from a seed."""
    f1 = bt.bkw_f(cfg.velocity_grid.r_squared(), 6.5)
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    scale = 1.0 + 0.3 * rng.random(n)
    f = np.stack([s * np.roll(f1, i % 3, axis=0) for i, s in enumerate(scale)])
    return f.reshape(shape + f1.shape)


@pytest.mark.parametrize("name", ["advect_upwind", "advect_muscl"])
def test_advection_matches_boltzfft(name):
    cfg = bt.CollisionConfig(**small_kw())
    v = cfg.velocity_grid.v
    f = np.random.default_rng(3).random((8, 8, 8, 8))
    a = np.asarray(getattr(bz_tr, name)(jnp.asarray(f), jnp.asarray(v), 0.05, 0.004))
    b = getattr(bt_tr, name)(torch.as_tensor(f), v, 0.05, 0.004).numpy()
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-12 * np.abs(a).max())


@pytest.mark.parametrize("scheme", ["muscl", "upwind"])
@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_step_matches_boltzfft_c2c(ndim, scheme):
    kw = small_kw(impl="c2c")
    cfg_j, cfg_t = bz.CollisionConfig(**kw), bt.CollisionConfig(**kw)
    mk_j, mk_t, deltas = STEPS[ndim]
    f = cell_data(cfg_t, CELLS[ndim])
    collide_j, pre_j = bz.make_collision_operator(cfg_j, jit=False)
    step_j = jax.jit(mk_j(cfg_j, collide_j, dt=0.02, knudsen=0.5, scheme=scheme, **deltas))
    a = np.asarray(step_j(jnp.asarray(f), pre_j))
    collide_t, pre_t = bt.make_collision_operator(cfg_t, "cpu")
    step_t = mk_t(cfg_t, collide_t, dt=0.02, knudsen=0.5, scheme=scheme, **deltas)
    b = step_t(torch.as_tensor(f), pre_t).numpy()
    assert b.shape == f.shape
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-12 * np.abs(a).max())


def test_bad_scheme_raises():
    cfg = bt.CollisionConfig(**small_kw())
    with pytest.raises(ValueError, match="scheme must be one of"):
        bt_tr.make_inhomogeneous_step(cfg, None, dx=0.1, dt=0.01, scheme="weno")


def test_sod_initial_condition_and_density_match_boltzfft():
    kw = small_kw()
    cfg_j, cfg_t = bz.CollisionConfig(**kw), bt.CollisionConfig(**kw)
    a = np.asarray(bz_tr.sod_initial_condition(cfg_j, 6))
    b = bt_tr.sod_initial_condition(cfg_t, 6, device="cpu")
    assert b.dtype == torch.float64 and np.array_equal(a, b.numpy())
    dv = cfg_t.velocity_grid.dv
    np.testing.assert_allclose(bt_tr.density_profile(b, dv).numpy(),
                               np.asarray(bz_tr.density_profile(jnp.asarray(a), dv)),
                               rtol=1e-15)


# --------------------------------------------------------------------------
# the analogs of tests/test_transport.py
# --------------------------------------------------------------------------


def test_constant_in_x_is_fixed_point():
    cfg = bt.CollisionConfig(**small_kw())
    g = cfg.velocity_grid
    f_one = torch.as_tensor(bt.bkw_f(g.r_squared(), 6.5))
    f = f_one.expand(8, *f_one.shape)
    for advect in (bt_tr.advect_upwind, bt_tr.advect_muscl):
        out = advect(f, g.v, dx=0.1, dt=0.01)
        np.testing.assert_allclose(out.numpy(), f.numpy(), rtol=0, atol=1e-15)


def test_mass_conserved_per_velocity_point():
    cfg = bt.CollisionConfig(**small_kw())
    f = torch.as_tensor(np.random.default_rng(0).random((8, cfg.nv, cfg.nv, cfg.nv)))
    for advect in (bt_tr.advect_upwind, bt_tr.advect_muscl):
        out = advect(f, cfg.velocity_grid.v, dx=0.05, dt=0.004)
        np.testing.assert_allclose(out.sum(0).numpy(), f.sum(0).numpy(), rtol=1e-13)


def test_exact_shift_at_unit_cfl():
    dx = 0.25
    f = torch.as_tensor(np.random.default_rng(1).random((8, 1, 1, 1)))
    out = bt_tr.advect_upwind(f, np.array([2.0]), dx=dx, dt=dx / 2.0)
    np.testing.assert_allclose(out.numpy(), torch.roll(f, 1, 0).numpy(), rtol=1e-14)


def test_cfl_dt():
    assert bt_tr.cfl_dt(4.0, 0.1, safety=0.8) == pytest.approx(0.02)
    assert bt_tr.cfl_dt(4.0, 0.1) == bz_tr.cfl_dt(4.0, 0.1)


@pytest.mark.parametrize("impl", ["rfft", "fused"])
def test_uniform_cells_match_homogeneous_rk2(impl):
    cfg = bt.CollisionConfig(**small_kw(impl=impl))
    collide_fn, pre = bt.make_collision_operator(cfg, "cpu")
    f_one = torch.as_tensor(bt.bkw_f(cfg.velocity_grid.r_squared(), 6.5))
    nx, dt, kn = 4, 0.05, 0.7
    f = f_one.expand(nx, *f_one.shape).contiguous()
    out = bt_tr.make_inhomogeneous_step(cfg, collide_fn, dx=0.1, dt=dt, knudsen=kn)(f, pre)
    k1 = collide_fn(f_one, pre)
    k2 = collide_fn(f_one + (0.5 * dt / kn) * k1, pre)
    expected = (f_one + (dt / kn) * k2).numpy()
    for i in range(nx):
        np.testing.assert_allclose(out[i].numpy(), expected, atol=1e-13 * np.abs(expected).max())


def test_collisionless_step_conserves_exactly():
    cfg = bt.CollisionConfig(**small_kw())
    g = cfg.velocity_grid
    collide_fn, pre = bt.make_collision_operator(cfg, "cpu")
    nx = 8
    f = bt_tr.sod_initial_condition(cfg, nx, device="cpu")
    dx = 1.0 / nx
    dt = bt_tr.cfl_dt(float(np.abs(g.v).max()), dx)
    step = bt_tr.make_inhomogeneous_step(cfg, collide_fn, dx=dx, dt=dt, knudsen=1e30)
    m0 = bt.moments(f.sum(0), g.v, g.dv)
    for _ in range(3):
        f = step(f, pre)
    m1 = bt.moments(f.sum(0), g.v, g.dv)
    assert float(m1.mass) == pytest.approx(float(m0.mass), rel=1e-12)
    np.testing.assert_allclose(m1.momentum.numpy(), m0.momentum.numpy(),
                               atol=1e-12 * float(m0.mass))
    assert float(m1.energy) == pytest.approx(float(m0.energy), rel=1e-10)


@pytest.mark.parametrize("ndim", [2, 3])
def test_collisionless_nd_step_conserves_exactly(ndim):
    cfg = bt.CollisionConfig(**small_kw())
    g = cfg.velocity_grid
    mk = STEPS[ndim][1]
    f = torch.as_tensor(cell_data(cfg, (4,) * ndim))
    d = 0.25
    deltas = {k: d for k in ("dx", "dy", "dz")[:ndim]}
    step = mk(cfg, lambda x, pre: torch.zeros_like(x), dt=bt_tr.cfl_dt(float(np.abs(g.v).max()), d),
              knudsen=1.0, **deltas)
    total0 = f.sum(dim=tuple(range(ndim)))
    for _ in range(2):
        f = step(f, None)
    np.testing.assert_allclose(f.sum(dim=tuple(range(ndim))).numpy(), total0.numpy(), rtol=1e-12)
