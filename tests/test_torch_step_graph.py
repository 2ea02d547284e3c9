"""The port's whole-program units on the CPU, where ``jit`` changes
nothing: ``make_relaxation(jit=True)`` against ``jit=False`` (bitwise:
tensor RK4 with a moments record, and ds RK4) and the JAX package's
``make_relaxation`` (tensor RK4; the ds case is test_torch_ds's); the ds
scalars split once per loop against the old per-call split; ``moments``
with its cached coordinates against a fresh upload; the nesting rule of
``_graph.Replayed``; and the decomposed step built with ``jit=True`` on
gloo ranks against ``jit=False`` and JAX's sharded step.  The card's side
is ``tests/test_torch_step_graph_cuda.py``."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import boltzfft as bz
from boltzfft import transport as jtransport

import boltzfft_torch as bt
from boltzfft_torch import _graph, ds, timestepper
from boltzfft_torch.ds_operator import make_ds_collision_operator
from boltzfft_torch.moments import KEEP_COORDS, _coords
from torch_rank_worker import _cells_f, launch


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def test_tensor_rk4_relaxation_jit_matches_eager_and_jax():
    """8^3 Ns=6, 3 RK4 steps, a moments record (test_torch_relax's JAX
    program, so the compilation cache can serve it): jit=True is jit=False's
    bits on the CPU, and both are JAX's within test_torch_relax's 1e-12."""
    kw = dict(nv=8, ns=6, n_radial=4, impl="rfft")
    g = bt.CollisionConfig(**kw).velocity_grid
    f0 = bt.bkw_f(g.r_squared(), 5.5)
    collide, pre = bt.make_collision_operator(bt.CollisionConfig(**kw), device="cpu")
    record = lambda x: bt.moments(x, g.v, g.dv)  # noqa: E731
    trajs = [bt.make_relaxation(collide, pre, dt=0.1, n_steps=3, method="rk4", record=record,
                                jit=jit)(torch.as_tensor(f0)) for jit in (True, False)]
    assert torch.equal(trajs[0].f, trajs[1].f)
    for name in bt.Moments._fields:
        assert torch.equal(getattr(trajs[0].recorded, name), getattr(trajs[1].recorded, name))
    collide_j, pre_j = bz.make_collision_operator(bz.CollisionConfig(**kw))
    v_j = jnp.asarray(g.v)
    tj = bz.make_relaxation(collide_j, pre_j, dt=0.1, n_steps=3, method="rk4",
                            record=lambda x: bz.moments(x, v_j, g.dv))(jnp.asarray(f0))
    assert _rel(trajs[0].f.numpy(), tj.f) <= 1e-12
    mass = np.abs(np.asarray(tj.recorded.mass)).max()
    for name in bt.Moments._fields:
        got, want = getattr(trajs[0].recorded, name), np.asarray(getattr(tj.recorded, name))
        assert tuple(got.shape) == want.shape
        scale = mass if name == "momentum" else np.abs(want).max()
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12 * scale, err_msg=name)


def test_ds_rk4_relaxation_jit_matches_eager():
    """The ds state at 6^3 (the vpu engine), 2 RK4 steps: jit=True is
    jit=False's bits.  JAX's side: test_torch_ds's
    test_ds_rk4_relaxation_matches_jax holds make_relaxation's default,
    jit=True, to JAX's make_relaxation within 1e-13 at the same size."""
    cfg = bt.CollisionConfig(nv=6, ns=6, n_radial=3, impl="c2c", dtype="float32")
    f0 = np.asarray(bt.bkw_f(cfg.velocity_grid.r_squared(), 5.5), np.float64)
    ct, pt = make_ds_collision_operator(cfg, contract="vpu", device="cpu")
    runs = [bt.make_relaxation(ct, pt, dt=0.25, n_steps=2, method="rk4", jit=jit)(
        ds.from_f64(f0, device="cpu")).f for jit in (True, False)]
    assert torch.equal(runs[0].hi, runs[1].hi) and torch.equal(runs[0].lo, runs[1].lo)
    assert inspect.signature(bt.make_relaxation).parameters["jit"].default is True


@pytest.mark.parametrize("method", ["euler", "rk2", "rk4"])
def test_hoisted_ds_scalars_give_the_per_call_bits(method):
    """Steps with the scalars of ds_coefs (split once) against the old
    _axpy, which split ``a`` on every call (written out here), bitwise."""
    rng = np.random.default_rng(3)
    a0, a1 = rng.standard_normal((2, 4, 5))
    f = ds.from_f64(a0 + 1e-9 * a1, device="cpu")
    rhs = lambda x: ds.mul(x, ds.from_f64(-0.7, device="cpu"))  # noqa: E731

    def old_axpy(f, a, k):
        return ds.add(f, ds.mul(k, ds.from_f64(np.float64(a), k.hi.dtype, k.hi.device)))

    dt = 0.3
    step = timestepper._STEPPERS[method]
    got = step(rhs, f, dt, timestepper.ds_coefs(dt, torch.float32, "cpu"))
    real = timestepper._axpy
    timestepper._axpy = lambda f, a, k, coefs=None: old_axpy(f, a, k)
    try:
        want = step(rhs, f, dt)
    finally:
        timestepper._axpy = real
    assert torch.equal(got.hi, want.hi) and torch.equal(got.lo, want.lo)
    assert set(timestepper.ds_coefs(dt, torch.float32, "cpu")) == {dt, 0.5 * dt, dt / 3.0, dt / 6.0}


def test_moments_cached_coordinates_match_a_fresh_upload(monkeypatch):
    """moments uploads host coordinates once per (values, dtype, device):
    a second call makes no host copy, and both give a fresh upload's bits."""
    g = bt.CollisionConfig(nv=8, ns=6).velocity_grid
    rng = np.random.default_rng(5)
    f = torch.as_tensor(rng.random((3, 8, 8, 8)))
    first = bt.moments(f, g.v, g.dv)
    fresh = bt.moments(f, torch.as_tensor(g.v), g.dv)  # a tensor on f's device: no cache
    aniso = bt.moments(f.float(), (g.vx, g.vy, g.vz), cell_volume=g.cell_volume)
    monkeypatch.setattr(torch, "as_tensor", lambda *a, **k: pytest.fail("uploaded again"))
    again = bt.moments(f, g.v, g.dv)
    assert torch.equal(bt.moments(f.float(), (g.vx, g.vy, g.vz), cell_volume=g.cell_volume).energy,
                       aniso.energy)
    monkeypatch.undo()
    for name in bt.Moments._fields:
        assert torch.equal(getattr(first, name), getattr(fresh, name))
        assert torch.equal(getattr(again, name), getattr(fresh, name))
    want = bt.moments(f.float(), tuple(torch.as_tensor(c, dtype=torch.float32)
                                       for c in (g.vx, g.vy, g.vz)), cell_volume=g.cell_volume)
    for name in bt.Moments._fields:
        assert torch.equal(getattr(aniso, name), getattr(want, name))
    assert 0 < len(_coords) <= KEEP_COORDS


def test_an_inner_replayed_runs_eagerly_inside_an_outer_unit(monkeypatch):
    """While an outer unit warms up or captures (``_graph._depth`` > 0), a
    Replayed it calls runs its eager fn and keeps no graph of its own."""
    calls = []
    inner = _graph.Replayed(lambda x, pre: calls.append(pre) or 2.0 * x)
    monkeypatch.setattr(_graph, "_depth", 1)
    x = torch.arange(3.0)
    assert torch.equal(inner(x, "pre"), 2.0 * x)
    assert calls == ["pre"] and not inner._graphs


def test_make_relaxation_signature_and_step():
    """JAX's parameters plus a keyword-only jit; run.step is the unit."""
    params = inspect.signature(bt.make_relaxation).parameters
    assert list(params) == ["collide_fn", "pre", "dt", "n_steps", "method", "record", "jit"]
    assert params["jit"].kind is inspect.Parameter.KEYWORD_ONLY and params["jit"].default is True
    run = bt.make_relaxation(lambda f, p: -f, None, dt=0.1, n_steps=3, method="euler",
                             record=lambda f: f.sum(), jit=False)
    f1, rec = run.step(torch.ones(2, dtype=torch.float64), None)
    assert torch.equal(f1, torch.full((2,), 0.9, dtype=torch.float64)) and float(rec) == 1.8
    traj = run(torch.ones(2, dtype=torch.float64))
    assert traj.recorded.shape == (3,)
    with pytest.raises(ValueError, match="method must be one of"):
        bt.make_relaxation(lambda f, p: f, None, 0.1, 1, method="rk3")


@pytest.fixture(scope="module")
def step_ranks(tmp_path_factory):
    return launch(4, ["step_jit:2x2:4x4"], tmp_path_factory.mktemp("ranks"))


@pytest.mark.skipif(len(jax.devices()) < 4, reason="needs 4 (virtual) devices")
def test_sharded_step_jit_matches_eager_and_jax(step_ranks):
    """make_sharded_step_2d(jit=True) on 4 gloo ranks (2x2, 4x4 cells, 2
    steps) is jit=False's bits, and JAX's sharded step within 1e-12."""
    cells = (4, 4)
    got = {}
    for jit in (True, False):
        blocks = [(r["step_jit:2x2:4x4"][jit], r["step_jit:2x2:4x4"]["offsets"])
                  for r in step_ranks]
        out = np.zeros(cells + blocks[0][0].shape[2:])
        for block, off in blocks:
            out[off[0]:off[0] + 2, off[1]:off[1] + 2] = block
        got[jit] = out
    np.testing.assert_array_equal(got[True], got[False])
    cfg_j = bz.CollisionConfig(nv=8, ns=6, n_radial=2, impl="rfft")
    coll_j, pre_j = bz.make_collision_operator(cfg_j, jit=False)
    mesh = bz.make_mesh([("cx", 2), ("cy", 2)])
    step_j = jtransport.make_sharded_step_2d(cfg_j, coll_j, mesh, dx=0.3, dy=0.2, dt=0.01,
                                             knudsen=1.0, x_axis="cx", y_axis="cy")
    fj = bz.place_cells(jnp.asarray(_cells_f(cells)[1].numpy()), mesh, x_axis="cx", y_axis="cy")
    for _ in range(2):
        fj = step_j(fj, pre_j)
    assert _rel(got[True], np.asarray(fj)) <= 1e-12


def test_sharded_step_jit_raises_on_a_mesh_it_cannot_capture(step_ranks):
    """jit=True over gloo ranks whose mesh is on a card raises when built."""
    for r in step_ranks:
        msg = r["step_jit:2x2:4x4"]["card"]
        assert "make_sharded_step_2d(jit=True)" in msg and "pass jit=False" in msg
