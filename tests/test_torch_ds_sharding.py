"""The port's radial-sharded ds operator (``make_sharded_ds_collision_operator``,
``place_ds``, ``_pad_radial``) on gloo ranks against the JAX package's on its
8 virtual CPU devices: the partial gain spectra all_gathered and folded in
ds arithmetic in rank order.  Tolerances in units of max|Q|.
"""

import jax
import numpy as np
import pytest

import boltzfft as bz
from boltzfft import ds as jds
from boltzfft.ds_operator import _pad_radial
from boltzfft_torch import ds
from boltzfft_torch.ds_operator import collide_ds, make_ds_collision_operator
from torch_rank_worker import _ds_cfg, launch

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 (virtual) devices")

WORLDS = {
    2: ["ds_radial", "ds_half", "ds_half:1"],
    4: ["ds_radial"],
    8: ["ds_mesh2x4"],
}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks")
    done = {}

    def get(world):
        if world not in done:
            done[world] = launch(world, WORLDS[world], tmp)
        return done[world]

    return get


def _jax_setup(nv=8, n_radial=6):
    cfg = bz.CollisionConfig(nv=nv, ns=6, n_radial=n_radial, impl="c2c", dtype="float32")
    f64 = np.asarray(bz.bkw_f(cfg.velocity_grid.r_squared(), 6.5), np.float64)
    return cfg, jds.from_f64(f64)


def _close(got, want, tol):
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, f"{err:.3e} max|Q| > {tol}"


def _leaves(tree):
    return [np.asarray(a).astype(np.float32) for a in jax.tree.leaves(tree)]


@pytest.mark.parametrize("n", [2, 4])
def test_radial_sharded_matches_jax(ranks, n):
    # n_radial = 6 over 4 shards also pads two zero-weight groups
    res = ranks(n)
    for r in res:
        np.testing.assert_array_equal(r["ds_radial"]["q"], res[0]["ds_radial"]["q"])
        assert r["ds_radial"]["repeat_bitwise"] and r["ds_radial"]["global_bitwise"]
    cfg, f = _jax_setup()
    mesh = bz.make_mesh([(bz.NODE_AXIS, n)])
    coll, pre = bz.make_sharded_ds_collision_operator(cfg, mesh, contract="vpu")
    q_jax = jds.to_f64(coll(f, bz.place_ds(pre, mesh)))
    _close(res[0]["ds_radial"]["q"], q_jax, 1e-13)


@pytest.mark.parametrize("n", [2, 4])
def test_padded_and_placed_tables_match_jax(ranks, n):
    res = ranks(n)
    cfg, _ = _jax_setup()
    pre = bz.ds_operator.build_ds_precomp(cfg)
    padded = _pad_radial(pre, -(-6 // n) * n)
    want = _leaves(padded)
    got = res[0]["ds_radial"]["leaves"]
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a, b, err_msg=f"leaf {i}")
    mesh = bz.make_mesh([(bz.NODE_AXIS, n)])
    placed = bz.place_ds(padded, mesh)
    for k, r in enumerate(res):
        shards = [np.asarray([s for s in a.addressable_shards
                              if s.device == mesh.devices.flat[k]][0].data).astype(np.float32)
                  for a in jax.tree.leaves(placed)]
        for i, (a, b) in enumerate(zip(r["ds_radial"]["placed_leaves"], shards)):
            np.testing.assert_array_equal(a, b, err_msg=f"rank {k} leaf {i}")


def test_ensemble_and_radial_mesh_matches_jax(ranks):
    res = ranks(8)
    cfg, f = _jax_setup()
    fe = jds.DS(np.broadcast_to(np.asarray(f.hi), (4,) + f.hi.shape).copy(),
                np.broadcast_to(np.asarray(f.lo), (4,) + f.lo.shape).copy())
    mesh = bz.make_mesh([(bz.ENSEMBLE_AXIS, 2), (bz.NODE_AXIS, 4)])
    coll, pre = bz.make_sharded_ds_collision_operator(cfg, mesh, ensemble_axis=bz.ENSEMBLE_AXIS,
                                                      contract="vpu")
    q_jax = jds.to_f64(coll(fe, bz.place_ds(pre, mesh)))
    for k, r in enumerate(res):
        e = k // 4
        _close(r["ds_mesh2x4"]["q"], q_jax[2 * e:2 * e + 2], 1e-13)


@pytest.mark.parametrize("key", ["ds_half", "ds_half:1"])
def test_half_stream_on_ozk(ranks, key):
    # the half g-streams (pmz_half and the Nyquist coefficients sharded with
    # the rest); ":1" also sets group_batch=2 and herm_downstream=True.  JAX's
    # own half-stream sharding tests hold the sharded ozk operator to the
    # unsharded vpu one (its interpret-mode kernels take ~110 s here), and so
    # does this test, and to the port's unsharded ozk operator
    q = ranks(2)[0][key]["q"]
    cfg, f = _jax_setup(nv=6, n_radial=4)
    coll, pre = bz.make_ds_collision_operator(cfg, contract="vpu")
    _close(q, jds.to_f64(coll(f, pre)), 1e-12)
    cfg_t, f_t = _ds_cfg(nv=6, n_radial=4)
    kw = dict(group_batch=2, herm_downstream=True) if key.endswith(":1") else {}
    _, pre_t = make_ds_collision_operator(cfg_t, device="cpu")
    q_t = ds.to_f64(collide_ds(cfg_t, pre_t, f_t, sub_batch=6, contract="ozk", g_stream="half",
                               **kw))
    _close(q, q_t, 1e-12)
