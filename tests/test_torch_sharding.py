"""The port's node and ensemble sharding (``boltzfft_torch.sharding``) on gloo
ranks against the JAX package's sharded operator on its 8 virtual CPU
devices, the same mesh shape on both sides.

The ranks run from ``tests/torch_rank_worker.py``, each world size once per
module; tolerances are in units of max|Q|.
"""

import jax
import numpy as np
import pytest
import torch

import boltzfft as bz
import boltzfft_torch as bt
from torch_rank_worker import launch

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 (virtual) devices")

WORLDS = {
    1: (["mesh_single"], False),
    2: (["node:rfft"], True),
    4: (["node:rfft", "node:fused:8:6:ct", "node:fused:8:6:kron"], True),
    5: (["node:fused:8:12:ct", "node:fused:8:12:kron"], True),
    8: (["node:rfft", "node:rfft:16:6:auto:5", "ensemble:rfft", "ensemble:fused:8", "mesh2x4",
         "mesh_api"], True),
}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """world size -> each rank's results, launched at first use."""
    tmp = tmp_path_factory.mktemp("ranks")
    done = {}

    def get(world):
        if world not in done:
            cases, init = WORLDS[world]
            done[world] = launch(world, cases, tmp, init=init)
        return done[world]

    return get


def _jax_node(n, **kw):
    cfg = bz.CollisionConfig(**kw)
    mesh = bz.make_mesh([(bz.NODE_AXIS, n)])
    coll, pre = bz.make_sharded_collision_operator(cfg, mesh)
    f = bz.bkw_f(cfg.velocity_grid.r_squared(), 6.5)
    return np.asarray(coll(f, bz.place(pre, mesh))), pre, mesh


def _close(got, want, tol):
    scale = np.abs(want).max()
    err = np.abs(got - want).max() / scale
    assert err <= tol, f"{err:.3e} max|Q| > {tol}"


def _replicated(results, key):
    q = results[0][key]["q"]
    for r in results[1:]:
        np.testing.assert_array_equal(r[key]["q"], q)
    return q


@pytest.mark.parametrize("n", [2, 4, 8])
def test_node_sharded_rfft_matches_jax(ranks, n):
    res = ranks(n)
    q = _replicated(res, "node:rfft")
    assert all(r["node:rfft"]["global_same"] for r in res)
    q_jax, _, _ = _jax_node(n, nv=16, ns=6, impl="rfft")
    _close(q, q_jax, 1e-13)


@pytest.mark.parametrize("n,ns,scheme", [(4, 6, "ct"), (4, 6, "kron"), (5, 12, "ct"),
                                          (5, 12, "kron")])
def test_node_sharded_fused_matches_jax(ranks, n, ns, scheme):
    # ct: K2's plain version on each rank, then the all_reduce; kron: K3's.
    # 5 shards of Ns=12 is the group-alignment case (a shard of whole
    # radial groups).  JAX's CPU fused route is ct.
    key = f"node:fused:8:{ns}:{scheme}"
    res = ranks(n)
    q = _replicated(res, key)
    calls = res[0][key]["calls"]
    assert calls == {"k1": 0, "k2": int(scheme == "ct"), "k3": int(scheme == "kron")}
    assert res[0][key]["pre"]["rho"].shape[0] % (n * (ns // 2)) == 0
    q_jax, _, _ = _jax_node(n, nv=8, ns=ns, impl="fused")
    _close(q, q_jax, 1e-12)


def test_node_chunk_five_over_eight_matches_jax(ranks):
    key = "node:rfft:16:6:auto:5"
    q = _replicated(ranks(8), key)
    q_jax, pre, _ = _jax_node(8, nv=16, ns=6, impl="rfft", node_chunk=5)
    assert ranks(8)[0][key]["pre"]["rho"].shape[0] % 40 == 0
    _close(q, q_jax, 1e-13)


@pytest.mark.parametrize("n,key,kw", [
    (5, "node:fused:8:12:ct", dict(nv=8, ns=12, impl="fused")),
    (8, "node:rfft:16:6:auto:5", dict(nv=16, ns=6, impl="rfft", node_chunk=5)),
    (4, "node:rfft", dict(nv=16, ns=6, impl="rfft")),
])
def test_padded_and_placed_precomps_match_jax(ranks, n, key, kw):
    res = ranks(n)
    _, pre, mesh = _jax_node(n, **kw)
    for name, got in res[0][key]["pre"].items():
        np.testing.assert_array_equal(got, np.asarray(getattr(pre, name)), err_msg=name)
    placed = bz.place(pre, mesh)
    for k, r in enumerate(res):
        for name, got in r[key]["placed"].items():
            arr = getattr(placed, name)
            shard = [s for s in arr.addressable_shards if s.device == mesh.devices.flat[k]][0]
            np.testing.assert_array_equal(got, np.asarray(shard.data), err_msg=f"{name} rank {k}")


@pytest.mark.parametrize("impl", ["rfft", "fused"])
def test_ensemble_members_bitwise(ranks, impl):
    key = "ensemble:rfft" if impl == "rfft" else "ensemble:fused:8"
    res = ranks(8)
    assert [r[key]["index"] for r in res] == list(range(8))
    assert all(r[key]["bitwise"] and r[key]["shape"][0] == 1 for r in res)
    # the ensemble-only fused route runs the whole eval in K1 (plain here)
    want = {"k1": 1, "k2": 0, "k3": 0} if impl == "fused" else {"k1": 0, "k2": 0, "k3": 0}
    assert res[0][key]["calls"] == want
    if impl == "rfft":
        cfg = bz.CollisionConfig(nv=16, ns=6, impl="rfft")
        f = bz.bkw_f(cfg.velocity_grid.r_squared(), 6.5)
        ens = np.stack([f * s for s in (1.0, 0.5, 0.25, 2.0)] * 2)
        mesh = bz.make_mesh([(bz.ENSEMBLE_AXIS, 8)])
        coll, pre = bz.make_sharded_collision_operator(cfg, mesh, node_axis=None,
                                                       ensemble_axis=bz.ENSEMBLE_AXIS)
        q_jax = np.asarray(coll(ens, pre))
        _close(np.concatenate([r[key]["q"] for r in res]), q_jax, 1e-13)


def test_mesh_2x4_matches_jax(ranks):
    res = ranks(8)
    cfg = bz.CollisionConfig(nv=16, ns=6, impl="rfft")
    f = bz.bkw_f(cfg.velocity_grid.r_squared(), 6.5)
    mesh = bz.make_mesh([(bz.ENSEMBLE_AXIS, 2), (bz.NODE_AXIS, 4)])
    coll, pre = bz.make_sharded_collision_operator(cfg, mesh, node_axis=bz.NODE_AXIS,
                                                   ensemble_axis=bz.ENSEMBLE_AXIS)
    q_jax = np.asarray(coll(np.stack([f, 0.5 * f]), bz.place(pre, mesh)))
    for r in res:
        e = r["mesh2x4"]["index"]
        _close(r["mesh2x4"]["q"][0], q_jax[e], 1e-13)


def test_make_mesh(ranks):
    m = ranks(8)[0]["mesh_api"]
    assert m["default"] == ((bz.NODE_AXIS,), (8,), "cpu")
    assert bz.make_mesh().axis_names == m["default"][0]
    assert m["named"] == (("cx", "cy"), (2, 4), 0, 0)
    assert [r["mesh_api"]["named"][2:] for r in ranks(8)] == [(i // 4, i % 4) for i in range(8)]
    assert "needs 16 devices, have 8" in m["too_many"]
    with pytest.raises(ValueError, match="needs 1024 devices"):
        bz.make_mesh([(bz.NODE_AXIS, 1024)])
    assert "no axis 'cz'" in m["bad_axis"]
    assert m["no_axes"] == "need at least one of node_axis/ensemble_axis"


def test_make_mesh_starts_a_single_rank_group(ranks):
    m = ranks(1)[0]["mesh_single"]
    assert m["group"] == (1, "gloo")
    assert m["mesh"] == ((bz.NODE_AXIS,), (1,), "cpu")
    assert m["bitwise"]
    assert "needs 2 devices, have 1" in m["too_many"]


@pytest.mark.parametrize("kw,target", [
    (dict(nv=8, ns=12, impl="fused"), 240),
    (dict(nv=16, ns=6, impl="rfft", node_chunk=5), 120),
    (dict(nv=8, ns=6, impl="c2c", dtype="float32"), 30),
])
def test_repad_nodes_matches_jax(kw, target):
    pre_j = bz.weights.repad_nodes(bz.build_precomp(bz.CollisionConfig(**kw)), target)
    pre_t = bt.build_precomp(bt.CollisionConfig(**kw), "cpu")
    got = bt.repad_nodes(pre_t, target)
    for name in ("rho", "sigma", "gain_w", "lx", "norm_l", "beta2"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(pre_j, name)),
                                      err_msg=name)
    assert got.rho.dtype == pre_t.rho.dtype
    assert bt.repad_nodes(got, target) is got
    with pytest.raises(ValueError, match="current node count"):
        bt.repad_nodes(pre_t, pre_t.rho.shape[0] - 1)


def test_sharded_factories_raise_without_an_axis():
    with pytest.raises(ValueError, match="node_axis/ensemble_axis"):
        bt.make_sharded_collision_operator(bt.CollisionConfig(nv=8, ns=6), mesh=None,
                                           node_axis=None)
    with pytest.raises(ValueError, match="radial_axis/ensemble_axis"):
        bt.make_sharded_ds_collision_operator(bt.CollisionConfig(nv=8, ns=6), mesh=None,
                                              radial_axis=None)
    assert torch.distributed.is_initialized() is False
