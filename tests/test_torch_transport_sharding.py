"""The port's decomposed transport steps (``transport.make_sharded_step_2d`` /
``_3d``, the ring halo exchange) on gloo ranks: against the JAX package's
sharded steps on its 8 virtual CPU devices (the same mesh shape), and bitwise
against the port's unsharded step, since every cell sees the same
arithmetic."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import boltzfft as bz
import boltzfft_torch as bt
from boltzfft import transport as jtransport
from boltzfft_torch import transport
from torch_rank_worker import _cells_f, launch

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 (virtual) devices")

STEPS = {  # case -> (mesh dims, cells, scheme)
    "step:2x2:4x4": ((2, 2), (4, 4), "muscl"),
    "step:4x1:8x2": ((4, 1), (8, 2), "muscl"),
    "step:4x1:8x2:upwind": ((4, 1), (8, 2), "upwind"),
    "step:2x2x2:4x4x4": ((2, 2, 2), (4, 4, 4), "muscl"),
}
WORLDS = {
    4: ["step:2x2:4x4", "step:4x1:8x2", "step:4x1:8x2:upwind", "halo_narrow", "cells:2x2"],
    8: ["step:2x2x2:4x4x4", "cells:2x2x2"],
}
KW = dict(dx=0.3, dy=0.2, dt=0.01, knudsen=1.0)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks")
    done = {}

    def get(world):
        if world not in done:
            done[world] = launch(world, WORLDS[world], tmp)
        return done[world]

    return get


def _stitch(results, key, cells):
    out = None
    for r in results:
        block = r[key]["block"]
        if out is None:
            out = np.zeros(cells + block.shape[len(cells):], block.dtype)
        idx = tuple(slice(o, o + b) for o, b in zip(r[key]["offsets"], block.shape))
        out[idx] = block
    return out


@pytest.mark.parametrize("key", list(STEPS))
def test_sharded_step_matches_jax_and_unsharded(ranks, key):
    dims, cells, scheme = STEPS[key]
    got = _stitch(ranks(int(np.prod(dims))), key, cells)
    cfg, f = _cells_f(cells)
    names = ("cx", "cy", "cz")[:len(dims)]
    axes = dict(zip(("x_axis", "y_axis", "z_axis"), names))
    three = len(dims) == 3
    # the port, unsharded: every cell's arithmetic is the sharded step's
    coll, pre = bt.make_collision_operator(cfg, jit=False, device="cpu")
    make = transport.make_inhomogeneous_step_3d if three else transport.make_inhomogeneous_step_2d
    step = make(cfg, coll, scheme=scheme, **KW, **(dict(dz=0.25) if three else {}))
    want = f
    for _ in range(2):
        want = step(want, pre)
    np.testing.assert_array_equal(got, want.numpy())
    # JAX's sharded step on the same mesh shape
    cfg_j = bz.CollisionConfig(nv=8, ns=6, n_radial=2, impl="rfft")
    coll_j, pre_j = bz.make_collision_operator(cfg_j, jit=False)
    mesh = bz.make_mesh(list(zip(names, dims)))
    make_j = jtransport.make_sharded_step_3d if three else jtransport.make_sharded_step_2d
    step_j = make_j(cfg_j, coll_j, mesh, scheme=scheme, **KW, **axes,
                    **(dict(dz=0.25) if three else {}))
    fj = bz.place_cells(jnp.asarray(f.numpy()), mesh, **axes)
    for _ in range(2):
        fj = step_j(fj, pre_j)
    fj = np.asarray(fj)
    assert np.abs(got - fj).max() <= 1e-12 * np.abs(fj).max()


def test_block_narrower_than_the_halo_raises(ranks):
    for r in ranks(4):
        msg = r["halo_narrow"]["muscl"]
        assert "smaller than the 'muscl' stencil's halo width 2" in msg
        assert r["halo_narrow"]["upwind_shape"] == (1, 2, 8, 8, 8)


@pytest.mark.parametrize("dims", ["2x2", "2x2x2"])
def test_place_cells_matches_jax_shards(ranks, dims):
    d = tuple(int(s) for s in dims.split("x"))
    names = ("cx", "cy", "cz")[:len(d)]
    shape = (4, 6, 2)[:len(d)] + (2, 2, 2)
    f = np.arange(int(np.prod(shape)), dtype=np.float64).reshape(shape)
    mesh = bz.make_mesh(list(zip(names, d)))
    placed = bz.place_cells(jnp.asarray(f), mesh, **dict(zip(("x_axis", "y_axis", "z_axis"), names)))
    for k, r in enumerate(ranks(int(np.prod(d)))):
        shard = [s for s in placed.addressable_shards if s.device == mesh.devices.flat[k]][0]
        np.testing.assert_array_equal(r[f"cells:{dims}"]["block"], np.asarray(shard.data))


def test_place_cells_rejects_bad_shapes():
    import torch

    with pytest.raises(ValueError, match="Cx"):
        bt.place_cells(torch.zeros((2, 2)), None)
