"""The sharded operators on a card: a 1-rank NCCL mesh (``make_mesh()``
with no process group) gives the unsharded operators' bits on every route,
K2 takes a shard whose last node chunk is ragged, and two gloo ranks share
the card (NCCL takes one rank a card) within 1e-12 max|Q| of the unsharded
evals; on a host of several cards, NCCL ranks (one a card) capture their
collectives in the operators' CUDA graphs.

No test here imports jax, so the file runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_sharding_cuda.py -m cuda

Without a card every test skips.
"""

import numpy as np
import pytest
import torch

import boltzfft_torch as bt
from boltzfft_torch import ds, sharding
from boltzfft_torch.kernels import alpha_multiply as k6
from boltzfft_torch.kernels import fused_collide as k1
from boltzfft_torch.kernels import fused_gain_dft as k24
from boltzfft_torch.kernels import gain_reduce as k5
from torch_rank_worker import launch


@pytest.fixture(scope="module")
def mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    yield bt.make_mesh(device="cuda")  # no process group yet: one of this process alone
    torch.distributed.destroy_process_group()


def _f(cfg):
    return torch.as_tensor(bt.bkw_f(cfg.velocity_grid.r_squared(), 6.5), dtype=cfg.real_dtype,
                           device="cuda")


ROUTES = {  # name -> (CollisionConfig kwargs, the launch counters that must move)
    "fused (K1)": (dict(impl="fused", fused_scheme="ct"), lambda: (k1.LAUNCHES,)),
    "rfft + use_pallas (K6, K5)": (dict(impl="rfft", use_pallas=True),
                                   lambda: (k6.LAUNCHES, k5.LAUNCHES)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("n", [16, 32])
@pytest.mark.parametrize("route", list(ROUTES))
def test_one_rank_mesh_is_the_unsharded_operator(mesh, route, n, dtype):
    kw, launches = ROUTES[route]
    cfg = bt.CollisionConfig(nv=n, ns=12, dtype=dtype, **kw)
    assert torch.distributed.get_backend() == "nccl"
    ref, ref_pre = bt.make_collision_operator(cfg)
    coll, pre = bt.make_sharded_collision_operator(cfg, mesh)
    f = _f(cfg)
    before = launches()
    q = coll(f, bt.place(pre, mesh))
    assert all(b > a for a, b in zip(before, launches()))
    assert torch.equal(q, ref(f, ref_pre))
    for fe in (torch.stack([f, 0.5 * f]),):  # the ensemble axis of one rank
        ens, ens_pre = bt.make_sharded_collision_operator(
            cfg, bt.make_mesh([(bt.ENSEMBLE_AXIS, 1)], device="cuda"), node_axis=None,
            ensemble_axis=bt.ENSEMBLE_AXIS)
        assert torch.equal(ens(fe, ens_pre), ref(fe, ref_pre))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [16, 32])
def test_one_rank_mesh_is_the_unsharded_ds_operator(mesh, n):
    cfg = bt.CollisionConfig(nv=n, ns=12, impl="c2c", dtype="float32")
    ref, ref_pre = bt.make_ds_collision_operator(cfg)
    coll, pre = bt.make_sharded_ds_collision_operator(cfg, mesh)
    f = ds.from_f64(bt.bkw_f(cfg.velocity_grid.r_squared(), 6.5), torch.float32, "cuda")
    a, b = coll(f, bt.place_ds(pre, mesh)), ref(f, ref_pre)
    assert torch.equal(a.hi, b.hi) and torch.equal(a.lo, b.lo)


@pytest.mark.cuda
def test_k2_takes_a_shard_with_a_ragged_last_chunk(mesh):
    # 16^3, Ns=12 over 5 shards: 96 nodes -> 24 a shard (4 radial groups of
    # 6), a multiple of ns_eff; a chunk of 3 groups leaves a last chunk of 1
    cfg = bt.CollisionConfig(nv=16, ns=12, impl="fused", fused_scheme="ct")
    pre = sharding._node_sharded_precomp(cfg, 5, torch.device("cuda"))
    shard = sharding._rows(pre, 5, 3)  # nodes 72-95 of 120 (96-119 are padding)
    assert shard.rho.shape[0] == 24 and bool((shard.gain_w > 0).all())
    from boltzfft_torch import operator as op

    f_hat = torch.fft.fftn(_f(cfg).to(cfg.complex_dtype))
    ax, ay, az = op._alpha_factors(cfg, shard, shard.rho, shard.sigma)
    args = (shard.rho, shard.gain_w, ax, ay, az, f_hat, shard.dft_inv_axes(),
            shard.dft_fwd_axes(), shard.norm_l)
    kw = dict(length=cfg.domain_length, b_gamma=cfg.b_gamma, radial_group=cfg.ns_eff,
              scheme="ct")
    ragged = k24.fused_gain_dft(*args, chunk=18, **kw)
    whole = k24.fused_gain_dft(*args, chunk=24, **kw)
    plain = k24.fused_gain_dft_reference(*args, **{k: v for k, v in kw.items() if k != "scheme"})
    assert torch.equal(ragged, whole)
    assert float((ragged - plain).abs().max() / plain.abs().max()) <= 1e-12


@pytest.mark.cuda
def test_two_ranks_share_the_card(mesh, tmp_path):
    res = launch(2, ["card_node", "card_ds"], tmp_path)
    for r in res:
        node = r["card_node"]
        assert "pass jit=False" in node["jit"]
        assert node["k2"] == 1 and node["device"].startswith("cuda")
        assert node["err"] <= 1e-12
        assert r["card_ds"]["err"] <= 1e-12
    assert np.isfinite([r["card_node"]["err"] for r in res]).all()


@pytest.mark.cuda
def test_nccl_ranks_capture_their_collectives(mesh, tmp_path):
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more cards (NCCL takes one rank a card)")
    for r in launch(n, ["nccl_ops"], tmp_path, backend="nccl"):
        c = r["nccl_ops"]
        assert c["fused_same"] and c["ds_same"] and c["k2"] == 1
        assert c["fused_err"] <= 1e-12 and c["ds_err"] <= 1e-12
