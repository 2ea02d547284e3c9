"""The autotuners and the tables' archives on a card: each graphed probe
gives its memory back, ``autotune_ds`` captures one graph per candidate
(whose results agree within the ds tolerance), and a loaded precomp replays
bitwise equal to the saved one's operator.

No test here imports jax, so the file runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_tune_cuda.py -m cuda

Without a card every test skips.
"""

import dataclasses

import numpy as np
import pytest
import torch

import boltzfft_torch as bt
from boltzfft_torch import _graph, ds, tune
from boltzfft_torch.ds_operator import build_ds_precomp, ds_collide_fn

MIB = 1 << 20


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    tune._MEMO.clear()
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(impl="rfft", use_pallas=True), dict(impl="c2c")])
def test_each_probe_gives_its_memory_back(cuda_device, kw):
    cfg = bt.CollisionConfig(nv=32, ns=12, **kw)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(cuda_device)
    for c in tune._chunk_candidates(cfg, cuda_device):
        t = tune._time_candidate(dataclasses.replace(cfg, node_chunk=c), 2, 1,
                                 device=cuda_device)
        assert 0 < t < 1.0
        torch.cuda.synchronize()
        assert torch.cuda.memory_allocated(cuda_device) - before <= 64 * MIB, c


@pytest.mark.cuda
def test_autotune_winner_keeps_the_bkw_digits(cuda_device, tmp_path):
    cfg = bt.CollisionConfig(nv=32, ns=12, impl="rfft", use_pallas=True)
    tuned = bt.autotune(cfg, k=2, trials=1, cache_file=str(tmp_path / "w.json"))
    collide, pre = bt.make_collision_operator(tuned)
    g = cfg.velocity_grid
    f = torch.as_tensor(bt.bkw_f(g.r_squared(), 6.5), device=cuda_device)
    e = bt.error_norms_device(collide(f, pre), bt.bkw_dfdt(g.r_squared(), 6.5), g.dv)
    assert abs(e["Linf"] - 4.2512e-05) <= 1e-4 * 4.2512e-05


@pytest.mark.cuda
def test_autotune_ds_one_graph_per_candidate(cuda_device, monkeypatch):
    # 48^3: above 32 per axis, so group_batch is 1 and sub_batch shapes the
    # eval (K10 at sub_batch 1 and 3)
    cfg = bt.CollisionConfig(nv=48, ns=6)
    captured = []
    capture = _graph.Replayed._capture

    def counting(self, *a, **kw):
        captured.append(id(self))
        return capture(self, *a, **kw)

    monkeypatch.setattr(_graph.Replayed, "_capture", counting)
    sb = bt.autotune_ds(cfg, candidates=[1, 3], k=1, trials=1)
    assert sb in (1, 3)
    assert len(captured) == len(set(captured)) == 2

    pre = build_ds_precomp(cfg, device=cuda_device)
    f = ds.from_f64(bt.bkw_f(cfg.velocity_grid.r_squared(), 6.5), device=cuda_device)
    qs = [ds.to_f64(ds_collide_fn(cfg, sub_batch=s, device=cuda_device)(f, pre)) for s in (1, 3)]
    assert np.abs(qs[0] - qs[1]).max() <= 1e-12 * np.abs(qs[0]).max()


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(impl="rfft", use_pallas=True), dict(impl="fused")])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_loaded_precomp_replays_bitwise(cuda_device, tmp_path, kw, dtype):
    cfg = bt.CollisionConfig(nv=32, ns=12, dtype=dtype, **kw)
    collide, pre = bt.make_collision_operator(cfg)
    f = torch.as_tensor(bt.bkw_f(cfg.velocity_grid.r_squared(), 6.5), dtype=cfg.real_dtype,
                        device=cuda_device)
    q = collide(f, pre)
    path = tmp_path / "pre.npz"
    bt.save_precomp(path, cfg, pre)
    cfg2, pre2 = bt.load_precomp(path)
    assert cfg2 == cfg and pre2.device == pre.device and pre2.derived == {}
    collide2, _ = bt.make_collision_operator(cfg2)
    assert torch.equal(collide2(f, pre2), q)
    assert torch.equal(collide2(f, pre2), q)  # the replay, after the capture
