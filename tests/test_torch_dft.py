"""``impl="dft"`` of the PyTorch port (every transform as per-axis einsums
against DFT matrices, no kernel) against boltzfft's dft pipeline on the CPU,
with both ``fused_precision`` values, and against the port's staged c2c."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import boltzfft as bz

import boltzfft_torch as bt
from boltzfft_torch.cli import maxwell_bkw


def _f(cfg):
    return bt.bkw_f(cfg.velocity_grid.r_squared(), 6.5)


@pytest.mark.parametrize("precision", ["default", "highest"])
@pytest.mark.parametrize("kw", [
    dict(nv=8, ns=6),
    dict(nv=8, nvy=10, nvz=12, ns=6),
    dict(nv=8, ns=12, node_chunk=5),  # padded nodes, chunks of 5
])
def test_dft_matches_boltzfft(kw, precision):
    kw = dict(kw, impl="dft", fused_precision=precision)
    cfg_j = bz.CollisionConfig(**kw)
    collide_j, pre_j = bz.make_collision_operator(cfg_j)
    f = _f(cfg_j)
    q_j = np.asarray(collide_j(jnp.asarray(f), pre_j))

    cfg = bt.CollisionConfig(**kw)
    collide, pre = bt.make_collision_operator(cfg, device="cpu")
    assert pre.dft_fwd is not None and (pre.dft_fwd_y is not None) == (not cfg.is_isotropic)
    q = collide(torch.as_tensor(f), pre)
    assert q.dtype == torch.float64 and q.shape == f.shape
    np.testing.assert_allclose(q.numpy(), q_j, rtol=0, atol=1e-12 * np.abs(q_j).max())


def test_dft_matches_staged_c2c_and_batches():
    cfg = bt.CollisionConfig(nv=16, ns=12, impl="dft")
    cfg_c = bt.CollisionConfig(nv=16, ns=12, impl="c2c")
    f = torch.as_tensor(_f(cfg))
    fs = torch.stack([f, 0.8 * f])
    q = bt.collide(cfg, bt.build_precomp(cfg, "cpu"), fs)
    q_c = bt.collide(cfg_c, bt.build_precomp(cfg_c, "cpu"), fs)
    np.testing.assert_allclose(q.numpy(), q_c.numpy(), rtol=0, atol=1e-12 * float(q_c.abs().max()))
    one = bt.collide(cfg, bt.build_precomp(cfg, "cpu"), fs[1])
    assert torch.equal(q[1], one)


def test_dft_float32_and_gradient():
    cfg = bt.CollisionConfig(nv=8, ns=6, impl="dft", dtype="float32")
    cfg64 = bt.CollisionConfig(nv=8, ns=6, impl="dft")
    f = torch.as_tensor(_f(cfg64))
    q32 = bt.collide(cfg, bt.build_precomp(cfg, "cpu"), f.float())
    q64 = bt.collide(cfg64, bt.build_precomp(cfg64, "cpu"), f)
    assert q32.dtype == torch.float32
    assert float((q32.double() - q64).abs().max()) <= 1e-5 * float(q64.abs().max())
    # plain torch ops end to end: autograd works, and agrees with c2c's
    cfg_c = bt.CollisionConfig(nv=8, ns=6, impl="c2c")
    grads = []
    for c in (cfg64, cfg_c):
        x = f.clone().requires_grad_(True)
        bt.collide(c, bt.build_precomp(c, "cpu"), x).square().sum().backward()
        grads.append(x.grad)
    np.testing.assert_allclose(grads[0].numpy(), grads[1].numpy(), rtol=0,
                               atol=1e-12 * float(grads[1].abs().max()))


def test_dft_cli(capsys):
    assert maxwell_bkw.main(["--Nv", "8", "--Ns", "6", "--impl", "dft", "--device", "cpu",
                             "-t", "1"]) == 0
    out = capsys.readouterr().out
    assert "impl = dft" in out and "Statistics for boltzfft_torch/dft" in out
    linf = float(out.split("Linf error:")[1].split()[0])
    cfg = bt.CollisionConfig(nv=8, ns=6, impl="c2c")
    rsq = cfg.velocity_grid.r_squared()
    q = bt.collide(cfg, bt.build_precomp(cfg, "cpu"), torch.as_tensor(bt.bkw_f(rsq, 6.5)))
    want = bt.error_norms(q, bt.bkw_dfdt(rsq, 6.5), cfg.velocity_grid.dv)["Linf"]
    assert linf == pytest.approx(want, rel=1e-5)
