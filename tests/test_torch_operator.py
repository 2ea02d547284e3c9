"""Staged pipelines of the PyTorch port (c2c, rfft on torch.fft) against
boltzfft.collide, the NumPy direct sum and the reference BKW digits; stats
helpers and the CLI against their boltzfft counterparts."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import boltzfft as bz

import boltzfft_torch as bt
from boltzfft_torch.cli import maxwell_bkw

from reference_direct import direct_collision


def _bkw(cfg, t=6.5):
    rsq = cfg.velocity_grid.r_squared()
    return bt.bkw_f(rsq, t), bt.bkw_dfdt(rsq, t)


def _both(kw, f, gain_reduce=None):
    """(port Q, boltzfft Q) as float64 NumPy arrays for one configuration."""
    cfg_t = bt.CollisionConfig(**kw)
    collide_t, pre_t = bt.make_collision_operator(cfg_t, device="cpu")
    if gain_reduce is None:
        q_t = collide_t(torch.as_tensor(f), pre_t)
    else:
        q_t = bt.collide(cfg_t, pre_t, torch.as_tensor(f), gain_reduce)
    cfg_j = bz.CollisionConfig(**kw)
    collide_j, pre_j = bz.make_collision_operator(cfg_j)
    if gain_reduce is None:
        q_j = collide_j(jnp.asarray(f), pre_j)
    else:
        q_j = bz.collide(cfg_j, pre_j, jnp.asarray(f), gain_reduce)
    return q_t.numpy(), np.asarray(q_j)


@pytest.mark.parametrize("impl", ["c2c", "rfft"])
@pytest.mark.parametrize("nv", [8, 16])
def test_staged_matches_boltzfft(impl, nv):
    kw = dict(nv=nv, ns=6, impl=impl)
    f, _ = _bkw(bt.CollisionConfig(**kw))
    q_t, q_j = _both(kw, f)
    np.testing.assert_allclose(q_t, q_j, rtol=0, atol=1e-13 * np.abs(q_j).max())


@pytest.mark.parametrize("impl", ["c2c", "rfft"])
def test_staged_anisotropic_and_chunked_match_boltzfft(impl):
    kw = dict(nv=8, nvy=10, nvz=12, ns=12, node_chunk=5, impl=impl)
    f, _ = _bkw(bt.CollisionConfig(**kw))
    q_t, q_j = _both(kw, f)
    np.testing.assert_allclose(q_t, q_j, rtol=0, atol=1e-13 * np.abs(q_j).max())


def test_gain_reduce_hook_matches_boltzfft():
    kw = dict(nv=8, ns=6, impl="c2c")
    f, _ = _bkw(bt.CollisionConfig(**kw))
    q_t, q_j = _both(kw, f, gain_reduce=lambda q: 0.5 * q)
    np.testing.assert_allclose(q_t, q_j, rtol=0, atol=1e-13 * np.abs(q_j).max())


@pytest.mark.parametrize("gamma", [0.0, 1.0])
@pytest.mark.parametrize("impl", ["c2c", "rfft"])
def test_direct_sum_parity(gamma, impl):
    cfg = bt.CollisionConfig(nv=8, ns=6, n_radial=6, gamma=gamma, impl=impl)
    collide, pre = bt.make_collision_operator(cfg, device="cpu")
    f, _ = _bkw(cfg)
    gl = bt.gauss_legendre(cfg.n_gl, 0.0, cfg.r_max)
    sph = bt.spherical_design(cfg.ns)
    q_direct = direct_collision(
        f, gl.nodes, gl.weights, sph.points, sph.weights,
        cfg.domain_length, cfg.gamma, cfg.b_gamma,
    )
    q = collide(torch.as_tensor(f), pre).numpy()
    np.testing.assert_allclose(q, q_direct, rtol=0, atol=1e-13 * np.abs(q_direct).max())


def test_bkw_reference_digits_c2c_32():
    # the reference's f64 numbers at 32^3/Ns=12 (BASELINE.md)
    cfg = bt.CollisionConfig(nv=32, ns=12, impl="c2c")
    collide, pre = bt.make_collision_operator(cfg, device="cpu")
    f, q_exact = _bkw(cfg)
    err = bt.error_norms(collide(torch.as_tensor(f), pre), q_exact, cfg.velocity_grid.dv)
    np.testing.assert_allclose(err["L1"], 1.5403e-03, rtol=1e-4)
    np.testing.assert_allclose(err["L2"], 1.0119e-04, rtol=1e-4)
    np.testing.assert_allclose(err["Linf"], 4.2512e-05, rtol=1e-4)


def test_staged_batch_equals_per_item():
    cfg = bt.CollisionConfig(nv=8, ns=6, impl="rfft")
    collide, pre = bt.make_collision_operator(cfg, device="cpu")
    f = torch.as_tensor(_bkw(cfg)[0])
    fs = torch.stack([f, 0.8 * f])
    assert torch.equal(collide(fs, pre), torch.stack([collide(fs[0], pre), collide(fs[1], pre)]))


def test_fused_gain_spectrum_not_ported():
    # the gain-only spectrum of the ct scheme is K2, ported now
    # (tests/test_torch_gain_only.py); under a hook it gives the staged
    # pipeline's result
    from boltzfft_torch.kernels import fused_gain_dft as k24

    cfg = bt.CollisionConfig(nv=8, ns=6, impl="fused", fused_scheme="ct")
    cfg_c = bt.CollisionConfig(nv=8, ns=6, impl="c2c")
    pre, pre_c = bt.build_precomp(cfg, "cpu"), bt.build_precomp(cfg_c, "cpu")
    f = torch.as_tensor(_bkw(cfg)[0])
    calls = k24.REFERENCE_CALLS["ct"]
    q = bt.collide(cfg, pre, f, gain_reduce=lambda q: 0.5 * q)
    assert k24.REFERENCE_CALLS["ct"] == calls + 1
    qc = bt.collide(cfg_c, pre_c, f, gain_reduce=lambda q: 0.5 * q)
    np.testing.assert_allclose(q.numpy(), qc.numpy(), rtol=0, atol=1e-12 * float(qc.abs().max()))


@pytest.mark.parametrize(
    "times", [[1.0, 2.0, 3.0], [0.5], [1e-3, 2e-3, 1.7e-3, 0.9e-3], list(np.linspace(0.1, 0.9, 17))]
)
def test_run_stats_match_boltzfft(times):
    a, b = bz.RunStats.from_times(times), bt.RunStats.from_times(times)
    assert a.n == b.n and a.minimum == b.minimum and a.maximum == b.maximum
    np.testing.assert_allclose(b.mean, a.mean, rtol=1e-15)
    np.testing.assert_allclose(b.stdev, a.stdev, rtol=1e-15, atol=0)
    assert b.summary("FFTW") == a.summary("FFTW")


def test_error_norms_match_boltzfft():
    rng = np.random.default_rng(7)
    q, q_ref = rng.standard_normal((2, 8, 8, 8))
    a = bz.error_norms(q, q_ref, 0.25)
    b = bt.error_norms(torch.as_tensor(q), q_ref, 0.25)
    c = bt.error_norms_device(torch.as_tensor(q), q_ref, cell_volume=0.25**3)
    assert a == b
    for k in a:
        np.testing.assert_allclose(c[k], a[k], rtol=1e-13)
    with pytest.raises(ValueError, match="exactly one"):
        bt.error_norms(q, q_ref)


def test_time_fn_cpu():
    x = torch.arange(1000.0, dtype=torch.float64)
    stats, out = bt.time_fn(lambda v: torch.sum(v * v), x, device="cpu", trials=3, warmup=1)
    assert stats.n == 3 and stats.minimum > 0
    assert float(out) == float(np.sum(np.arange(1000.0) ** 2))
    with pytest.raises(ValueError, match="no timer"):
        bt.time_fn(lambda: None, device="meta", trials=1, warmup=0)


def test_cli_cpu_fused(capsys):
    assert maxwell_bkw.main(
        ["--Nv", "8", "--Ns", "6", "--impl", "fused", "--device", "cpu", "-t", "2"]
    ) == 0
    out = capsys.readouterr().out
    assert "Statistics for boltzfft_torch/fused" in out
    assert "Linf error:" in out


def test_cli_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="is_available"):
        maxwell_bkw.main(["--Nv", "8", "--Ns", "6", "--impl", "fused"])
