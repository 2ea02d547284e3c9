"""CollisionConfig and Precomp of the PyTorch port against boltzfft's: every
table bitwise equal in float64, the same node padding on the CPU, the same
validation errors, and tables carried across with ``precomp_from_numpy``."""

import dataclasses

import numpy as np
import pytest
import torch

import boltzfft as bz

import boltzfft_torch as bt
from boltzfft_torch import weights as bt_weights

CONFIGS = [
    dict(nv=8, ns=6),
    dict(nv=8, nvy=10, nvz=12, ns=6),
    dict(nv=8, ns=6, n_radial=6, gamma=1.0),
    dict(nv=8, ns=12, node_chunk=5),
    dict(nv=8, ns=6, antipodal=False),
]
IMPLS = ["c2c", "rfft", "fused"]


def _jax_arrays(pre):
    return {k: None if v is None else np.asarray(v) for k, v in pre._asdict().items()}


@pytest.mark.parametrize("kw", CONFIGS)
@pytest.mark.parametrize("impl", IMPLS)
def test_precomp_fields_bitwise(kw, impl):
    cfg_j = bz.CollisionConfig(impl=impl, **kw)
    cfg_t = bt.CollisionConfig(impl=impl, **kw)
    assert cfg_t.n_nodes_padded("cpu") == cfg_j.n_nodes_padded
    assert cfg_t.chunk("cpu") == cfg_j.chunk
    ref = _jax_arrays(bz.build_precomp(cfg_j))
    pre = bt.build_precomp(cfg_t, "cpu")
    for field in dataclasses.fields(bt.Precomp):
        a, b = ref[field.name], getattr(pre, field.name)
        if a is None:
            assert b is None, field.name
            continue
        assert b.dtype == torch.float64 and b.device.type == "cpu"
        assert np.array_equal(a, b.numpy()), field.name


def test_precomp_float32_cast_matches():
    kw = dict(nv=8, nvy=10, nvz=12, ns=6, impl="fused", dtype="float32")
    ref = _jax_arrays(bz.build_precomp(bz.CollisionConfig(**kw)))
    pre = bt.build_precomp(bt.CollisionConfig(**kw), "cpu")
    for k, a in ref.items():
        if a is not None:
            b = getattr(pre, k)
            assert b.dtype == torch.float32
            assert np.array_equal(a, b.numpy()), k


def test_padded_nodes_carry_zero_weight():
    cfg = bt.CollisionConfig(nv=8, ns=12, node_chunk=5)  # 48 nodes -> 50
    pre = bt.build_precomp(cfg, "cpu")
    assert pre.rho.shape[0] == 50 and cfg.n_nodes == 48
    assert torch.all(pre.gain_w[48:] == 0)


def test_device_budget_fallback_matches_jax():
    from boltzfft import weights as bz_weights

    assert bt_weights._device_hbm_budget("cpu") == bz_weights._device_hbm_budget()
    cfg = bt.CollisionConfig(nv=64, ns=192, dtype="float64", impl="c2c")
    cfg_j = bz.CollisionConfig(nv=64, ns=192, dtype="float64", impl="c2c")
    assert cfg.auto_chunk("cpu") == cfg_j.auto_chunk()
    assert cfg.auto_chunk("cpu", budget_bytes=1 << 30) == cfg_j.auto_chunk(1 << 30)


@pytest.mark.parametrize(
    "kw,match",
    [
        (dict(impl="bogus"), "impl must be"),
        (dict(dtype="float16"), "dtype must be"),
        (dict(nv=9), "nv must be even"),
        (dict(nvy=7), "nvy must be even"),
        (dict(nvz=5), "nvz must be even"),
        (dict(ns=13), "No spherical design"),
    ],
)
def test_validation_errors_match(kw, match):
    with pytest.raises(ValueError, match=match) as ej:
        bz.CollisionConfig(**kw)
    with pytest.raises(ValueError, match=match) as et:
        bt.CollisionConfig(**kw)
    if "impl" not in kw:
        assert str(ej.value) == str(et.value)


def test_derived_quantities_match():
    kw = dict(nv=8, nvy=10, nvz=12, ns=32, n_radial=4, support_radius=4.0)
    a, b = bz.CollisionConfig(**kw), bt.CollisionConfig(**kw)
    for name in ("grid_shape", "is_isotropic", "n_gl", "r_max", "domain_length",
                 "ns_eff", "n_nodes"):
        assert getattr(a, name) == getattr(b, name), name
    assert b.real_dtype == torch.float64 and b.complex_dtype == torch.complex128


def test_precomp_from_numpy_round_trip():
    cfg_j = bz.CollisionConfig(nv=8, nvy=10, nvz=12, ns=6, impl="fused")
    jax_pre = bz.build_precomp(cfg_j)
    arrays = {k: np.asarray(v) for k, v in jax_pre._asdict().items()}
    pre = bt.precomp_from_numpy(arrays, device="cpu", dtype="float64")
    for k, v in jax_pre._asdict().items():
        got = getattr(pre, k)
        if v is None:
            assert got is None
        else:
            assert np.array_equal(np.asarray(v), got.numpy()), k

    # the carried-across tables give the same Q as the port's own
    cfg_t = bt.CollisionConfig(nv=8, nvy=10, nvz=12, ns=6, impl="fused")
    collide, own = bt.make_collision_operator(cfg_t, device="cpu")
    f = torch.as_tensor(bt.bkw_f(cfg_t.velocity_grid.r_squared(), 6.5))
    assert torch.equal(collide(f, pre), collide(f, own))


def test_precomp_to_device():
    pre = bt.build_precomp(bt.CollisionConfig(nv=8, ns=6, impl="fused"), "cpu")
    moved = pre.to("cpu")
    assert moved.device.type == "cpu"
    assert moved.dft_fwd_y is None
    assert all(a is b for a, b in zip(moved.dft_inv_axes(), (moved.dft_inv,) * 3))
    assert torch.equal(moved.beta2, pre.beta2)


def test_sincc_numpy_and_torch_agree():
    x = np.linspace(0.0, 20.0, 101)
    eps = float(np.finfo(np.float64).eps)
    a = bz.sincc(x, eps)
    b = bt.sincc(torch.as_tensor(x), eps).numpy()
    assert np.array_equal(np.asarray(a), bt.sincc(x, eps))
    np.testing.assert_allclose(b, a, rtol=1e-15, atol=0)
