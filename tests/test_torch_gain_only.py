"""The gain-only fused routes of the PyTorch port: K2 (``fused_scheme="ct"``
under a ``gain_reduce`` hook) and K4 (``fused_scheme="transpose"``), their
plain PyTorch version on the CPU against boltzfft's ``fused_gain`` (Pallas
in interpret mode), the fused + hook ``collide`` against boltzfft's for ct,
transpose and kron, the 16^3 fused gradient, dispatch, and — on a card only
— the CUDA entry against its plain version.

The JAX package is imported inside the tests that use it, so the ``cuda``
tests also run on a machine without jax:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gain_only.py -m cuda
"""

import numpy as np
import pytest
import torch

import boltzfft_torch as bt
from boltzfft_torch import operator as bt_op
from boltzfft_torch.kernels import fused_collide as k1
from boltzfft_torch.kernels import fused_gain as k3
from boltzfft_torch.kernels import fused_gain_dft as k24


def _jax():
    import jax
    import jax.numpy as jnp

    import boltzfft as bz
    from boltzfft import pallas_kernels as pk

    return jax, jnp, bz, pk


def _bkw_f(cfg, t=6.5):
    return bt.bkw_f(cfg.velocity_grid.r_squared(), t)


def _gain_args(cfg, pre, f_hat):
    ax, ay, az = bt_op._alpha_factors(cfg, pre, pre.rho, pre.sigma)
    args = (pre.rho, pre.gain_w, ax, ay, az, f_hat, pre.dft_inv_axes(), pre.dft_fwd_axes(),
            pre.norm_l)
    kw = dict(length=cfg.domain_length, b_gamma=cfg.b_gamma, radial_group=cfg.ns_eff)
    return args, kw


def _spectrum(f, cfg):
    return torch.fft.fftn(torch.as_tensor(f).to(cfg.complex_dtype), dim=(-3, -2, -1))


@pytest.mark.parametrize("scheme,kw", [
    ("ct", dict(nv=8, ns=6)),
    ("transpose", dict(nv=8, ns=6)),
    ("ct", dict(nv=8, nvy=10, nvz=12, ns=6)),
])
def test_gain_matches_boltzfft(scheme, kw):
    # the same Precomp carried across; boltzfft's ct scheme splits 8, 10 and
    # 12 with radix 2 in interpret mode, the port runs dense per-axis DFTs
    _, jnp, bz, pk = _jax()
    cfg_j = bz.CollisionConfig(impl="fused", fused_scheme=scheme, **kw)
    pre_j = bz.build_precomp(cfg_j)
    f_hat = np.fft.fftn(_bkw_f(cfg_j))
    ax, ay, az = bz.operator._alpha_factors(cfg_j, pre_j, pre_j.rho, pre_j.sigma)
    q_j = np.asarray(pk.fused_gain(
        pre_j.rho, pre_j.gain_w, ax, ay, az, jnp.asarray(f_hat),
        pre_j.dft_inv_axes(), pre_j.dft_fwd_axes(), pre_j.norm_l,
        length=cfg_j.domain_length, b_gamma=cfg_j.b_gamma, scheme=scheme,
        radial_group=cfg_j.ns_eff,
    ))

    cfg = bt.CollisionConfig(impl="fused", fused_scheme=scheme, **kw)
    pre = bt.precomp_from_numpy(
        {k: None if v is None else np.asarray(v) for k, v in pre_j._asdict().items()},
        device="cpu", dtype="float64",
    )
    args, gkw = _gain_args(cfg, pre, torch.as_tensor(f_hat))
    calls = dict(k24.REFERENCE_CALLS)
    q = k24.fused_gain_dft(*args, scheme=scheme, **gkw)
    assert k24.REFERENCE_CALLS[scheme] == calls[scheme] + 1
    assert q.dtype == torch.complex128 and q.shape == f_hat.shape
    np.testing.assert_allclose(q.numpy(), q_j, rtol=0, atol=1e-12 * np.abs(q_j).max())
    # the dispatcher sends the scheme to the same place
    assert torch.equal(k3.fused_gain(*args, scheme=scheme, **gkw), q)


@pytest.mark.parametrize("scheme", ["ct", "transpose", "kron"])
def test_hook_collide_matches_boltzfft(scheme):
    _, jnp, bz, _ = _jax()
    kw = dict(nv=8, ns=6, n_radial=4, impl="fused", fused_scheme=scheme)
    cfg_j = bz.CollisionConfig(**kw)
    pre_j = bz.build_precomp(cfg_j)
    f = _bkw_f(cfg_j)
    hook = lambda q: 0.5 * q  # noqa: E731
    q_j = np.asarray(bz.collide(cfg_j, pre_j, jnp.asarray(f), hook))

    cfg = bt.CollisionConfig(**kw)
    pre = bt.build_precomp(cfg, "cpu")
    before = (k1.REFERENCE_CALLS, k3.REFERENCE_CALLS, dict(k24.REFERENCE_CALLS))
    q = bt.collide(cfg, pre, torch.as_tensor(f), hook)
    k3_calls = k3.REFERENCE_CALLS - before[1]
    k24_calls = {s: k24.REFERENCE_CALLS[s] - before[2][s] for s in ("ct", "transpose")}
    assert k1.REFERENCE_CALLS == before[0]
    assert k3_calls == (scheme == "kron")
    assert k24_calls == {"ct": int(scheme == "ct"), "transpose": int(scheme == "transpose")}
    np.testing.assert_allclose(q.numpy(), q_j, rtol=0, atol=1e-12 * np.abs(q_j).max())


def test_transpose_collide_without_hook_is_k4():
    cfg = bt.CollisionConfig(nv=8, ns=6, impl="fused", fused_scheme="transpose")
    cfg_c = bt.CollisionConfig(nv=8, ns=6, impl="c2c")
    f = torch.as_tensor(_bkw_f(cfg))
    fs = torch.stack([f, 0.8 * f])
    calls = k24.REFERENCE_CALLS["transpose"]
    q = bt.collide(cfg, bt.build_precomp(cfg, "cpu"), fs)
    assert k24.REFERENCE_CALLS["transpose"] == calls + 1  # the whole batch at once
    qc = bt.collide(cfg_c, bt.build_precomp(cfg_c, "cpu"), fs)
    np.testing.assert_allclose(q.numpy(), qc.numpy(), rtol=0, atol=1e-12 * float(qc.abs().max()))


def test_gain_batch_equals_per_item():
    cfg = bt.CollisionConfig(nv=8, nvy=10, nvz=12, ns=6, impl="fused")
    pre = bt.build_precomp(cfg, "cpu")
    f = _bkw_f(cfg)
    fh = _spectrum(np.stack([f, 0.8 * f]), cfg)
    args, kw = _gain_args(cfg, pre, fh)
    q = k24.fused_gain_dft(*args, scheme="ct", **kw)
    one = torch.stack([k24.fused_gain_dft(*_gain_args(cfg, pre, x)[0], scheme="ct", **kw)
                       for x in fh])
    assert torch.equal(q, one)


@pytest.mark.parametrize("scheme", ["ct", "transpose", "kron"])
def test_gain_only_routes_have_no_gradient(scheme):
    cfg = bt.CollisionConfig(nv=8, ns=6, impl="fused", fused_scheme=scheme)
    pre = bt.build_precomp(cfg, "cpu")
    x = torch.as_tensor(_bkw_f(cfg)).requires_grad_(True)
    with pytest.raises(NotImplementedError, match="no gradient.*fused_scheme='ct'"):
        bt.collide(cfg, pre, x, gain_reduce=lambda q: q)


def test_fused_gradient_16_matches_jax():
    # 16^3 takes K1 again (operator.pick_scheme), so the fused route is
    # differentiable there, through the staged c2c backward
    jax, jnp, bz, _ = _jax()
    kw = dict(nv=16, ns=6, impl="fused")
    cfg_j = bz.CollisionConfig(**kw)
    pre_j = bz.build_precomp(cfg_j)
    f = _bkw_f(cfg_j)
    r = np.random.default_rng(1234).standard_normal(f.shape)
    g_j = np.asarray(jax.grad(
        lambda x: jnp.sum(bz.collide(cfg_j, pre_j, x) * jnp.asarray(r))
    )(jnp.asarray(f)))

    cfg = bt.CollisionConfig(**kw)
    assert bt_op.fused_scheme(cfg) == "ct"
    collide, pre = bt.make_collision_operator(cfg, device="cpu")
    x = torch.as_tensor(f).requires_grad_(True)
    (collide(x, pre) * torch.as_tensor(r)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), g_j, rtol=0, atol=1e-12 * np.abs(g_j).max())


def test_scheme_checks_and_dispatch():
    cfg = bt.CollisionConfig(nv=8, nvy=10, nvz=12, ns=6, impl="fused")
    pre = bt.build_precomp(cfg, "cpu")
    args, kw = _gain_args(cfg, pre, _spectrum(_bkw_f(cfg), cfg))
    with pytest.raises(ValueError, match="cubic grids only"):
        k24.fused_gain_dft(*args, scheme="transpose", **kw)
    with pytest.raises(ValueError, match="'ct' or 'transpose'"):
        k24.fused_gain_dft(*args, scheme="kron", **kw)
    meta = list(args)
    meta[5] = args[5].to("meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        k24.fused_gain_dft(*meta, scheme="ct", **kw)


# --------------------------------------------------------------------------
# on the card: the CUDA entry against its plain version
# --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


CUDA_CASES = [  # (scheme, config kwargs, batch, tolerance in max|Q_gain_hat|)
    ("ct", dict(nv=16, ns=12), 2, 1e-12),
    ("ct", dict(nv=8, nvy=10, nvz=12, ns=6), 1, 1e-12),
    ("ct", dict(nv=8, ns=12, node_chunk=5), 1, 1e-12),  # padded nodes (gain_w = 0)
    ("transpose", dict(nv=24, ns=6), 1, 1e-12),
    ("ct", dict(nv=32, ns=12, dtype="float32"), 1, 1e-5),
    ("ct", dict(nv=64, ns=12), 1, 1e-12),
    ("transpose", dict(nv=64, ns=12, dtype="float32"), 1, 1e-5),
    ("ct", dict(nv=16, nvy=72, nvz=72, ns=6), 1, 1e-12),  # the last-pass route
    ("ct", dict(nv=104, nvy=8, nvz=104, ns=6), 1, 1e-12),  # the matrix not resident
]


@pytest.mark.cuda
@pytest.mark.parametrize("scheme,kw,batch,tol", CUDA_CASES)
def test_kernel_matches_plain_on_card(cuda_device, scheme, kw, batch, tol):
    cfg = bt.CollisionConfig(impl="fused", fused_scheme=scheme, **kw)
    pre = bt.build_precomp(cfg, cuda_device)
    f = torch.as_tensor(_bkw_f(cfg), dtype=cfg.real_dtype, device=cuda_device)
    fh = _spectrum(torch.stack([f * (1.0 - 0.1 * i) for i in range(batch)]), cfg)
    args, gkw = _gain_args(cfg, pre, fh)
    launches = k24.LAUNCHES[scheme]
    q = k24.fused_gain_dft(*args, scheme=scheme, **gkw)
    torch.cuda.synchronize()
    assert k24.LAUNCHES[scheme] == launches + 1
    assert torch.equal(q, k24.fused_gain_dft(*args, scheme=scheme, **gkw))
    q_ref = k24.fused_gain_dft_reference(*args, **gkw)
    assert float((q - q_ref).abs().max()) <= tol * float(q_ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", ["ct", "transpose"])
def test_kernel_cell_stack_batch_equals_per_item_on_card(cuda_device, scheme):
    # the TG-2D cell stack: 256 spectra of 16^3, Ns=12, in one call
    cfg = bt.CollisionConfig(nv=16, ns=12, impl="fused", fused_scheme=scheme)
    pre = bt.build_precomp(cfg, cuda_device)
    f = torch.as_tensor(_bkw_f(cfg), dtype=cfg.real_dtype, device=cuda_device)
    fh = _spectrum(torch.stack([f * (1.0 - 0.5 * i / 256) for i in range(256)]), cfg)
    args, gkw = _gain_args(cfg, pre, fh)
    q = k24.fused_gain_dft(*args, scheme=scheme, **gkw)
    for i in (0, 97, 255):
        one = list(args)
        one[5] = fh[i]
        assert torch.equal(k24.fused_gain_dft(*one, scheme=scheme, **gkw), q[i])


@pytest.mark.cuda
def test_hook_route_matches_c2c_on_card(cuda_device):
    cfg = bt.CollisionConfig(nv=32, ns=12, impl="fused", fused_scheme="ct")
    cfg_c = bt.CollisionConfig(nv=32, ns=12, impl="c2c")
    f = torch.as_tensor(_bkw_f(cfg), device=cuda_device)
    q = bt.collide(cfg, bt.build_precomp(cfg, cuda_device), f, gain_reduce=lambda x: x)
    qc = bt.collide(cfg_c, bt.build_precomp(cfg_c, cuda_device), f)
    assert float((q - qc).abs().max()) <= 1e-12 * float(qc.abs().max())
