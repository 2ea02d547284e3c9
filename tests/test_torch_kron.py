"""K3 (``impl="fused"`` on the kron route) of the PyTorch port: its plain
PyTorch version and ``collide`` on the CPU against boltzfft's
``fused_gain(scheme="kron")`` (interpret mode), the port's scheme rule,
batching, dispatch, and — on a card only — the CUDA kernel against its plain
version.

On the CPU boltzfft's own ``pick_scheme`` picks "ct" at these sizes
(interpret mode allows small radices), and the port's picks "ct" from 16^3
on, so the kron scheme is asked for by name.  The JAX package is imported inside the tests that use it, so
the ``cuda`` tests also run on a machine without jax:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kron.py -m cuda
"""

import numpy as np
import pytest
import torch

import boltzfft_torch as bt
from boltzfft_torch import operator as bt_op
from boltzfft_torch.kernels import fused_collide as k1
from boltzfft_torch.kernels import fused_gain as k3


def _jax():
    import jax.numpy as jnp

    import boltzfft as bz
    from boltzfft import pallas_kernels as pk

    return jnp, bz, pk


def _bkw_f(cfg, t=6.5):
    return bt.bkw_f(cfg.velocity_grid.r_squared(), t)


def _k3_call(fn, cfg, pre, f_hat):
    return fn(pre.rho, pre.gain_w, bt_op._kron_tables(cfg, pre), f_hat, pre.norm_l,
              length=cfg.domain_length, b_gamma=cfg.b_gamma, radial_group=cfg.ns_eff)


def _spectrum(f, cfg):
    return torch.fft.fftn(torch.as_tensor(f).to(cfg.complex_dtype), dim=(-3, -2, -1))


@pytest.mark.parametrize("kw,per_step", [
    (dict(nv=8, ns=6), 24),
    (dict(nv=8, nvy=12, nvz=16, ns=6), 24),
    (dict(nv=8, ns=6), 8),  # 3 grid steps of 8 nodes: boltzfft sums 1-node groups
])
def test_kron_gain_matches_boltzfft(kw, per_step):
    # the same Precomp carried across; boltzfft sums the groups of one grid
    # step from zero before adding them to its output, the port keeps one
    # running sum over whole radial groups, so the two agree to rounding
    jnp, bz, pk = _jax()
    cfg_j = bz.CollisionConfig(impl="fused", fused_scheme="kron", **kw)
    pre_j = bz.build_precomp(cfg_j)
    f = _bkw_f(cfg_j)
    f_hat = np.fft.fftn(f)
    ax, ay, az = bz.operator._alpha_factors(cfg_j, pre_j, pre_j.rho, pre_j.sigma)
    q_j = np.asarray(pk.fused_gain(
        pre_j.rho, pre_j.gain_w, ax, ay, az, jnp.asarray(f_hat),
        pre_j.dft_inv_axes(), pre_j.dft_fwd_axes(), pre_j.norm_l,
        length=cfg_j.domain_length, b_gamma=cfg_j.b_gamma,
        nodes_per_step=per_step, scheme="kron",
        radial_group=cfg_j.ns_eff,
    ))

    cfg = bt.CollisionConfig(impl="fused", **kw)
    pre = bt.precomp_from_numpy(
        {k: None if v is None else np.asarray(v) for k, v in pre_j._asdict().items()},
        device="cpu", dtype="float64",
    )
    q = _k3_call(k3.fused_gain_kron_reference, cfg, pre, torch.as_tensor(f_hat))
    assert q.dtype == torch.complex128 and q.shape == f.shape
    np.testing.assert_allclose(q.numpy(), q_j, rtol=0, atol=1e-12 * np.abs(q_j).max())
    # the gain-only dispatcher builds the same tables from the phases
    ax_t, ay_t, az_t = bt_op._alpha_factors(cfg, pre, pre.rho, pre.sigma)
    q_d = k3.fused_gain(pre.rho, pre.gain_w, ax_t, ay_t, az_t, torch.as_tensor(f_hat),
                        pre.dft_inv_axes(), pre.dft_fwd_axes(), pre.norm_l,
                        length=cfg.domain_length, b_gamma=cfg.b_gamma,
                        radial_group=cfg.ns_eff, scheme="kron")
    assert torch.equal(q_d, q)


def test_kron_gain_batch_equals_per_item():
    cfg = bt.CollisionConfig(nv=8, nvy=12, nvz=16, ns=6, impl="fused")
    pre = bt.build_precomp(cfg, "cpu")
    f = _bkw_f(cfg)
    fh = _spectrum(np.stack([f, 0.8 * f]), cfg)
    q = _k3_call(k3.fused_gain_kron, cfg, pre, fh)
    assert q.shape == fh.shape
    one = torch.stack([_k3_call(k3.fused_gain_kron, cfg, pre, x) for x in fh])
    assert torch.equal(q, one)


@pytest.mark.parametrize(
    "shape,scheme",
    [
        ((8, 8, 8), "kron"),
        ((32, 8, 8), "kron"),  # Ny*Nz = 64
        ((16, 16, 16), "ct"),
        ((24, 24, 24), "ct"),
        ((8, 12, 16), "ct"),
        ((32, 16, 48), "ct"),
        ((32, 32, 32), "ct"),
        ((48, 48, 48), "ct"),
        ((64, 64, 64), "ct"),
        ((16, 32, 64), "ct"),
        ((8, 32, 32), "ct"),
    ],
)
def test_pick_scheme(shape, scheme):
    # the port's rule follows its measurements on the card (kron only where
    # Ny*Nz <= 64); boltzfft's own choice on the CPU (interpret-mode
    # radices) is ct on every one of these grids, so the two agree wherever
    # the port takes K1, 16^3 included
    assert bt.pick_scheme(*shape) == scheme
    _, _, pk = _jax()
    assert pk.pick_scheme(*shape) == "ct"
    cfg = bt.CollisionConfig(nv=shape[0], nvy=shape[1], nvz=shape[2], impl="fused")
    assert bt_op.fused_scheme(cfg) == scheme
    forced = bt.CollisionConfig(nv=shape[0], nvy=shape[1], nvz=shape[2],
                                impl="fused", fused_scheme="ct")
    assert bt_op.fused_scheme(forced) == "ct"


def test_fused_scheme_validation():
    _, bz, _ = _jax()
    for kw, msg in ((dict(fused_scheme="bogus"), "fused_scheme must be"),
                    (dict(nv=8, nvy=10, impl="fused", fused_scheme="transpose"),
                     "requires a cubic grid")):
        with pytest.raises(ValueError, match=msg) as ej:
            bz.CollisionConfig(**kw)
        with pytest.raises(ValueError, match=msg) as et:
            bt.CollisionConfig(**kw)
        assert str(ej.value) == str(et.value)
    assert bt.CollisionConfig(impl="fused", fused_scheme="transpose").fused_scheme == "transpose"


def test_kron_collide_matches_boltzfft():
    jnp, bz, _ = _jax()
    kw = dict(nv=8, ns=6, n_radial=4)
    cfg_j = bz.CollisionConfig(impl="fused", fused_scheme="kron", **kw)
    collide_j, pre_j = bz.make_collision_operator(cfg_j, jit=False)
    f = _bkw_f(cfg_j)
    q_j = np.asarray(collide_j(jnp.asarray(f), pre_j))

    cfg = bt.CollisionConfig(impl="fused", fused_scheme="kron", **kw)
    collide, pre = bt.make_collision_operator(cfg, device="cpu")
    k1_calls, k3_calls = k1.REFERENCE_CALLS, k3.REFERENCE_CALLS
    q = collide(torch.as_tensor(f), pre)
    assert k3.REFERENCE_CALLS == k3_calls + 1 and k1.REFERENCE_CALLS == k1_calls
    np.testing.assert_allclose(q.numpy(), q_j, rtol=0, atol=1e-12 * np.abs(q_j).max())


def test_kron_collide_matches_staged_c2c():
    cfg = bt.CollisionConfig(nv=16, ns=12, impl="fused", fused_scheme="kron")
    cfg_c = bt.CollisionConfig(nv=16, ns=12, impl="c2c")
    f = torch.as_tensor(_bkw_f(cfg))
    fs = torch.stack([f, 0.8 * f])
    collide, pre = bt.make_collision_operator(cfg, device="cpu")
    collide_c, pre_c = bt.make_collision_operator(cfg_c, device="cpu")
    q, qc = collide(fs, pre), collide_c(fs, pre_c)
    np.testing.assert_allclose(q.numpy(), qc.numpy(), rtol=0, atol=1e-12 * float(qc.abs().max()))
    # the kron route transforms the whole batch at once: CPU torch.fft (MKL)
    # does not give a batch bitwise what it gives per item at 16^3 (it does
    # on cuFFT; test_kron_bitwise_reproducible_on_card), K3 does
    one = torch.stack([collide(fs[0], pre), collide(fs[1], pre)])
    np.testing.assert_allclose(q.numpy(), one.numpy(), rtol=0, atol=1e-13 * float(qc.abs().max()))


def test_kron_tables_built_once_per_precomp():
    cfg = bt.CollisionConfig(nv=8, ns=6, impl="fused", fused_scheme="kron")
    collide, pre = bt.make_collision_operator(cfg, device="cpu")
    f = torch.as_tensor(_bkw_f(cfg))
    q = collide(f, pre)
    tables = bt_op._kron_tables(cfg, pre)
    assert torch.equal(collide(f, pre), q)
    assert bt_op._kron_tables(cfg, pre) is tables
    assert len(pre.derived) == 1 and pre.to("cpu").derived == {}
    nyz = 64
    assert tables.kinv.shape == (nyz, nyz) and tables.ayz.shape == (pre.rho.shape[0], nyz)
    # K = kron(Vy, Vz) is symmetric and Ny Nz conj(K) is kron(Fy, Fz)
    assert torch.allclose(tables.kinv, tables.kinv.T, rtol=0, atol=1e-16)
    fy = torch.complex(pre.dft_fwd[0], pre.dft_fwd[1])
    assert torch.allclose(tables.kfwd, torch.kron(fy, fy), rtol=0, atol=1e-13)


def test_kron_gain_spectrum_and_hooks():
    cfg = bt.CollisionConfig(nv=8, ns=6, impl="fused", fused_scheme="kron")
    cfg_c = bt.CollisionConfig(nv=8, ns=6, impl="c2c")
    f = torch.as_tensor(_bkw_f(cfg))
    pre, pre_c = bt.build_precomp(cfg, "cpu"), bt.build_precomp(cfg_c, "cpu")
    fh = _spectrum(f, cfg)
    g, gc = bt.gain_spectrum(cfg, pre, fh), bt.gain_spectrum(cfg_c, pre_c, fh)
    np.testing.assert_allclose(g.numpy(), gc.numpy(), rtol=0, atol=1e-12 * float(gc.abs().max()))
    # a gain_reduce hook applies to K3's spectrum, as in the staged pipeline
    q = bt.collide(cfg, pre, f, gain_reduce=lambda q: 0.5 * q)
    qc = bt.collide(cfg_c, pre_c, f, gain_reduce=lambda q: 0.5 * q)
    np.testing.assert_allclose(q.numpy(), qc.numpy(), rtol=0, atol=1e-12 * float(qc.abs().max()))


def test_kron_route_has_no_gradient():
    cfg = bt.CollisionConfig(nv=8, ns=6, impl="fused", fused_scheme="kron")
    collide, pre = bt.make_collision_operator(cfg, device="cpu")
    x = torch.as_tensor(_bkw_f(cfg)).requires_grad_(True)
    with pytest.raises(NotImplementedError, match="no gradient"):
        collide(x, pre)
    with torch.no_grad():
        assert collide(x, pre).shape == x.shape


def test_kron_dispatch_on_device():
    cfg = bt.CollisionConfig(nv=8, ns=6, impl="fused")
    pre = bt.build_precomp(cfg, "cpu")
    fh = _spectrum(_bkw_f(cfg), cfg)
    launches, ref_calls = k3.LAUNCHES, k3.REFERENCE_CALLS
    _k3_call(k3.fused_gain_kron, cfg, pre, fh)
    assert k3.REFERENCE_CALLS == ref_calls + 1
    assert k3.LAUNCHES == launches
    with pytest.raises(ValueError, match="no kernel for device"):
        _k3_call(k3.fused_gain_kron, cfg, pre, fh.to("meta"))


# --------------------------------------------------------------------------
# on the card: the CUDA kernel against its plain version
# --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


CUDA_CASES = [  # (config kwargs, batch, tolerance in max|Q_gain_hat|)
    (dict(nv=16, ns=12), 1, 1e-12),
    (dict(nv=16, ns=12), 3, 1e-12),
    (dict(nv=8, nvy=12, nvz=16, ns=6), 1, 1e-12),
    (dict(nv=16, nvy=16, nvz=48, ns=12), 1, 1e-12),
    (dict(nv=8, ns=12, node_chunk=5), 2, 1e-12),  # padded nodes (gain_w = 0)
    (dict(nv=16, ns=12, dtype="float32"), 3, 1e-5),
    (dict(nv=8, nvy=12, nvz=16, ns=6, dtype="float32"), 1, 1e-5),
    (dict(nv=8, ns=12), 256, 1e-12),  # the default kron route on a cell stack (matrix resident)
    (dict(nv=16, nvy=16, nvz=48, ns=12, dtype="float32"), 1, 1e-5),  # matrix streamed, 6 tiles
]


@pytest.mark.cuda
@pytest.mark.parametrize("kw,batch,tol", CUDA_CASES)
def test_kron_kernel_matches_plain_on_card(cuda_device, kw, batch, tol):
    cfg = bt.CollisionConfig(impl="fused", **kw)
    pre = bt.build_precomp(cfg, cuda_device)
    f = torch.as_tensor(_bkw_f(cfg), dtype=cfg.real_dtype, device=cuda_device)
    fh = _spectrum(torch.stack([f * (1.0 - 0.1 * i) for i in range(batch)]), cfg)
    launches = k3.LAUNCHES
    q = _k3_call(k3.fused_gain_kron, cfg, pre, fh)
    torch.cuda.synchronize()
    assert k3.LAUNCHES == launches + 1
    q_ref = _k3_call(k3.fused_gain_kron_reference, cfg, pre, fh)
    assert bool(torch.isfinite(torch.view_as_real(q)).all())
    assert float((q - q_ref).abs().max()) <= tol * float(q_ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_kron_bitwise_reproducible_on_card(cuda_device, dtype):
    cfg = bt.CollisionConfig(nv=16, ns=12, impl="fused", fused_scheme="kron", dtype=dtype)
    collide, pre = bt.make_collision_operator(cfg, jit=False, device=cuda_device)
    f = torch.as_tensor(_bkw_f(cfg), dtype=cfg.real_dtype, device=cuda_device)
    fs = torch.stack([f, 0.8 * f, 1.1 * f])
    assert torch.equal(collide(fs, pre), collide(fs, pre))
    assert torch.equal(collide(fs, pre), torch.stack([collide(x, pre) for x in fs]))


@pytest.mark.cuda
def test_kron_gemm_runs_on_the_tensor_cores(cuda_device):
    # the y/z GEMM: DMMA in double, HMMA (3xTF32) in float, in the SASS of
    # the library the kernel runs from
    import ast

    from boltzfft_torch import _build

    _build.load_library()
    line = next(ln for ln in _build.BUILD_LOG.read_text().splitlines()
                if ln.startswith("# tensor-core instructions"))
    counts = ast.literal_eval(line.split(": ", 1)[1])
    assert counts["kron_gemm_kernel<double>"]["DMMA"] > 0
    assert counts["kron_gemm_kernel<float>"]["HMMA"] > 0


@pytest.mark.cuda
def test_kron_chunking_is_bitwise_invariant_on_card(cuda_device, monkeypatch):
    # one radial group per chunk (many launches of the stages) against the
    # default single chunk: the same group order, so bitwise equal
    cfg = bt.CollisionConfig(nv=16, ns=12, impl="fused", fused_scheme="kron")
    collide, pre = bt.make_collision_operator(cfg, jit=False, device=cuda_device)
    f = torch.as_tensor(_bkw_f(cfg), device=cuda_device)
    fs = torch.stack([f, 0.8 * f])
    q_one = collide(fs, pre)
    # the operator settles K1-K4's chunk per precomp by K1's rule: a fresh
    # precomp reads the rule again
    monkeypatch.setattr(k1, "_chunk_nodes", lambda n_nodes, group, *a: group)
    pre_g = bt.build_precomp(cfg, cuda_device)
    assert torch.equal(collide(fs, pre_g), q_one)
    assert bt_op.kernel_chunk(cfg, pre_g, fs) == cfg.ns_eff
