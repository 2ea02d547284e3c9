"""K1 (``impl="fused"``, ``fused_scheme="ct"``) of the PyTorch port: its plain
PyTorch version and ``collide`` on the CPU against boltzfft's fused Pallas
path (interpret mode),
batching, the autograd backward against ``jax.grad``, dispatch, and — on a
card only — the CUDA kernel against its plain version.

The JAX package is imported inside the tests that use it, so the ``cuda``
tests also run on a machine without jax:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_fused.py -m cuda
"""

import numpy as np
import pytest
import torch

import boltzfft_torch as bt
from boltzfft_torch import operator as bt_op
from boltzfft_torch.kernels import fused_collide as k1


def _jax():
    import jax
    import jax.numpy as jnp

    import boltzfft as bz

    return jax, jnp, bz


def _bkw_f(cfg, t=6.5):
    return bt.bkw_f(cfg.velocity_grid.r_squared(), t)


def _k1_args(cfg, pre, f):
    ax, ay, az = bt_op._alpha_factors(cfg, pre, pre.rho, pre.sigma)
    args = (pre.rho, pre.gain_w, ax, ay, az, f, pre.beta2,
            pre.dft_inv_axes(), pre.dft_fwd_axes(), pre.norm_l)
    kw = dict(length=cfg.domain_length, b_gamma=cfg.b_gamma, radial_group=cfg.ns_eff)
    return args, kw


PARITY = [  # (config kwargs, tolerance in max|Q|)
    (dict(nv=8, ns=6), 1e-12),
    (dict(nv=8, nvy=10, nvz=12, ns=6), 1e-12),
    (dict(nv=8, ns=32, n_radial=4), 1e-12),  # radial groups of 16 nodes
    (dict(nv=8, ns=12, node_chunk=5), 1e-12),  # padded nodes (gain_w = 0)
    # float32: the tolerance of boltzfft's own fused-vs-c2c float32 test
    (dict(nv=16, ns=6, dtype="float32"), 2e-5),
]


@pytest.mark.parametrize("kw,tol", PARITY)
def test_fused_matches_boltzfft(kw, tol):
    # A float32 result is held against boltzfft's float64 fused result on the
    # same (float32-rounded) input: at 16^3 the gain and loss terms are ~30x
    # max|Q| and cancel, so boltzfft's own float32 fused result already lies
    # 1.8e-5 max|Q| from its float64 one and two float32 results can differ
    # by twice that.
    _, jnp, bz = _jax()
    dtype = kw.get("dtype", "float64")
    cfg_j = bz.CollisionConfig(impl="fused", **dict(kw, dtype="float64"))
    collide_j, pre_j = bz.make_collision_operator(cfg_j)
    f = _bkw_f(cfg_j).astype(dtype)
    q_j = np.asarray(collide_j(jnp.asarray(f.astype(np.float64)), pre_j))
    scale = np.abs(q_j).max()

    cfg = bt.CollisionConfig(impl="fused", fused_scheme="ct", **kw)
    collide, pre = bt.make_collision_operator(cfg, device="cpu")
    ft = torch.as_tensor(f)
    q = collide(ft, pre)
    assert q.dtype == cfg.real_dtype and q.shape == ft.shape
    np.testing.assert_allclose(q.numpy(), q_j, rtol=0, atol=tol * scale)

    args, k1kw = _k1_args(cfg, pre, ft)
    q_ref = k1.fused_collide_reference(*args, **k1kw)
    assert torch.equal(q_ref, q)


def test_fused_matches_staged_c2c():
    cfg = bt.CollisionConfig(nv=16, ns=12, impl="fused", fused_scheme="ct")
    cfg_c = bt.CollisionConfig(nv=16, ns=12, impl="c2c")
    f = torch.as_tensor(_bkw_f(cfg))
    q = bt.make_collision_operator(cfg, device="cpu")[0](f, bt.build_precomp(cfg, "cpu"))
    collide_c, pre_c = bt.make_collision_operator(cfg_c, device="cpu")
    qc = collide_c(f, pre_c)
    np.testing.assert_allclose(q.numpy(), qc.numpy(), rtol=0, atol=1e-12 * float(qc.abs().max()))


def test_fused_batch_equals_per_item():
    cfg = bt.CollisionConfig(nv=8, nvy=10, nvz=12, ns=6, impl="fused", fused_scheme="ct")
    collide, pre = bt.make_collision_operator(cfg, device="cpu")
    f = torch.as_tensor(_bkw_f(cfg))
    fs = torch.stack([f, 0.8 * f])
    q = collide(fs, pre)
    assert q.shape == fs.shape
    assert torch.equal(q, torch.stack([collide(fs[0], pre), collide(fs[1], pre)]))


def test_fused_gradient_matches_jax():
    jax, jnp, bz = _jax()
    kw = dict(nv=8, ns=6, impl="fused")
    cfg_j = bz.CollisionConfig(**kw)
    pre_j = bz.build_precomp(cfg_j)
    f = _bkw_f(cfg_j)
    r = np.random.default_rng(1234).standard_normal(f.shape)
    g_j = np.asarray(jax.grad(
        lambda x: jnp.sum(bz.collide(cfg_j, pre_j, x) * jnp.asarray(r))
    )(jnp.asarray(f)))

    cfg = bt.CollisionConfig(fused_scheme="ct", **kw)
    collide, pre = bt.make_collision_operator(cfg, device="cpu")
    x = torch.as_tensor(f).requires_grad_(True)
    (collide(x, pre) * torch.as_tensor(r)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), g_j, rtol=0, atol=1e-10 * np.abs(g_j).max())


def test_dispatch_on_device():
    cfg = bt.CollisionConfig(nv=8, ns=6, impl="fused", fused_scheme="ct")
    collide, pre = bt.make_collision_operator(cfg, device="cpu")
    f = torch.as_tensor(_bkw_f(cfg))
    launches, ref_calls = k1.LAUNCHES, k1.REFERENCE_CALLS
    collide(f, pre)
    assert k1.REFERENCE_CALLS == ref_calls + 1
    assert k1.LAUNCHES == launches
    args, kw = _k1_args(cfg, pre, f.to("meta"))
    with pytest.raises(ValueError, match="no kernel for device"):
        k1.fused_collide(*args, **kw)


def test_check_grid():
    k1.check_grid((64, 64, 64), torch.float64)
    k1.check_grid((96, 32, 48), torch.float64)
    # over 96 points the matrix is read from device memory: 128^3 fits, and
    # an axis of 368 points leaves no room for a tile of two streams
    k1.check_grid((128, 128, 128), torch.float64)
    with pytest.raises(ValueError, match="shared memory"):
        k1.check_grid((368, 368, 368), torch.float64)
    with pytest.raises(ValueError, match="even"):
        k1.check_grid((8, 9, 8), torch.float32)
    with pytest.raises(TypeError, match="float32/float64"):
        k1.check_grid((8, 8, 8), torch.float16)


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="is_available"):
        bt.make_collision_operator(bt.CollisionConfig(nv=8, ns=6, impl="fused"), device="cuda")


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


CUDA_CASES = [  # (config kwargs, batch, tolerance in max|Q|)
    (dict(nv=16, ns=6), 1, 1e-12),
    (dict(nv=8, nvy=10, nvz=12, ns=6), 2, 1e-12),
    (dict(nv=32, nvy=16, nvz=48, ns=12), 1, 1e-12),
    (dict(nv=8, ns=12, node_chunk=5), 1, 1e-12),  # padded nodes (gain_w = 0)
    (dict(nv=32, ns=12, dtype="float32"), 1, 1e-5),
    (dict(nv=8, nvy=10, nvz=12, ns=6, dtype="float32"), 2, 2e-5),
    (dict(nv=64, ns=12), 1, 1e-12),
    (dict(nv=64, ns=12, dtype="float32"), 1, 1e-5),
    # y and z planes too large for shared memory: the last-pass route
    (dict(nv=16, nvy=72, nvz=72, ns=6), 1, 1e-12),
    # x and z over 96 points: those line passes read the matrix from device
    # memory
    (dict(nv=104, nvy=8, nvz=104, ns=6), 1, 1e-12),
    (dict(nv=128, nvy=8, nvz=128, ns=6, dtype="float32"), 1, 2e-5),
]


@pytest.mark.cuda
@pytest.mark.parametrize("kw,batch,tol", CUDA_CASES)
def test_kernel_matches_plain_on_card(cuda_device, kw, batch, tol):
    cfg = bt.CollisionConfig(impl="fused", **kw)
    pre = bt.build_precomp(cfg, cuda_device)
    f = torch.as_tensor(_bkw_f(cfg), dtype=cfg.real_dtype, device=cuda_device)
    if batch == 2:
        f = torch.stack([f, 0.8 * f])
    args, kw = _k1_args(cfg, pre, f)
    launches = k1.LAUNCHES
    q = k1.fused_collide(*args, **kw)
    torch.cuda.synchronize()
    assert k1.LAUNCHES == launches + 1
    q_ref = k1.fused_collide_reference(*args, **kw)
    scale = float(q_ref.abs().max())
    assert bool(torch.isfinite(q).all())
    assert float((q - q_ref).abs().max()) <= tol * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_kernel_bitwise_reproducible_on_card(cuda_device, dtype):
    cfg = bt.CollisionConfig(nv=16, ns=12, impl="fused", fused_scheme="ct", dtype=dtype)
    collide, pre = bt.make_collision_operator(cfg, jit=False, device=cuda_device)
    f = torch.as_tensor(_bkw_f(cfg), dtype=cfg.real_dtype, device=cuda_device)
    fs = torch.stack([f, 0.8 * f])
    assert torch.equal(collide(f, pre), collide(f, pre))
    assert torch.equal(collide(fs, pre), torch.stack([collide(fs[0], pre), collide(fs[1], pre)]))


@pytest.mark.cuda
def test_kernel_chunking_is_bitwise_invariant_on_card(cuda_device, monkeypatch):
    # one radial group per chunk (many launches) against the default single
    # chunk: the group order of the beta1 sum is the same, so bitwise equal
    cfg = bt.CollisionConfig(nv=16, ns=12, node_chunk=7, impl="fused", fused_scheme="ct")
    collide, pre = bt.make_collision_operator(cfg, jit=False, device=cuda_device)
    f = torch.as_tensor(_bkw_f(cfg), device=cuda_device)
    fs = torch.stack([f, 0.8 * f])
    q_one = collide(fs, pre)
    # the operator settles the chunk per precomp: a fresh one reads the rule again
    monkeypatch.setattr(k1, "_chunk_nodes", lambda n_nodes, group, *a: group)
    pre_g = bt.build_precomp(cfg, cuda_device)
    assert torch.equal(collide(fs, pre_g), q_one)
    assert bt_op.kernel_chunk(cfg, pre_g, fs) == cfg.ns_eff


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_kernel_cell_stack_batch_equals_per_item_on_card(cuda_device, dtype):
    # the TG-2D collision substep: 256 cells of 16^3, Ns=12, in one call
    cfg = bt.CollisionConfig(nv=16, ns=12, impl="fused", fused_scheme="ct", dtype=dtype)
    pre = bt.build_precomp(cfg, cuda_device)
    f = torch.as_tensor(_bkw_f(cfg), dtype=cfg.real_dtype, device=cuda_device)
    cells = torch.stack([f * (1.0 - 0.5 * i / 256) for i in range(256)])
    args, kw = _k1_args(cfg, pre, cells)
    q = k1.fused_collide(*args, **kw)
    for i in (0, 97, 255):
        one = list(args)
        one[5] = cells[i]
        assert torch.equal(k1.fused_collide(*one, **kw), q[i])
