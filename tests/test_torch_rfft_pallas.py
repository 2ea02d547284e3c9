"""The rfft + ``use_pallas`` route of the PyTorch port: K5 (``gain_reduce``)
and K6 (``alpha_multiply``), their plain PyTorch versions on the CPU against
boltzfft's Pallas kernels (interpret mode), ``collide`` on the route against
boltzfft's, the ``CollisionConfig`` rules, dispatch, and — on a card only —
the CUDA kernels against their plain versions.

The JAX package is imported inside the tests that use it, so the ``cuda``
tests also run on a machine without jax:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_rfft_pallas.py -m cuda
"""

import numpy as np
import pytest
import torch

import boltzfft_torch as bt
from boltzfft_torch import operator as bt_op
from boltzfft_torch.kernels import alpha_multiply as k6
from boltzfft_torch.kernels import gain_reduce as k5

LENGTH, B_GAMMA = 9.0, 1.0 / (4 * np.pi)


def _jax():
    import jax.numpy as jnp

    import boltzfft as bz
    from boltzfft import pallas_kernels as pk

    return jnp, bz, pk


def _reduce_inputs(b, m, seed=0):
    """boltzfft's own gain_reduce test inputs (tests/test_pallas.py)."""
    rng = np.random.RandomState(seed)
    h_r, h_i = rng.randn(b, m), rng.randn(b, m)
    rho = rng.uniform(0.5, 10.0, b)
    gw = rng.uniform(0.0, 1.0, b)
    nl = rng.uniform(0.0, 30.0, m)
    return h_r, h_i, rho, gw, nl


@pytest.mark.parametrize("b,m", [(12, 256), (24, 17 * 16 * 16), (6, 320)])
def test_gain_reduce_matches_boltzfft(b, m):
    jnp, _, pk = _jax()
    h_r, h_i, rho, gw, nl = _reduce_inputs(b, m)
    out_r, out_i = pk.gain_reduce(
        jnp.asarray(h_r), jnp.asarray(h_i), jnp.asarray(rho), jnp.asarray(gw),
        jnp.asarray(nl), length=LENGTH, b_gamma=B_GAMMA)
    want = np.asarray(out_r) + 1j * np.asarray(out_i)
    t = lambda a: torch.as_tensor(a)  # noqa: E731
    calls = k5.REFERENCE_CALLS
    got = k5.gain_reduce(t(h_r + 1j * h_i), t(rho), t(gw), t(nl), length=LENGTH, b_gamma=B_GAMMA)
    assert k5.REFERENCE_CALLS == calls + 1 and got.dtype == torch.complex128
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-13 * scale)


@pytest.mark.parametrize("node_block", [1, 4, 8, 16, 7])
def test_gain_reduce_node_block_matches_boltzfft(node_block):
    """The node blocks of gcd(node_block, B) nodes (7: gcd 1) enter the sum's
    order as in boltzfft's kernel: the plain version against it at the same
    node_block."""
    jnp, _, pk = _jax()
    h_r, h_i, rho, gw, nl = _reduce_inputs(24, 320, seed=3)
    out_r, out_i = pk.gain_reduce(
        jnp.asarray(h_r), jnp.asarray(h_i), jnp.asarray(rho), jnp.asarray(gw),
        jnp.asarray(nl), length=LENGTH, b_gamma=B_GAMMA, node_block=node_block)
    want = np.asarray(out_r) + 1j * np.asarray(out_i)
    t = lambda a: torch.as_tensor(a)  # noqa: E731
    got = k5.gain_reduce(t(h_r + 1j * h_i), t(rho), t(gw), t(nl), length=LENGTH,
                         b_gamma=B_GAMMA, node_block=node_block)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-13 * np.abs(want).max())


@pytest.mark.parametrize("b,n,m2", [(6, 8, 8 * 5), (7, 5, 15)])  # (7, 5, 15): odd M2
def test_alpha_multiply_matches_boltzfft(b, n, m2):
    jnp, _, pk = _jax()
    rng = np.random.RandomState(1)
    ax = rng.randn(b, n) + 1j * rng.randn(b, n)
    ayz = rng.randn(b, m2) + 1j * rng.randn(b, m2)
    fh = rng.randn(n, m2) + 1j * rng.randn(n, m2)
    a1r, a1i, a2r, a2i = pk.alpha_multiply(
        *(jnp.asarray(p) for a in (ax, ayz, fh) for p in (a.real, a.imag)))
    calls = k6.REFERENCE_CALLS
    a1, a2 = k6.alpha_multiply(torch.as_tensor(ax), torch.as_tensor(ayz), torch.as_tensor(fh))
    assert k6.REFERENCE_CALLS == calls + 1
    assert a1.shape == (b, n, m2) and a2.dtype == torch.complex128
    np.testing.assert_allclose(a1.numpy(), np.asarray(a1r) + 1j * np.asarray(a1i), rtol=1e-12)
    np.testing.assert_allclose(a2.numpy(), np.asarray(a2r) + 1j * np.asarray(a2i), rtol=1e-12)
    # the kernel's order: the y/z product first, then x
    np.testing.assert_allclose(a1.numpy(), ax[:, :, None] * (ayz[:, None, :] * fh[None]), rtol=1e-14)


@pytest.mark.parametrize("kw", [
    dict(nv=8, ns=6),
    dict(nv=16, ns=6),
    dict(nv=8, ns=6, node_chunk=5),  # padded nodes, 5 chunks of 5
    dict(nv=8, ns=12, n_radial=4, gamma=1.0),
])
def test_pallas_collide_matches_boltzfft(kw):
    jnp, bz, _ = _jax()
    kw = dict(kw, impl="rfft", use_pallas=True)
    cfg_j = bz.CollisionConfig(**kw)
    collide_j, pre_j = bz.make_collision_operator(cfg_j, jit=False)
    f = bt.bkw_f(cfg_j.velocity_grid.r_squared(), 6.5)
    q_j = np.asarray(collide_j(jnp.asarray(f), pre_j))

    cfg = bt.CollisionConfig(**kw)
    collide, pre = bt.make_collision_operator(cfg, device="cpu")
    c5, c6 = k5.REFERENCE_CALLS, k6.REFERENCE_CALLS
    q = collide(torch.as_tensor(f), pre)
    assert k5.REFERENCE_CALLS - c5 == cfg.n_chunks("cpu") == k6.REFERENCE_CALLS - c6
    np.testing.assert_allclose(q.numpy(), q_j, rtol=0, atol=1e-12 * np.abs(q_j).max())


def test_pallas_collide_matches_staged_rfft():
    cfg = bt.CollisionConfig(nv=16, ns=12, impl="rfft", use_pallas=True)
    cfg_r = bt.CollisionConfig(nv=16, ns=12, impl="rfft")
    f = torch.as_tensor(bt.bkw_f(cfg.velocity_grid.r_squared(), 6.5))
    fs = torch.stack([f, 0.8 * f])
    q = bt.collide(cfg, bt.build_precomp(cfg, "cpu"), fs)
    q_r = bt.collide(cfg_r, bt.build_precomp(cfg_r, "cpu"), fs)
    np.testing.assert_allclose(q.numpy(), q_r.numpy(), rtol=0, atol=1e-13 * float(q_r.abs().max()))


@pytest.mark.parametrize("kw,msg", [
    (dict(impl="c2c", use_pallas=True), "use_pallas requires impl='rfft'"),
    (dict(impl="fused", use_pallas=True), "use_pallas requires impl='rfft'"),
    (dict(nv=8, nvy=10, use_pallas=True), "use_pallas requires a cubic grid"),
    (dict(fused_precision="fast"), "fused_precision must be"),
])
def test_config_errors_match_boltzfft(kw, msg):
    _, bz, _ = _jax()
    with pytest.raises(ValueError, match=msg) as ej:
        bz.CollisionConfig(**kw)
    with pytest.raises(ValueError, match=msg) as et:
        bt.CollisionConfig(**kw)
    assert str(ej.value) == str(et.value)


def test_dispatch_on_device():
    h = torch.ones((2, 5), dtype=torch.complex128, device="meta")
    r = torch.ones(2, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        k5.gain_reduce(h, r, r, torch.ones(5, device="meta"), length=1.0, b_gamma=1.0)
    with pytest.raises(ValueError, match="no kernel for device"):
        k6.alpha_multiply(h, h, h)


# --------------------------------------------------------------------------
# on the card: the CUDA kernels against their plain versions
# --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("float64", 1e-12), ("float32", 1e-5)])
def test_kernels_match_plain_on_card(cuda_device, dtype, tol):
    cfg = bt.CollisionConfig(nv=16, ns=12, impl="rfft", use_pallas=True, dtype=dtype)
    pre = bt.build_precomp(cfg, cuda_device)
    f = torch.as_tensor(bt.bkw_f(cfg.velocity_grid.r_squared(), 6.5), dtype=cfg.real_dtype,
                        device=cuda_device)
    fh = torch.fft.rfftn(f, dim=(-3, -2, -1)).reshape(16, -1)
    ax, ay, az = bt_op._alpha_factors(cfg, pre, pre.rho, pre.sigma)
    ayz = (ay[:, :, None] * az[:, None, :]).reshape(ay.shape[0], -1)
    launches = k6.LAUNCHES
    a = k6.alpha_multiply(ax, ayz, fh)
    torch.cuda.synchronize()
    assert k6.LAUNCHES == launches + 1
    ref = k6.alpha_multiply_reference(ax, ayz, fh)
    assert torch.equal(a[0], ref[0]) and torch.equal(a[1], ref[1])
    h = a[0].reshape(ax.shape[0], -1)
    nl = pre.norm_l.reshape(-1)
    kw = dict(length=cfg.domain_length, b_gamma=cfg.b_gamma)
    args = (h, pre.rho, pre.gain_w, nl)
    for nb in (1, 7, 8, 64):
        launches = k5.LAUNCHES
        got = k5.gain_reduce(*args, node_block=nb, **kw)
        routes = [k5._gain_reduce_cuda(*args, node_block=nb, split=s, **kw) for s in (0, 1)]
        again = k5.gain_reduce(*args, node_block=nb, **kw)
        torch.cuda.synchronize()
        assert k5.LAUNCHES == launches + 4
        assert torch.equal(got, again) and all(torch.equal(got, r) for r in routes), nb
        want = k5.gain_reduce_reference(*args, node_block=nb, **kw)
        assert float((got - want).abs().max()) <= tol * float(want.abs().max()), nb


@pytest.mark.cuda
def test_k5_plan_mirrors_the_library(cuda_device):
    import ctypes

    from boltzfft_torch import _build

    lib = _build.load_library()
    n_sm = _build.sm_count(cuda_device)
    for b, m in ((192, 32 * 32 * 17), (384, 64 * 64 * 33), (24, 321), (96, 16 * 16 * 9)):
        for nb in (1, 7, 8, 64):
            out = (ctypes.c_int * 3)()
            assert lib.bfft_gain_reduce_plan(b, m, nb, out) == 0
            assert tuple(out) == tuple(k5.plan(b, m, nb, n_sm)[:3]), (b, m, nb)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.complex128, torch.complex64])
def test_k5_takes_any_node_count_on_card(cuda_device, dtype):
    """More nodes than a block stages at once (1024) and than one stage of
    shared memory could hold (20000 in double), on both routes, against the
    plain version; the split route refuses more node blocks than the grid
    holds."""
    from boltzfft_torch import _build

    rng = np.random.default_rng(9)
    kw = dict(length=9.0, b_gamma=1.0 / (4 * np.pi))
    tol = 1e-12 if dtype == torch.complex128 else 1e-5
    rd = torch.float64 if dtype == torch.complex128 else torch.float32
    for b, m in ((2500, 300), (20000, 64)):
        h = torch.as_tensor(rng.standard_normal((b, m)) + 1j * rng.standard_normal((b, m)),
                            dtype=dtype, device=cuda_device)
        rho = torch.as_tensor(rng.uniform(0.5, 10.0, b), dtype=rd, device=cuda_device)
        gw = torch.as_tensor(rng.uniform(0.0, 1.0, b), dtype=rd, device=cuda_device)
        nl = torch.as_tensor(rng.uniform(0.0, 30.0, m), dtype=rd, device=cuda_device)
        for nb in (1, 8):
            routes = [k5._gain_reduce_cuda(h, rho, gw, nl, node_block=nb, split=s, **kw)
                      for s in (0, 1)]
            want = k5.gain_reduce_reference(h, rho, gw, nl, node_block=nb, **kw)
            torch.cuda.synchronize()
            assert torch.equal(routes[0], routes[1]), (b, nb)
            err = float((routes[0] - want).abs().max())
            assert err <= tol * float(want.abs().max()), (b, nb, err)
    b = k5.MAX_SPLIT_BLOCKS + 1
    h = torch.zeros((b, 4), dtype=dtype, device=cuda_device)
    ones = torch.ones(b, dtype=rd, device=cuda_device)
    nl = torch.ones(4, dtype=rd, device=cuda_device)
    assert k5.plan(b, 4, 1, _build.sm_count(cuda_device)).split == 0
    with pytest.raises(ValueError, match="node blocks"):
        k5._gain_reduce_cuda(h, ones, ones, nl, node_block=1, split=1, **kw)


@pytest.mark.cuda
def test_route_matches_c2c_on_card(cuda_device):
    kw = dict(nv=32, ns=12)
    cfg = bt.CollisionConfig(impl="rfft", use_pallas=True, **kw)
    cfg_c = bt.CollisionConfig(impl="c2c", **kw)
    f = torch.as_tensor(bt.bkw_f(cfg.velocity_grid.r_squared(), 6.5), device=cuda_device)
    c5, c6 = k5.LAUNCHES, k6.LAUNCHES
    q = bt.collide(cfg, bt.build_precomp(cfg, cuda_device), f)
    assert k5.LAUNCHES > c5 and k6.LAUNCHES > c6
    qc = bt.collide(cfg_c, bt.build_precomp(cfg_c, cuda_device), f)
    assert float((q - qc).abs().max()) <= 1e-12 * float(qc.abs().max())


# --------------------------------------------------------------------------
# the benchmark drivers that time these kernels, at a tiny size on the CPU
# --------------------------------------------------------------------------


def test_fft_benchmark_cli(capsys):
    from boltzfft_torch.cli import fft_benchmark

    assert fft_benchmark.main(["--Nv", "8", "--Ns", "6", "--device", "cpu", "--chain", "2"]) == 0
    out = capsys.readouterr().out
    assert "Batched 3D FFT benchmark: batch=48 of 8^3, dtype=float64" in out
    rows = [line for line in out.splitlines() if "s/round-trip" in line]
    assert len(rows) == 3 and "FAILED" not in out
    for row in rows:
        per_pass = float(row.split("s/round-trip")[0].split()[-1])
        err = float(row.split("L1 err")[1])
        assert per_pass > 0 and err < 1e-15
    assert "Fastest:" in out


def test_loop_benchmark_cli(capsys):
    from boltzfft_torch.cli import loop_benchmark

    calls = k5.REFERENCE_CALLS
    assert loop_benchmark.main(["--Nv", "8", "--Ns", "6", "--device", "cpu", "--chain", "1",
                                "--tile-size", "2", "5"]) == 0
    out = capsys.readouterr().out
    assert "Hot-loop benchmark: B=24 nodes, 8^3 grid" in out
    rows = [line for line in out.splitlines() if line.endswith("s/pass")]
    assert [r.split("(")[1].split(")")[0] for r in rows] == [
        "separable on-the-fly", "materialized table", "one reduction", "loop accumulate",
        "K5, tile=2", "K5, tile=5"]
    assert all(float(r.split()[-2]) > 0 for r in rows)
    assert k5.REFERENCE_CALLS > calls
    assert "Fastest:" in out
