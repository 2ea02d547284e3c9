"""``make_collision_operator(jit=True)`` on a card: every route's eval
replayed from a CUDA graph against the eager eval on the same precomp, and
K6 (``alpha_multiply``) against its plain version at ragged shapes.  Every
comparison is bitwise.

No test here imports jax, so the file runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_operator_graph_cuda.py -m cuda

Without a card every test skips.  Launches are counted on the first
graphed call (an eager warm-up and the capture) or on eager evals: a replay
moves no counter.
"""

import numpy as np
import pytest
import torch

import boltzfft_torch as bt
from boltzfft_torch import operator as bt_op
from boltzfft_torch.kernels import alpha_multiply as k6
from boltzfft_torch.kernels import fused_collide as k1
from boltzfft_torch.kernels import fused_gain as k3
from boltzfft_torch.kernels import fused_gain_dft as k24
from boltzfft_torch.kernels import gain_reduce as k5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


ROUTES = {  # name -> (CollisionConfig kwargs, grid)
    "rfft+pallas f64": (dict(impl="rfft", use_pallas=True), 16),
    "rfft+pallas f32": (dict(impl="rfft", use_pallas=True, dtype="float32"), 16),
    "rfft": (dict(impl="rfft"), 16),
    "c2c": (dict(impl="c2c"), 16),
    "dft": (dict(impl="dft"), 16),
    "fused ct (K1)": (dict(impl="fused", fused_scheme="ct"), 16),
    "fused transpose (K4)": (dict(impl="fused", fused_scheme="transpose"), 16),
    "fused kron (K3)": (dict(impl="fused", fused_scheme="kron"), 8),
}


def _f(cfg, device, t=6.5, batch=None):
    f = torch.as_tensor(bt.bkw_f(cfg.velocity_grid.r_squared(), t), dtype=cfg.real_dtype,
                        device=device)
    return f if batch is None else torch.stack([f * (1.0 - 0.1 * i) for i in range(batch)])


def _launches():
    return [k1.LAUNCHES, k3.LAUNCHES, k5.LAUNCHES, k6.LAUNCHES,
            k24.LAUNCHES["ct"], k24.LAUNCHES["transpose"]]


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [None, 3])
@pytest.mark.parametrize("route", list(ROUTES))
def test_graph_matches_eager(cuda_device, route, batch):
    kw, n = ROUTES[route]
    cfg = bt.CollisionConfig(nv=n, ns=12, **kw)
    graphed, pre = bt.make_collision_operator(cfg, device=cuda_device)
    f = _f(cfg, cuda_device, batch=batch)
    before = _launches()
    q_eager = bt.collide(cfg, pre, f)
    torch.cuda.synchronize()
    eager = [a - b for a, b in zip(_launches(), before)]
    before = _launches()
    q_graph = graphed(f, pre)  # an eager warm-up, then the capture
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_launches(), before)] == [2 * e for e in eager]
    before = _launches()
    q_replay = graphed(f, pre)
    torch.cuda.synchronize()
    assert _launches() == before  # a replay runs no wrapper
    assert torch.equal(q_graph, q_eager) and torch.equal(q_replay, q_eager)
    assert q_replay.data_ptr() != q_graph.data_ptr()  # a fresh Q each call
    # a second f leaves the first Q intact
    kept = q_replay.clone()
    q2 = graphed(_f(cfg, cuda_device, 7.5, batch), pre)
    torch.cuda.synchronize()
    assert torch.equal(q_replay, kept) and not torch.equal(q2, kept)
    assert torch.equal(q2, bt.collide(cfg, pre, _f(cfg, cuda_device, 7.5, batch)))


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["rfft+pallas f64", "fused kron (K3)", "fused ct (K1)"])
def test_replay_after_the_caches_are_cleared(cuda_device, route):
    """The tables a graph reads from ``pre.derived`` (K3's, the settled
    chunks) live as long as the graph: with them cleared and the freed
    memory refilled with NaN, a replay still equals the eager eval."""
    kw, n = ROUTES[route]
    cfg = bt.CollisionConfig(nv=n, ns=12, **kw)
    graphed, pre = bt.make_collision_operator(cfg, device=cuda_device)
    f = _f(cfg, cuda_device, batch=2)
    want = bt.collide(cfg, pre, f)
    graphed(f, pre)
    pre.derived.clear()
    junk = [torch.full((m,), float("nan"), device=cuda_device)
            for m in (64, 512, 4096) for _ in range(256)]
    q = graphed(f, pre)
    torch.cuda.synchronize()
    del junk
    assert torch.equal(q, want)
    assert torch.equal(bt.collide(cfg, pre, f), want)  # eager settles anew, the same bits


@pytest.mark.cuda
def test_rk4_relaxation_graphed_matches_eager(cuda_device):
    cfg = bt.CollisionConfig(nv=16, ns=12, impl="rfft", use_pallas=True)
    graphed, pre = bt.make_collision_operator(cfg, device=cuda_device)
    eager = lambda f, p: bt.collide(cfg, p, f)
    f0 = _f(cfg, cuda_device, 5.5)
    runs = [bt.make_relaxation(fn, pre, dt=0.125, n_steps=2, method="rk4")(f0).f
            for fn in (graphed, eager)]
    torch.cuda.synchronize()
    assert torch.equal(*runs)


@pytest.mark.cuda
def test_grad_needs_jit_false(cuda_device):
    """A graph replays no backward: an f that requires grad raises under
    jit=True, and jit=False differentiates through K1."""
    cfg = bt.CollisionConfig(nv=16, ns=12, impl="fused", fused_scheme="ct")
    graphed, pre = bt.make_collision_operator(cfg, device=cuda_device)
    f = _f(cfg, cuda_device).requires_grad_(True)
    with pytest.raises(RuntimeError, match="jit=False"):
        graphed(f, pre)
    with torch.no_grad():
        q = graphed(f, pre)  # no grad wanted: replayed
    eager, pre_e = bt.make_collision_operator(cfg, jit=False, device=cuda_device)
    (g,) = torch.autograd.grad(eager(f, pre_e).sum(), f)
    torch.cuda.synchronize()
    assert torch.equal(q, bt.collide(cfg, pre, f.detach()))
    assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0


@pytest.mark.cuda
def test_failed_capture_raises(cuda_device, monkeypatch):
    """A host sync inside the eval cannot be captured: the call raises with
    the cause; it never runs eager instead."""
    cfg = bt.CollisionConfig(nv=16, ns=12, impl="rfft", use_pallas=True)
    graphed, pre = bt.make_collision_operator(cfg, device=cuda_device)
    real = k6.alpha_multiply
    monkeypatch.setattr(bt_op._k6, "alpha_multiply",
                        lambda ax, ayz, fh: real(ax, ayz, fh * float(fh.abs().max() > 0)))
    with pytest.raises(RuntimeError, match="CUDA graph"):
        graphed(_f(cfg, cuda_device), pre)
    torch.cuda.synchronize()


def _k6_operands(b, n, m2, cd, device, seed=0):
    rng = np.random.default_rng(seed)
    c = lambda *s: torch.as_tensor(rng.standard_normal(s) + 1j * rng.standard_normal(s),
                                   dtype=cd, device=device)
    return c(b, n), c(b, m2), c(n, m2)


@pytest.mark.cuda
@pytest.mark.parametrize("cd", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("b,n,m2", [(6, 8, 40), (7, 5, 15), (70001, 2, 6), (192, 32, 544),
                                    (384, 64, 2112)])
def test_k6_matches_plain(cuda_device, cd, b, n, m2):
    """Ragged shapes (a partial tile, an odd M2; 70001 nodes: two a thread,
    the last node block of one node) and the route's chunks at 32^3 and
    64^3."""
    args = _k6_operands(b, n, m2, cd, cuda_device, b + n + m2)
    before = k6.LAUNCHES
    got = k6.alpha_multiply(*args)
    assert k6.LAUNCHES == before + 1
    again = k6.alpha_multiply(*args)
    want = k6.alpha_multiply_reference(*args)
    torch.cuda.synchronize()
    for x, y, z in zip(got, again, want):
        assert x.shape == (b, n, m2) and torch.equal(x, z) and torch.equal(x, y)


@pytest.mark.cuda
def test_k6_takes_misaligned_and_strided_operands(cuda_device):
    """f_hat one element off 16-byte alignment (the scalar route in float)
    and a transposed ayz (copied): still bitwise the plain version."""
    b, n, m2 = 12, 8, 40
    ax, ayz, fh = _k6_operands(b, n, m2, torch.complex64, cuda_device, 4)
    base = torch.zeros(n * m2 + 1, dtype=torch.complex64, device=cuda_device)
    off = base[1:].view(n, m2)
    off.copy_(fh)
    ayz_t = ayz.t().contiguous().t()
    assert k6.plan(b, n, m2, 8, False).vec == 1
    got = k6.alpha_multiply(ax, ayz_t, off)
    want = k6.alpha_multiply_reference(ax, ayz, fh)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(got, want))
