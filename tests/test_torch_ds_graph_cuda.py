"""The ds eval replayed from a CUDA graph (``make_ds_collision_operator(
jit=True)``) against the eager eval on a card, and K7's one-launch half-path
operand against its plain version.  Every comparison is bitwise.

No test here imports jax, so the file runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_ds_graph_cuda.py -m cuda

Without a card every test skips.  Launches are counted on the first
graphed call (an eager warm-up and the capture) or on eager evals: a replay
moves no counter.
"""

import numpy as np
import pytest
import torch

import boltzfft_torch as bt
from boltzfft_torch import _graph, ds, oz
from boltzfft_torch import ds_operator as dso
from boltzfft_torch.kernels import oz_contract as k8
from boltzfft_torch.kernels import oz_hadamard as k12
from boltzfft_torch.kernels import oz_preslice as k7


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


_OPS = {}


def _ops(n, g_stream, device):
    """(graphed, eager, pre, cfg) of the card's ds operator at n^3, Ns=12,
    built once per (n, g_stream)."""
    key = (n, g_stream)
    if key not in _OPS:
        cfg = bt.CollisionConfig(nv=n, ns=12, impl="c2c", dtype="float32")
        kw = {} if g_stream is None else dict(g_stream=g_stream)
        graphed, pre = bt.make_ds_collision_operator(cfg, jit=True, device=device, **kw)
        eager, _ = bt.make_ds_collision_operator(cfg, jit=False, device=device, **kw)
        _OPS[key] = (graphed, eager, pre, cfg)
    return _OPS[key]


def _f(cfg, device, t=6.5):
    return ds.from_f64(bt.bkw_f(cfg.velocity_grid.r_squared(), t), torch.float32, device)


def _same(a, b):
    return torch.equal(a.hi, b.hi) and torch.equal(a.lo, b.lo)


def _launches():
    from boltzfft_torch.kernels import oz_gmain as k9
    from boltzfft_torch.kernels import oz_gmain12 as k10
    from boltzfft_torch.kernels import oz_hadamard_full as k11

    return [k.LAUNCHES for k in (k7, k8, k9, k10, k11, k12)]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [16, 32])
@pytest.mark.parametrize("g_stream", [None, "full"])
def test_graph_matches_eager(cuda_device, n, g_stream):
    graphed, eager, pre, cfg = _ops(n, g_stream, cuda_device)
    f = _f(cfg, cuda_device)
    q_graph = graphed(f, pre)  # captured on the first call of this (pre, shape)
    before = _launches()
    q_replay = graphed(f, pre)
    torch.cuda.synchronize()
    assert _launches() == before  # a replay runs no wrapper
    q_eager = eager(f, pre)
    torch.cuda.synchronize()
    assert _same(q_graph, q_eager) and _same(q_replay, q_eager)
    assert q_replay.hi.data_ptr() != q_graph.hi.data_ptr()  # a fresh Q each call


@pytest.mark.cuda
def test_successive_graphed_calls_keep_their_results(cuda_device):
    graphed, eager, pre, cfg = _ops(16, None, cuda_device)
    f1, f2 = _f(cfg, cuda_device, 6.5), _f(cfg, cuda_device, 7.5)
    q1 = graphed(f1, pre)
    kept = ds.DS(q1.hi.clone(), q1.lo.clone())
    q2 = graphed(f2, pre)
    torch.cuda.synchronize()
    assert _same(q1, kept)  # not overwritten by the second replay
    assert _same(q1, eager(f1, pre)) and _same(q2, eager(f2, pre))
    assert not torch.equal(q1.hi, q2.hi)


@pytest.mark.cuda
def test_rk4_relaxation_graphed_matches_eager(cuda_device):
    graphed, eager, pre, cfg = _ops(16, None, cuda_device)
    f0 = _f(cfg, cuda_device)
    runs = [bt.make_relaxation(fn, pre, dt=0.01, n_steps=2, method="rk4")(f0).f
            for fn in (graphed, eager)]
    torch.cuda.synchronize()
    assert _same(*runs)


@pytest.mark.cuda
def test_recapture_on_a_new_precomp(cuda_device):
    """Three precomp objects (the keep of two graphs overflows), then the
    first again: each call equals the eager eval on its own tables."""
    cfg = bt.CollisionConfig(nv=16, ns=12, impl="c2c", dtype="float32")
    graphed, pre = bt.make_ds_collision_operator(cfg, jit=True, device=cuda_device)
    f = _f(cfg, cuda_device)
    scaled = lambda s: pre._replace(beta2=ds.DS(pre.beta2.hi * s, pre.beta2.lo * s))
    pres = [pre, scaled(0.5), scaled(2.0), pre]
    outs = [graphed(f, p) for p in pres]
    torch.cuda.synchronize()
    for p, q in zip(pres, outs):
        assert _same(q, dso.collide_ds(cfg, p, f, contract="oz"))
    assert not torch.equal(outs[0].hi, outs[1].hi)


@pytest.mark.cuda
def test_graph_outlives_the_constant_cache(cuda_device):
    """The grid constants a graph reads live as long as the graph: with the
    cache cleared and the memory it freed refilled with NaN, a replay still
    equals the eager eval bitwise."""
    cfg = bt.CollisionConfig(nv=16, ns=12, impl="c2c", dtype="float32")
    graphed, pre = bt.make_ds_collision_operator(cfg, jit=True, device=cuda_device)
    f = _f(cfg, cuda_device)
    dso._grid_consts.cache_clear()
    want = dso.collide_ds(cfg, pre, f, contract="oz")  # the constants, on this stream
    graphed(f, pre)  # captured, reading them
    dso._grid_consts.cache_clear()
    junk = [torch.full((n,), float("nan"), device=cuda_device)
            for n in (16, 128, 256) for _ in range(256)]
    q = graphed(f, pre)
    torch.cuda.synchronize()
    del junk
    assert _same(q, want)


def _bits(t):
    return t.view(torch.int16).cpu()


def _spectrum(grid, device, seed):
    """f_hat as the eval leaves it: the forward transform of a seeded real
    field (x the unit-stride axis)."""
    rng = np.random.default_rng(seed)
    ms = tuple(oz.slice_matrix(np.exp(-2j * np.pi * np.outer(np.arange(n), np.arange(n)) / n),
                               device=device) for n in grid)
    f = ds.from_f64(rng.standard_normal(grid), torch.float32, device)
    return oz.transform3_oz(ds.cds_from_real(f), ms, cmax=6, real_in=True)


@pytest.mark.cuda
@pytest.mark.parametrize("grid", [(16, 16, 16), (32, 32, 32), (64, 64, 64), (10, 8, 6)])
@pytest.mark.parametrize("merged", [False, True])
def test_k7_half_matches_plain(cuda_device, grid, merged):
    """The half path's step in one launch; (10, 8, 6): 10 x rows, not a
    multiple of the 8-row tile."""
    f_hat = _spectrum(grid, cuda_device, sum(grid))
    keep = lambda n: (torch.arange(n, device=cuda_device) != n // 2).to(torch.float32)
    fmask = keep(grid[0])[:, None] * keep(grid[1])[None, :]
    before = k7.LAUNCHES
    a = k7.preslice_half(f_hat, fmask, cmax=6, merged=merged)
    assert k7.LAUNCHES == before + 1
    b = k7.preslice_half(f_hat, fmask, cmax=6, merged=merged)
    ref = k7.preslice_half_reference(f_hat, fmask, cmax=6, merged=merged)
    torch.cuda.synchronize()
    for x, y, z in zip(a, b, ref):
        assert torch.equal(_bits(x), _bits(z)) and torch.equal(_bits(x), _bits(y))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["full path f_hat", "contiguous (5, 3, 24)",
                                    "contiguous (1, 4, 300)", "b fastest (3, 11, 12)",
                                    "contiguous (3, 2, 7)"])
@pytest.mark.parametrize("merged", [False, True])
def test_k7_rows_match_plain(cuda_device, layout, merged):
    """The generic entry at every vector width, ragged tiles included; the
    full path's f_hat (and an operand with one row along a) read in place,
    an operand whose a stride is not 1 copied once."""
    rng = np.random.default_rng(3)
    cds = lambda shape: ds.cds_from_f64(rng.standard_normal(shape)
                                        + 1j * rng.standard_normal(shape), torch.float32,
                                        cuda_device)
    if layout == "full path f_hat":
        x = _spectrum((32, 32, 32), cuda_device, 5)
    elif layout == "b fastest (3, 11, 12)":
        x = ds.tree_map(lambda a: a.permute(0, 2, 1), cds((3, 12, 11)))
    else:
        x = cds(tuple(int(s) for s in layout.split("(")[1].rstrip(")").split(",")))
    copies = k7.COPIES
    a = k7.preslice_rows(x, cmax=6, merged=merged)
    ref = k7.preslice_rows_reference(x, cmax=6, merged=merged)
    torch.cuda.synchronize()
    in_place = layout in ("full path f_hat", "contiguous (1, 4, 300)")
    assert k7.COPIES == copies + (not in_place)
    for y, z in zip(a, ref):
        assert torch.equal(_bits(y), _bits(z))


@pytest.mark.cuda
def test_failed_capture_raises(cuda_device):
    """A host sync inside the eval cannot be captured: the call raises, it
    never runs eager instead."""
    replayed = _graph.Replayed(lambda x, pre: ds.DS(x.hi * float(x.hi.sum()), x.lo))
    x = ds.from_f64(np.ones(4), torch.float32, cuda_device)
    with pytest.raises(RuntimeError, match="CUDA graph"):
        replayed(x, None)
    torch.cuda.synchronize()
