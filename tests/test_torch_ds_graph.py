"""The ds eval as ``make_ds_collision_operator(jit=True)`` captures it, on
the CPU: K7's one-launch half-path operand (``preslice_half``) against the
JAX package's ``preslice_rows`` of the same masked, swapped spectrum, the
kernel's indexing modelled in NumPy against the plain version, the eval
built from no host constant, and ``jit`` changing nothing on the CPU.

K7 is compared through the bf16 bit patterns, so a zero's sign counts.  Note
that a chunk of a zero is +0.0 whatever the zero's sign (the shift trick
``(x + m) - m``), so a mask taken as a select would give the same chunks as
the multiply; the tests still put negative entries under the mask.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boltzfft import ds as jds
from boltzfft import oz as joz

import boltzfft_torch as bt
from boltzfft_torch import _graph, ds
from boltzfft_torch import ds_operator as dso
from boltzfft_torch.kernels import oz_preslice as k7

F32 = np.float32


def _bits(t) -> np.ndarray:
    """The uint16 bit patterns of a bf16 tensor or JAX array."""
    if isinstance(t, torch.Tensor):
        return t.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(t).view(np.uint16)


def _f_hat(grid, seed):
    """A random spectrum as JAX and port CDS pairs; the port's laid out as
    the eval's forward transform leaves it (x the unit-stride axis)."""
    rng = np.random.default_rng(seed)
    z = rng.standard_normal(grid) * 3 + 1j * rng.standard_normal(grid)
    xt = ds.cds_from_f64(np.ascontiguousarray(z.transpose(1, 2, 0)), device="cpu")
    xt = ds.tree_map(lambda a: a.permute(2, 0, 1), xt)  # (Nx, Ny, Nz), strides (1, Nz Nx, Nx)
    return jds.cds_from_f64(z), xt


def _fmask(grid):
    nx, ny, _ = grid
    keep = lambda n: (np.arange(n) != n // 2).astype(F32)
    return keep(nx)[:, None] * keep(ny)[None, :]


@pytest.mark.parametrize("grid", [(8, 8, 8), (6, 8, 10), (16, 16, 16)])
@pytest.mark.parametrize("merged", [False, True])
def test_k7_half_matches_jax_preslice(grid, merged):
    xj, xt = _f_hat(grid, sum(grid))
    m = _fmask(grid)
    nzh = grid[2] // 2
    # negative entries under the mask: the multiply makes them -0.0
    assert (xt.re.hi[grid[0] // 2, :, :nzh] < 0).any() and (xt.im.hi[:, grid[1] // 2] < 0).any()
    mj = jnp.asarray(m)[:, :, None]
    fmain = jds._swap_last2(jax.tree.map(lambda a: a[..., :nzh] * mj, xj))  # as JAX's eval
    pj = joz.preslice_rows(fmain, cmax=6, interpret=True, merged=merged)
    mt = torch.as_tensor(m)
    for pt in (k7.preslice_half(xt, mt, cmax=6, merged=merged),
               k7.preslice_half_reference(xt, mt, cmax=6, merged=merged)):
        assert type(pt).__name__ == type(pj).__name__
        for a, b in zip(pj, pt):
            np.testing.assert_array_equal(_bits(a), _bits(b))
    # rows wholly under the mask (x on its Nyquist index) cut to +0.0 chunks
    sx = 7
    k = grid[1]
    full = (pt.full if merged else pt.all_re).reshape(grid[0], nzh, -1)
    assert (_bits(full[grid[0] // 2]) == 0).all() and full.shape[-1] == sx * k * (2 if merged else 1)


# ---- a NumPy model of csrc/oz_preslice.cu's indexing ----------------------


def _k7_model(planes, mask, sx, w, merged, v, g, rt, threads):
    """The kernel's blocks, tile loads (positions stepped by carries), lane
    groups and stores, step for step, on (A, B, K) float32 planes (and
    mask); returns the output bit arrays and how often each output element
    was written."""
    a_, b_, k_ = planes[0].shape
    kp = k_ | 1
    width = sx * (2 if merged else 1) * k_
    outs = [np.zeros(a_ * b_ * width, np.uint16) for _ in range(1 if merged else 2)]
    written = [np.zeros(a_ * b_ * width, np.int64) for _ in outs]
    tiles = -(-a_ // rt)
    for bid in range(tiles * b_):
        r0, gb = (bid % tiles) * rt, bid // tiles
        n_rows = min(rt, a_ - r0)
        tile = np.zeros((4, rt * kp), F32)
        loaded = np.zeros(rt * kp, np.int64)
        for t in range(threads):
            r, k = t % rt, t // rt
            dr, dk = threads % rt, threads // rt
            while k < k_:
                if r < n_rows:
                    ga = r0 + r
                    for q in range(4):
                        val = planes[q][ga, gb, k]
                        tile[q, r * kp + k] = val * mask[ga, gb, k] if mask is not None else val
                    loaded[r * kp + k] += 1
                r, k = r + dr, k + dk
                if r >= rt:
                    r, k = r - rt, k + 1
        assert all(loaded[r * kp + k] == 1 for r in range(n_rows) for k in range(k_))
        groups = threads // g
        for first in range(0, n_rows, groups):
            for grp in range(groups):
                tr = first + grp
                if tr >= n_rows:
                    continue
                ga = r0 + tr
                row = tile[:, tr * kp:tr * kp + k_]
                runs = [k0 for lane in range(g) for k0 in range(lane * v, k_, g * v)]
                ks = [k0 + e for k0 in runs for e in range(v)]
                assert sorted(ks) == list(range(k_))
                mr, mi = (int(np.abs(row[q, ks]).view(np.uint32).max()) for q in (0, 2))
                if merged:
                    mr = mi = max(mr, mi)
                sig = [np.uint32(min(max(((s >> 23) & 0xFF) + 1, 64), 254) << 23).view(F32)
                       for s in (mr, mi)]
                r = ga * b_ + gb
                for k0 in runs:
                    st = [row[q, k0:k0 + v].copy() for q in range(4)]
                    for i in range(sx):
                        cs = []
                        for comp, s in ((0, sig[0]), (1, sig[1])):
                            hi, lo = st[2 * comp], st[2 * comp + 1]
                            m_i = F32(np.ldexp(F32(1.5), 23 - w * (i + 1))) * s
                            c = (hi + m_i) - m_i
                            hi = hi - c
                            s2 = hi + lo
                            bb = s2 - hi
                            lo = (hi - (s2 - bb)) + (lo - bb)
                            st[2 * comp], st[2 * comp + 1] = s2, lo
                            cs.append((c.view(np.uint32) >> 16).astype(np.uint16))
                        if merged:
                            o = r * width + i * 2 * k_ + k0
                            for off, c in ((o, cs[0]), (o + k_, cs[1])):
                                outs[0][off:off + v] = c
                                written[0][off:off + v] += 1
                        else:
                            o = r * width + i * k_ + k0
                            for j in range(2):
                                outs[j][o:o + v] = cs[j]
                                written[j][o:o + v] += 1
    return outs, written


def _layouts(name, seed):
    """(A, B, K) operands: the half path's view, the full path's f_hat, and
    contiguous and b-fastest ones whose K takes every vector width."""
    rng = np.random.default_rng(seed)
    cds = lambda shape: ds.cds_from_f64(rng.standard_normal(shape) + 1j * rng.standard_normal(shape),
                                        device="cpu")
    if name == "half path (6, 8, 10)":
        _, xt = _f_hat((6, 8, 10), seed)
        x, m = k7._half_view(xt, torch.as_tensor(_fmask((6, 8, 10))))
        return x, m.expand(x.re.hi.shape)
    if name == "full path f_hat (10, 6, 8)":
        return _f_hat((10, 6, 8), seed)[1], None
    if name == "b fastest (3, 11, 12)":
        return ds.tree_map(lambda a: a.permute(0, 2, 1), cds((3, 12, 11))), None
    shape = {"contiguous (5, 3, 24)": (5, 3, 24), "contiguous (2, 9, 10)": (2, 9, 10),
             "contiguous (1, 4, 300)": (1, 4, 300), "contiguous (3, 2, 7)": (3, 2, 7)}[name]
    return cds(shape), None


@pytest.mark.parametrize("name", ["half path (6, 8, 10)", "full path f_hat (10, 6, 8)",
                                  "b fastest (3, 11, 12)", "contiguous (5, 3, 24)",
                                  "contiguous (2, 9, 10)", "contiguous (1, 4, 300)",
                                  "contiguous (3, 2, 7)"])
@pytest.mark.parametrize("merged", [False, True])
def test_k7_kernel_model_matches_plain(name, merged):
    """The kernel's indexing, modelled: every output element written once,
    with the plain version's bits, at each operand's plan (n_sm small so
    the tiles are ragged; the kernel reads the layouts whose a stride is
    not 1 from a copy, with the same indexing)."""
    x, mask = _layouts(name, 7)
    planes = [a.numpy() for a in (x.re.hi, x.re.lo, x.im.hi, x.im.lo)]
    a_, b_, k_ = planes[0].shape
    v, g, rt, threads = k7.plan(a_, b_, k_, 4)
    assert k_ % v == 0 and threads % 32 == 0 and 32 <= threads <= 256 and rt <= 32
    assert g <= 32 and g & (g - 1) == 0 and (g * v >= k_ or g == 32) and threads % g == 0
    assert 16 * rt * (k_ | 1) <= k7.SMEM_MAX and (rt < 2 * a_ or rt * g <= 32)
    outs, written = _k7_model(planes, None if mask is None else mask.numpy(), 7, 7, merged, v,
                              g, rt, threads)
    ref = k7.preslice_rows_reference(x, cmax=6, merged=merged, mask=mask)
    for o, wr, r in zip(outs, written, ref):
        assert (wr == 1).all()
        np.testing.assert_array_equal(o, _bits(r).reshape(-1))


def test_k7_plan_fills_the_card():
    """The half path's launches on a 132-SM card, 16 lanes a row: at 64^3
    16-row tiles along x, 8-byte stores (128 blocks of 256 threads); at 32^3
    4-row tiles, 4-byte stores (128 blocks of 64); one row along a, a
    warp of lanes on it."""
    assert k7.plan(64, 32, 64, 132) == (4, 16, 16, 256)
    assert k7.plan(32, 16, 32, 132) == (2, 16, 4, 64)
    assert k7.plan(1, 2048, 64, 132) == (4, 16, 2, 32)


# ---- the eval ------------------------------------------------------------


def _cfg(grid):
    return bt.CollisionConfig(nv=grid[0], nvy=grid[1], nvz=grid[2], ns=6, n_radial=2,
                              impl="c2c", dtype="float32")


def _f(cfg):
    return ds.from_f64(bt.bkw_f(cfg.velocity_grid.r_squared(), 6.5), torch.float32, "cpu")


@pytest.mark.parametrize("gmain_fused", [None, "3"])
def test_half_eval_builds_no_host_constant(monkeypatch, gmain_fused):
    """The half path's oz eval (with K7's operand when the main block is
    forced) runs while every constructor of a tensor from host data raises:
    what a captured eval may not do on the card."""
    cfg = _cfg((8, 8, 8))
    pre = dso.build_ds_precomp(cfg, device="cpu")
    f = _f(cfg)
    kw = dict(contract="oz", g_stream="half", gmain_fused=gmain_fused)
    want = dso.collide_ds(cfg, pre, f, **kw)

    def host_data(*args, **kwargs):
        raise AssertionError("the ds eval built a tensor from host data")

    dso._grid_consts.cache_clear()
    for name in ("as_tensor", "tensor", "from_numpy"):
        monkeypatch.setattr(torch, name, host_data)
    got = dso.collide_ds(cfg, pre, f, **kw)
    monkeypatch.undo()
    assert torch.equal(got.hi, want.hi) and torch.equal(got.lo, want.lo)


def test_half_eval_holds_its_cached_constants(monkeypatch):
    """What the eval takes from its constant cache it passes through
    ``_graph.hold``, so a graph captured from it keeps those tensors alive
    whatever the cache evicts."""
    cfg = _cfg((8, 8, 8))
    pre = dso.build_ds_precomp(cfg, device="cpu")
    monkeypatch.setattr(_graph, "_held", [])
    dso.collide_ds(cfg, pre, _f(cfg), contract="oz", g_stream="half")
    held = _graph._held
    gc = dso._grid_consts(cfg.grid_shape, torch.float32, torch.device("cpu"))
    assert len(held) == 3 and all(h is gc for h in held)  # the main block, two corrections
    assert _graph.hold(gc) is gc and len(held) == 4


def test_jit_changes_nothing_on_the_cpu():
    cfg = _cfg((6, 8, 10))
    kw = dict(contract="oz", g_stream="half", device="cpu")
    eager, pre = bt.make_ds_collision_operator(cfg, jit=False, **kw)
    jitted, _ = bt.make_ds_collision_operator(cfg, jit=True, **kw)
    f = _f(cfg)
    a, b = eager(f, pre), jitted(f, pre)
    assert torch.equal(a.hi, b.hi) and torch.equal(a.lo, b.lo)
