"""K10 (``csrc/oz_gmain12.cu``) and K11 (``csrc/oz_hadamard.cu``) as they
are laid out on the card, checked on the CPU.

K10: the plan's mirror (``kernels.oz_gmain12.plan``) deals every (node, z
row, output column) of both stages to exactly one warp tile; every plan
fits in a block's shared memory.  A NumPy model of
the new warp tile's order (per k16 step and chunk i, every slice j; all
levels held at once; chunks and slices past the operands' zero) gives the
plain version's levels bit for bit at the edge of ``merge_ok`` and on
random chunks.

K11: a model of the kernel's two index walks (direct, V elements a thread;
transposing through a shared-memory tile), run on the raw memory of
contiguous, rolled and transposed streams, writes every output element once
and gives ``hadamard_wsum_reference``'s bits.
"""

import math

import numpy as np
import pytest
import torch

from boltzfft_torch import ds, oz
from boltzfft_torch.kernels import oz_contract as k8
from boltzfft_torch.kernels import oz_gmain12 as k10
from boltzfft_torch.kernels import oz_hadamard_full as k11

CMAX = 6
GRIDS = [(8, 8, 8), (6, 8, 10), (16, 16, 16), (32, 32, 32), (48, 48, 48), (64, 64, 64)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The models run many small products and elementwise passes, which
    torch's thread pool makes slower, and beside other test workers stalls:
    one thread while this module runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- K10: the plan ----------------------------------------------------------

def _deal(grid, c, p):
    """Counts of how often the kernel's warp tiles write each output of the
    two stages, (C, Nx, Nz/2, Ny) and (C, Ny, Nz/2, Nx), under plan ``p``."""
    nx, ny, nz = grid
    nzh, zb = nz // 2, p.zb
    counts = [np.zeros((c, nx, nzh, ny), np.int64), np.zeros((c, ny, nzh, nx), np.int64)]
    el_r = (np.arange(16)[:, None] + np.zeros(8, int)[None, :]).ravel()
    el_l = (np.zeros(16, int)[:, None] + np.arange(8)[None, :]).ravel()
    for st, (k, rows) in enumerate(((ny, nx * zb), (nx, ny * zb))):
        lg, tr = p.lg[st], p.tr[st]
        rr_all, cc_all = [], []
        for c0 in range(0, k, lg):
            lgr = min(lg, k - c0)
            nst = -(-lgr // 8)
            for row0 in range(0, rows, tr):
                nrows = min(tr, rows - row0)
                for wt in range(-(-nrows // 16) * nst):
                    m0, n0 = (wt // nst) * 16, (wt % nst) * 8
                    rr, ll = m0 + el_r, n0 + el_l
                    keep = (rr < nrows) & (ll < lgr)
                    rr_all.append(row0 + rr[keep])
                    cc_all.append(c0 + ll[keep])
        r, col = np.concatenate(rr_all), np.concatenate(cc_all)
        outer, dz = r // zb, r % zb  # (jx or jy, dz)
        for blk in range(nzh // zb):
            for node in range(c):
                np.add.at(counts[st], (node, outer, blk * zb + dz, col), 1)
    return counts


@pytest.mark.parametrize("grid", GRIDS)
def test_k10_plan_deals_every_output_once(grid):
    nx, ny, nz = grid
    nzh = nz // 2
    c = 2
    blocks = [d for d in range(1, nzh + 1) if nzh % d == 0 and k10.plan(nx, ny, nzh, c, zh_block=d).fits]
    rule = k10.plan(nx, ny, nzh, c)
    assert rule.zb in blocks
    for zb in blocks:
        p = k10.plan(nx, ny, nzh, c, zh_block=zb)
        for counts in _deal(grid, c, p):
            assert (counts == 1).all(), (grid, zb)


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("nsl", [7, 8])
def test_k10_plan_fits_shared_memory(grid, nsl):
    """Every plan the kernel takes fits in the 227 KB (232,448 bytes) a block
    may have: the intermediate, the slices, the chunks and the row maxima."""
    nx, ny, nz = grid
    nzh = nz // 2
    for c in (4, 24):
        for zb in [None] + [d for d in range(1, nzh + 1) if nzh % d == 0]:
            p = k10.plan(nx, ny, nzh, c, 7, nsl, zb)
            if zb is None:
                assert p.fits
            if not p.fits:
                continue
            assert p.smem <= 232448 == k10.SMEM_MAX
            inter = 16 * nx * ny * p.zb
            for st, k in enumerate((ny, nx)):
                kp = -(-k // 16) * 16
                lp = -(-p.lg[st] // 16) * 16
                stage = 2 * (2 * nsl * kp * (lp + 8) + 2 * 7 * p.tr[st] * (kp + 8)) + 4 * p.tr[st]
                assert inter + stage <= p.smem
                assert p.tr[st] % 16 == 0 and p.lg[st] % 8 in (0, k % 8)


def test_k10_rule_on_the_main_shapes():
    """The rule's z block at the routes' shapes: one z row a block at 32^3
    (24 nodes: 384 blocks) and 64^3 (4 nodes: 128; two rows do not fit
    beside the slices without cutting them in column groups)."""
    assert k10.plan(32, 32, 16, 24).zb == 1
    p = k10.plan(64, 64, 32, 4)
    assert (p.zb, p.lg, p.tr) == (1, (64, 64), (16, 16))
    assert k10.plan(64, 64, 32, 4, zh_block=2).lg == (16, 16)


def test_gmain_mode_takes_k10_above_the_envelope():
    """``ds_operator._gmain_mode`` on CUDA: K9 up to ~40^3, K10 above where
    the y and x stages merge and its plan keeps the slices whole, the staged
    chain where they do not merge; off CUDA the staged chain."""
    import types

    import boltzfft_torch as bt
    from boltzfft_torch.ds_operator import _gmain_mode

    pre = types.SimpleNamespace(pm1=(oz.CSlicedMatrix(torch.zeros(1, 8, 1, 1), None),))
    mode = lambda n, **kw: _gmain_mode(bt.CollisionConfig(nv=n, ns=6, n_radial=2), pre, 6, 7, **kw)
    assert [mode(n, device="cuda") for n in (16, 32, 40, 48, 64)] == ["3", "3", "3", "12", "12"]
    assert mode(80, device="cuda") is False  # merge_ok fails at K = 80
    assert mode(64, device="cpu") is False and mode(64) is False
    assert mode(64, forced=True) == "12" and mode(32, forced=True) == "3"


# ---- K10: the warp tile's order ----------------------------------------------

def _operands(x_pre, m, k):
    """(cr, ci, mre, mim) float64 of merged presliced chunks and node 0's slices."""
    full = x_pre.full.to(torch.float64).reshape(x_pre.full.shape[0], -1, 2, k)
    cr, ci = full[:, :, 0].permute(1, 0, 2), full[:, :, 1].permute(1, 0, 2)
    return cr.numpy(), ci.numpy(), m.re[0].to(torch.float64).numpy(), m.im[0].to(torch.float64).numpy()


def k10_levels(cr, ci, mre, mim, nlev):
    """The new warp tile's level sums in its order, as float32: per k16 step,
    per chunk i < 7, per slice j < NLEV - i, one exact step per list added
    in float32 to level i + j; chunks past sx and slices past sm are zero."""
    sx, rows, k = cr.shape
    sm, _, ell = mre.shape
    big = 7 if nlev <= 7 else 8
    nsl = min(sm, nlev)
    kp = -(-k // 16) * 16
    z = lambda a, n, ax: np.pad(a, [(0, n) if i == ax else (0, 0) for i in range(a.ndim)])
    cr, ci = (z(z(a, kp - k, 2), 7 - sx, 0) for a in (cr, ci))
    mre, mim = (z(z(a[:nsl], kp - k, 1), big - nsl, 0) for a in (mre, mim))
    acc = np.zeros((big, 2, rows, ell), np.float32)
    for kb in range(0, kp, 16):
        s = slice(kb, kb + 16)
        for i in range(7):
            for j in range(big - i):
                re = cr[i][:, s] @ mre[j][s] + ci[i][:, s] @ -mim[j][s]
                im = cr[i][:, s] @ mim[j][s] + ci[i][:, s] @ mre[j][s]
                for lst, step in enumerate((re, im)):
                    f = step.astype(np.float32)
                    assert np.array_equal(f.astype(np.float64), step)  # a step is exact
                    acc[i + j, lst] = acc[i + j, lst] + f
    n_fold = min(nlev, sx + sm - 1)
    return [[acc[d, lst] for d in range(n_fold)] for lst in range(2)]


def plain_merged(cr, ci, mre, mim, nlev):
    """The plain version's merged level lists (``contract_plain``): float64
    levels, re = cr.mre - ci.mim and im = cr.mim + ci.mre, to float32."""
    t = lambda a: [torch.from_numpy(np.ascontiguousarray(c))[None] for c in a]
    mat = lambda a: torch.from_numpy(np.ascontiguousarray(a))[None]
    n_fold = min(nlev, cr.shape[0] + mre.shape[0] - 1)
    lv = lambda x, m: k8.plain_levels(t(x), mat(m[:min(m.shape[0], nlev)]), n_fold)
    lists = [[a - b for a, b in zip(lv(cr, mre), lv(ci, mim))],
             [a + b for a, b in zip(lv(cr, mim), lv(ci, mre))]]
    return [[v[0].to(torch.float32).numpy() for v in lst] for lst in lists]


@pytest.mark.parametrize("im_list", [False, True])
def test_k10_order_is_exact_at_the_edge(im_list):
    """Every chunk and slice at 127 units, K = 64, sx = sm = 7, cmax = 6 (a
    merged level reaches 14.45 M of float32's 2^24 units): the new order's
    levels equal the plain version's bit for bit."""
    k = 64
    assert oz.merge_ok(k, sm=7, cmax=CMAX)
    _, m, x_pre = k8.edge_operands(k, 16, 16, 1, True, im_list=im_list)
    ops = _operands(x_pre, m, k)
    for g, w in zip(k10_levels(*ops, CMAX + 1), plain_merged(*ops, CMAX + 1)):
        for a, b in zip(g, w):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("k,sx,sm,cmax", [(64, 7, 8, 6), (40, 7, 8, 7), (24, 5, 8, 4), (32, 7, 3, 6)])
def test_k10_order_matches_plain_on_random_chunks(k, sx, sm, cmax):
    """Random chunks and slices of up to 128 units, both signs, at the kernel's
    two instances (7 levels; 8 at cmax = 7) and with chunks or slices fewer
    than the levels (zero-padded)."""
    rng = np.random.default_rng(k + sx + sm + cmax)
    rows, ell = 16, 8
    unit = lambda n: 2.0 ** (-7 * (np.arange(n) + 1))
    cr, ci = (rng.integers(-128, 129, (sx, rows, k)) * unit(sx)[:, None, None] for _ in range(2))
    mre, mim = (rng.integers(-128, 129, (sm, k, ell)) * unit(sm)[:, None, None] for _ in range(2))
    assert oz.merge_ok(k, sx=sx, sm=sm, cmax=cmax)
    for g, w in zip(k10_levels(cr, ci, mre, mim, cmax + 1), plain_merged(cr, ci, mre, mim, cmax + 1)):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert np.array_equal(a, b)


# ---- K11: the index walks -----------------------------------------------------

def _stream(shape, seed, layout):
    c, nx, ny, nz = shape
    rng = np.random.default_rng(seed)
    z = lambda s: rng.standard_normal(s) + 1j * rng.standard_normal(s)
    if layout == "contiguous":
        return ds.cds_from_f64(z(shape))
    if layout == "rolled":  # the x stage's view: memory (C, Ny, Nz, Nx)
        return ds._roll_axis(ds.cds_from_f64(z((c, ny, nz, nx))), -1, -3)
    raw = ds.cds_from_f64(z((c, nz, ny, nx)))  # memory (C, Nz, Ny, Nx)
    return ds.tree_map(lambda a: a.permute(0, 3, 2, 1), raw)


def _walk(dims, s1, s2, so, mode, width):
    """(offsets of stream 1, of stream 2, of the output) of node 0 for every
    element in the kernel's order: ``mode`` "direct" (``width`` = V
    consecutive elements a thread) or "transpose" (``width`` = EPT), as
    ``csrc/oz_hadamard.cu`` forms them."""
    d = dims
    if mode == "direct":
        n = math.prod(d)
        e0 = np.arange(0, n, width)
        i3, q = e0 % d[2], e0 // d[2]
        i2, i1 = q % d[1], q // d[1]
        o1, o2, oe = [], [], []
        for v in range(width):  # V > 1 only where axis 3 has unit strides
            j3 = i3 + v
            o1.append(i1 * s1[1] + i2 * s1[2] + j3 * s1[3])
            o2.append(i1 * s2[1] + i2 * s2[2] + j3 * s2[3])
            oe.append(i1 * so[0] + i2 * so[1] + j3 * so[2])
        return (np.concatenate(o1), np.concatenate(o2), np.concatenate(oe))
    ax = max(i for i in range(3) if so[i] == 1 and d[i] > 1)
    b = 1 - ax
    ty_n = 4 * width
    o1, o2, oe = [], [], []
    for bz in range(d[b]):
        for by in range(-(-d[ax] // ty_n)):
            for bx in range(-(-d[2] // 32)):
                x0, y0 = bx * 32, by * ty_n
                # the compute side: thread (tx, ty), k -> tile[ty + 4k][tx]
                tile = {}
                for t in range(128):
                    tx, ty = t % 32, t // 32
                    for k in range(width):
                        ix, iy = x0 + tx, y0 + ty + 4 * k
                        if ix < d[2] and iy < d[ax]:
                            tile[(ty + 4 * k, tx)] = (bz * s1[1 + b] + iy * s1[1 + ax] + ix * s1[3],
                                                      bz * s2[1 + b] + iy * s2[1 + ax] + ix * s2[3])
                # the write side
                for idx in range(32 * ty_n):
                    yl, xl = idx % ty_n, idx // ty_n
                    iy, jx = y0 + yl, x0 + xl
                    if jx < d[2] and iy < d[ax]:
                        a1, a2 = tile[(yl, xl)]
                        o1.append(a1)
                        o2.append(a2)
                        oe.append(bz * so[b] + iy * so[ax] + jx * so[2])
    return np.array(o1), np.array(o2), np.array(oe)


def _raw(t):
    """The whole storage of a float32 view, from its storage offset 0."""
    n = t.untyped_storage().nbytes() // 4
    return torch.as_strided(t, (n,), (1,), 0)


@pytest.mark.parametrize("layout", ["contiguous", "rolled", "transposed"])
@pytest.mark.parametrize("weighted", [False, True])
def test_k11_index_walk_matches_reference(layout, weighted):
    c, grid = 3, (8, 4, 12)
    g1, g2 = _stream((c,) + grid, 1, layout), _stream((c,) + grid, 2, layout)
    w = ds.from_f64(np.random.default_rng(3).uniform(0.5, 1.5, c)) if weighted else None
    planes1 = (g1.re.hi, g1.re.lo, g1.im.hi, g1.im.lo)
    planes2 = (g2.re.hi, g2.re.lo, g2.im.hi, g2.im.lo)
    dims, s1, s2, so = k11._layout(tuple(g1.re.hi.shape), tuple(t.stride() for t in planes1),
                                   tuple(t.stride() for t in planes2))
    ref = k11.hadamard_wsum_reference(g1, g2, w)
    out_ax = max([i for i in range(3) if so[i] == 1 and dims[i] > 1] or [2])
    walks = [("direct", v) for v in (1, 2, 4)
             if v == 1 or (s1[3] == s2[3] == so[2] == 1 and dims[2] % v == 0)]
    if out_ax != 2 and s1[3] == 1:
        walks += [("transpose", e) for e in (1, 2, 4, 8)]
    assert walks[-1][0] == ("direct" if layout == "contiguous" else "transpose")
    n = math.prod(dims)
    for mode, width in walks:
        o1, o2, oe = _walk(dims, s1, s2, so, mode, width)
        assert np.array_equal(np.sort(oe), np.arange(n))  # each output once
        s = None
        for j in range(c):
            pick = lambda planes, o, st: [_raw(t)[torch.from_numpy(o + j * st[0])]
                                          for t in planes]
            a, b = pick(planes1, o1, s1), pick(planes2, o2, s2)
            term = ds.cmul(ds.CDS(ds.DS(a[0], a[1]), ds.DS(a[2], a[3])),
                           ds.CDS(ds.DS(b[0], b[1]), ds.DS(b[2], b[3])))
            if w is not None:
                term = ds.cmul_ds(term, ds.DS(w.hi[j], w.lo[j]))
            s = term if s is None else ds.cadd(s, term)
        for got, want in zip((s.re.hi, s.re.lo, s.im.hi, s.im.lo),
                             (ref.re.hi, ref.re.lo, ref.im.hi, ref.im.lo)):
            flat = torch.empty(n, dtype=torch.float32)
            flat[torch.from_numpy(oe)] = got
            assert torch.equal(flat.reshape(want.shape), want), (layout, mode, width)
