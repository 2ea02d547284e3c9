"""The tensor-core tile of K8 (``boltzfft_torch/csrc/oz_common.cuh``
``oz_tile``) and K9's cluster partition, checked on the CPU.

The tile forms each level of the sliced contraction from tensor-core steps,
level by level: for level ``d``, chunk ``i`` (slice ``j = d - i``) and k16
block one ``m16n8k16`` product into a zeroed float32 fragment (merged: the
two products of a list chained, the second against the negated slice), then
a float32 add into the level.  ``tc_levels`` below is a NumPy model of that
order.  Every step sum is exact (at most 32 products of at most 2^14 units),
so the model must give the plain version's float64 levels (``plain_levels``,
rounded to float32 as ``contract_plain`` does) bit for bit wherever
``oz.merge_ok`` / ``oz.unmerged_ok`` hold: at their edge too, on the
operands the chip run uses (``edge_operands``).  Past the edge
``check_exact`` refuses, and the float32 adds do round there.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from boltzfft_torch import oz
from boltzfft_torch.kernels import oz_contract as k8
from boltzfft_torch.kernels import oz_gmain as k9

CSRC = Path(__file__).resolve().parents[1] / "boltzfft_torch" / "csrc"
CMAX = 6
NLEV = CMAX + 1


def tc_levels(cr, ci, mre, mim, merged, nlev=NLEV):
    """The tile's level lists in its order, as float32: ``cr``, ``ci``
    ``(sx, R, K)`` and ``mre``, ``mim`` ``(sm, K, L)`` float64 chunk values.
    Merged: ``[re, im]`` with re = cr.mre - ci.mim, im = cr.mim + ci.mre;
    unmerged: ``[rr, ii, ri, ir]``."""
    sx, rows, k = cr.shape
    sm, _, ell = mre.shape
    kp = -(-k // 16) * 16
    pad = lambda a, ax: np.pad(a, [(0, kp - k) if i == ax else (0, 0) for i in range(a.ndim)])
    cr, ci, mre, mim = pad(cr, 2), pad(ci, 2), pad(mre, 1), pad(mim, 1)
    terms = ([[(cr, mre), (ci, -mim)], [(cr, mim), (ci, mre)]] if merged
             else [[(cr, mre)], [(ci, mim)], [(cr, mim)], [(ci, mre)]])
    nsl = min(sm, nlev)
    out = []
    for lst in terms:
        levels = []
        for d in range(min(nlev, sx + sm - 1)):
            acc = np.zeros((rows, ell), np.float32)
            for i in range(min(d, sx - 1) + 1):
                j = d - i
                if j >= nsl:
                    continue
                for kb in range(0, kp, 16):
                    s = slice(kb, kb + 16)
                    # one zeroed fragment: the (chained) products of this step,
                    # exact in float64, and exact in float32 (< 2^19 units)
                    step = sum(x[i][:, s] @ m[j][s] for x, m in lst)
                    f = step.astype(np.float32)
                    assert np.array_equal(f.astype(np.float64), step)
                    acc = acc + f  # float32 add
            levels.append(acc)
        out.append(levels)
    return out


def plain_lists(cr, ci, mre, mim, merged, nlev=NLEV):
    """The plain version's level lists (``contract_plain``): float64 levels
    of each component pair, merged as re*re - im*im and re*im + im*re,
    rounded to float32."""
    t = lambda a: [torch.from_numpy(np.ascontiguousarray(c))[None] for c in a]
    mat = lambda a: torch.from_numpy(np.ascontiguousarray(a))[None]
    n_fold = min(nlev, cr.shape[0] + mre.shape[0] - 1)
    lv = lambda x, m: k8.plain_levels(t(x), mat(m), n_fold)
    if merged:
        lists = [[a - b for a, b in zip(lv(cr, mre), lv(ci, mim))],
                 [a + b for a, b in zip(lv(cr, mim), lv(ci, mre))]]
    else:
        lists = [lv(cr, mre), lv(ci, mim), lv(cr, mim), lv(ci, mre)]
    return [[v[0].to(torch.float32).numpy() for v in lst] for lst in lists]


def exact_lists(cr, ci, mre, mim, merged, nlev=NLEV):
    """The same levels unrounded (float64), to see where float32 rounds."""
    t = lambda a: [torch.from_numpy(np.ascontiguousarray(c))[None] for c in a]
    mat = lambda a: torch.from_numpy(np.ascontiguousarray(a))[None]
    n_fold = min(nlev, cr.shape[0] + mre.shape[0] - 1)
    lv = lambda x, m: [v[0].numpy() for v in k8.plain_levels(t(x), mat(m), n_fold)]
    if merged:
        return [[a - b for a, b in zip(lv(cr, mre), lv(ci, mim))],
                [a + b for a, b in zip(lv(cr, mim), lv(ci, mre))]]
    return [lv(cr, mre), lv(ci, mim), lv(cr, mim), lv(ci, mre)]


def _operands(x_pre, m, merged, k):
    """(cr, ci, mre, mim) float64 of ``edge_operands``' presliced chunks and
    node 0's slices."""
    if merged:
        full = x_pre.full.to(torch.float64).reshape(x_pre.full.shape[0], -1, 2, k)
        cr, ci = full[:, :, 0].permute(1, 0, 2), full[:, :, 1].permute(1, 0, 2)
    else:
        sx = x_pre.all_re.shape[1] // k
        cr, ci = (a.to(torch.float64).reshape(-1, sx, k).permute(1, 0, 2)
                  for a in (x_pre.all_re, x_pre.all_im))
    return cr.numpy(), ci.numpy(), m.re[0].to(torch.float64).numpy(), m.im[0].to(torch.float64).numpy()


@pytest.mark.parametrize("merged", [True, False])
@pytest.mark.parametrize("im_list", [False, True])
def test_tc_order_is_exact_at_the_edge(merged, im_list):
    """Every chunk and slice at 127 units, K = 64, sx = sm = 7, cmax = 6:
    a merged level reaches 7 * 128 * 127^2 = 14.45 M of the 2^24 units."""
    k = 64
    assert (oz.merge_ok if merged else oz.unmerged_ok)(k, sm=7, cmax=CMAX)
    k8.check_exact(k, 7, CMAX, oz.DEFAULT_W, merged)
    x, m, x_pre = k8.edge_operands(k, 24, 16, 1, merged, im_list=im_list)
    ops = _operands(x_pre, m, merged, k)
    got, want = tc_levels(*ops, merged), plain_lists(*ops, merged)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert np.array_equal(a, b)
    big = max(np.abs(lst[6]).max() for lst in exact_lists(*ops, merged))
    unit6 = 2.0 ** (-7 * (6 + 2))  # the unit of level 6
    assert big / unit6 == (2 if merged else 1) * k * 7 * 127 * 127  # the extreme list is there


@pytest.mark.parametrize("merged,k", [(True, 64), (False, 64), (True, 24), (False, 40)])
def test_tc_order_matches_plain_on_random_chunks(merged, k):
    """Random chunks and slices of up to 128 units, both signs."""
    rng = np.random.default_rng(k + merged)
    sx, sm, rows, ell = 7, 8, 20, 12
    unit = lambda n: 2.0 ** (-7 * (np.arange(n) + 1))
    cr, ci = (rng.integers(-128, 129, (sx, rows, k)) * unit(sx)[:, None, None] for _ in range(2))
    mre, mim = (rng.integers(-128, 129, (sm, k, ell)) * unit(sm)[:, None, None] for _ in range(2))
    for g, w in zip(tc_levels(cr, ci, mre, mim, merged), plain_lists(cr, ci, mre, mim, merged)):
        for a, b in zip(g, w):
            assert np.array_equal(a, b)


def test_past_the_edge_is_refused_and_would_round():
    """K = 80 merged: 2 * 80 * 7 * 2^14 > 2^24.  ``check_exact`` refuses, and
    the float32 adds of the model do lose bits there (odd step sums past
    2^24 units)."""
    k = 80
    assert not oz.merge_ok(k, sm=7, cmax=CMAX)
    with pytest.raises(ValueError):
        k8.check_exact(k, 7, CMAX, oz.DEFAULT_W, True)
    x, m, x_pre = k8.edge_operands(k, 8, 16, 1, True)
    with pytest.raises(ValueError):
        k8.contract_last_oz_nodemat(x, m, cmax=CMAX, repeat=True, x_pre=x_pre, merged=True)
    cr, ci, mre, mim = _operands(x_pre, m, True, k)
    cr[:, :, 0] *= 126 / 127  # odd step sums
    got, want = tc_levels(cr, ci, mre, mim, True), exact_lists(cr, ci, mre, mim, True)
    assert not np.array_equal(got[0][6].astype(np.float64), want[0][6])


def _source_int(path, name):
    m = re.search(rf"constexpr int {name} = (\d+);", path.read_text())
    assert m, f"{name} not found in {path.name}"
    return int(m.group(1))


def test_tile_and_cluster_constants_mirror_the_sources():
    assert k8.TILE_WARPS == _source_int(CSRC / "oz_common.cuh", "OZ_WARPS")
    assert k9.CLUSTER == _source_int(CSRC / "oz_gmain3.cu", "kCluster")
    m = re.search(r"constexpr size_t OZ_SMEM_MAX = (\d+);", (CSRC / "oz_common.cuh").read_text())
    assert m and int(m.group(1)) == k8.SMEM_MAX
    # every warp on one 16 x 16 output tile of a full tile, up to L = 128
    for ell in (6, 8, 10, 16, 32, 48, 64, 128):
        nt = -(-ell // 16)
        assert k8.tile_rows(ell) % 16 == 0
        assert (k8.tile_rows(ell) // 16) * nt <= k8.TILE_WARPS
    assert (k8.tile_rows(32), k8.tile_rows(64), k8.tile_rows(16)) == (64, 32, 128)


@pytest.mark.parametrize("k,ell,rows,extra,want", [
    (64, 64, 8192, 0, (64, 32)),       # 64^3 y stage: slices 126 KB, a 32-row tile
    (32, 64, 16384, 0, (64, 32)),      # 64^3 half-z
    (32, 32, 12288, 0, (32, 64)),      # 32^3 stages
    (64, 64, 64, 65536, (64, 16)),     # K10 at 64^3 beside its 64 KB intermediate
    (128, 128, 1024, 0, (32, 16)),     # K = L = 128: four column groups of 32
])
def test_tile_plan(k, ell, rows, extra, want):
    lg, tr = k8.plan(k, ell, 7, 7, rows, extra)
    assert (lg, tr) == want
    assert extra + k8.tile_smem_bytes(k, lg, 7, tr, 7) <= k8.SMEM_MAX


@pytest.mark.parametrize("grid", [(8, 8, 8), (6, 8, 10), (32, 32, 32), (64, 64, 64)])
def test_k9_cluster_partition_covers_every_row_once(grid):
    nx, ny, nz = grid
    nzh = nz // 2
    part = k9.cluster_partition(grid)
    stages = ((ny, ny, nx * nzh), (nx, nx, ny * nzh), (nz // 2, nz, nx * ny))
    for (k, ell, rows), ranks in zip(stages, part):
        assert len(ranks) == k9.CLUSTER
        tr = k8.plan(k, ell, 7, 7, rows)[1]
        seen = []
        for tiles in ranks:
            for row0, nrows in tiles:
                assert row0 % tr == 0 and 1 <= nrows <= tr
                seen += range(row0, row0 + nrows)
        assert sorted(seen) == list(range(rows))


def test_k9_fills_the_card_at_32():
    """At 32^3 Ns=12 the default route hands K9 24 nodes (2 streams x gb 2 x
    6): 24 clusters of CLUSTER CTAs, at least the H100's 132 SMs."""
    assert 24 * k9.CLUSTER >= 132
