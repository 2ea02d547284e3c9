"""K5 (``csrc/gain_reduce.cu``) and K12 (``csrc/oz_hadamard_half.cu``) as they
are laid out on the card, checked on the CPU.

K5: the plan's mirror (``kernels.gain_reduce.plan``) deals every mode to one
thread and every node to one node block, and takes the split route exactly
where the mode tiles leave SMs idle and the grid can hold the node blocks; a
model of a thread's walk (the nodes' weights staged 1024 at a time, loads in
chunks of 8 nodes, 4 on the split route, across node-block boundaries, the
block sums kept or added in order) gives the plain version's bits on both
routes.

K12: the plan gives two blocks per SM where the grid allows; the pointer
table's slots are numbered alike in the wrapper and the source; a model of the
kernel's z-run walk (a thread's run of R z elements, float4/float2 runs and
ragged scalar tails, groups as the grid's y) on the raw memory of the
operands writes every output element once and gives the plain version's
bits, with and without a weight and a running sum; the wrapper hands the
kernel the default route's operands without a copy (a plane out of order
is copied and counted).
"""

import numpy as np
import pytest
import torch

import boltzfft_torch as bt
from boltzfft_torch import ds
from boltzfft_torch import ds_operator as dso
from boltzfft_torch.kernels import gain_reduce as k5
from boltzfft_torch.kernels import oz_hadamard as k12

LENGTH, B_GAMMA = 9.0, 1.0 / (4 * np.pi)
AHEAD = {0: 8, 1: 4}  # csrc/gain_reduce.cu: the nodes loaded ahead, by route
STAGE = 1024  # csrc/gain_reduce.cu kStage: the nodes whose weights a block stages at a time
H100_SMS = 132  # the SMs of the H100 SXM the plans were measured on

# ---- K5 ----------------------------------------------------------------------

# (B, M): the rfft + use_pallas route's one chunk at 32^3 and 64^3, Ns=12
# (M = N * N * (N/2 + 1)), and a small odd one
K5_SHAPES = [(192, 32 * 32 * 17), (384, 64 * 64 * 33), (24, 321)]


@pytest.mark.parametrize("b,m", K5_SHAPES)
@pytest.mark.parametrize("node_block", [1, 7, 8, 64])
def test_k5_plan_deals_every_mode_and_node_once(b, m, node_block):
    p = k5.plan(b, m, node_block, H100_SMS)
    tile = k5.THREADS * k5.MODES
    l0 = (np.arange(p.tiles * k5.THREADS) * k5.MODES)
    l0 = l0[l0 < m]
    modes = np.concatenate([l0, (l0 + 1)[l0 + 1 < m]])
    assert np.array_equal(np.sort(modes), np.arange(m))  # each mode once
    assert p.tiles * tile >= m > (p.tiles - 1) * tile
    ranges = [range(y * p.nb, (y + 1) * p.nb) for y in range(p.blocks)] if p.split \
        else [range(0, b)]
    nodes = np.concatenate([np.arange(r.start, r.stop) for r in ranges])
    assert np.array_equal(np.sort(nodes), np.arange(b))  # each node once
    assert p.nb * p.blocks == b and b % p.nb == 0
    # the split where the tiles alone leave SMs idle (and there are blocks)
    assert p.split == int(p.tiles < H100_SMS and 1 < p.blocks <= k5.MAX_SPLIT_BLOCKS)


def test_k5_plan_on_the_main_shapes():
    assert k5.plan(192, 32 * 32 * 17, 8, H100_SMS) == k5.Plan(8, 24, 68, 1)
    assert k5.plan(384, 64 * 64 * 33, 8, H100_SMS) == k5.Plan(8, 48, 528, 0)
    # the route follows the card: 68 tiles leave SMs idle on 114 too, 528 on none
    assert k5.plan(192, 32 * 32 * 17, 8, 114).split == 1
    assert k5.plan(384, 64 * 64 * 33, 8, 114).split == 0


@pytest.mark.parametrize("b,node_block,split", [
    (65535, 1, 1), (65536, 1, 0), (70000, 7, 1), (70000, 1, 0), (2 ** 20, 16, 0), (2 ** 20, 32, 1)])
def test_k5_plan_keeps_the_split_within_the_grid(b, node_block, split):
    """The split route's node blocks are the grid's y: at most 65535.  Above
    that the one launch takes the nodes, whatever their number (staged a
    ``STAGE`` at a time)."""
    p = k5.plan(b, 100, node_block, H100_SMS)
    assert p.split == split
    assert not p.split or p.blocks <= k5.MAX_SPLIT_BLOCKS


def _k5_walk(h, w, nb, split, stage=STAGE):
    """The kernel's arithmetic order for every mode at once: per thread the
    nodes of each stage of ``stage`` nodes in chunks of ``AHEAD[split]`` (its
    loads), a block sum started at each block's first node, added into the
    output at its last (one launch) or kept per block and added in block
    order by the second launch (split)."""
    b = h.shape[0]
    blocks = [(y * nb, (y + 1) * nb) for y in range(b // nb)] if split else [(0, b)]
    sums, out = [], torch.zeros_like(h[0])
    for b0, b1 in blocks:
        left = 0
        for st0 in range(b0, b1, stage):
            st1 = min(st0 + stage, b1)
            for c0 in range(st0, st1, AHEAD[split]):
                for k in range(min(AHEAD[split], st1 - c0)):
                    if left == 0:
                        s, left = torch.zeros_like(h[0]), nb
                    s = s + w[c0 + k] * h[c0 + k]
                    left -= 1
                    if left == 0 and not split:
                        out = out + s
        if split:
            sums.append(s)
    for s in sums:
        out = out + s
    return out


@pytest.mark.parametrize("node_block", [1, 3, 8, 24, 5])
@pytest.mark.parametrize("split", [0, 1])
@pytest.mark.parametrize("stage", [STAGE, 8])
def test_k5_walk_gives_the_plain_bits(node_block, split, stage):
    rng = np.random.default_rng(4)
    b, m = 24, 70
    h = torch.as_tensor(rng.standard_normal((b, m)) + 1j * rng.standard_normal((b, m)))
    rho = torch.as_tensor(rng.uniform(0.5, 10.0, b))
    gw = torch.as_tensor(rng.uniform(0.0, 1.0, b))
    nl = torch.as_tensor(rng.uniform(0.0, 30.0, m))
    kw = dict(length=LENGTH, b_gamma=B_GAMMA)
    ref = k5.gain_reduce_reference(h, rho, gw, nl, node_block=node_block, **kw)
    w = k5.node_weights(rho, gw, nl, dtype=torch.float64, **kw)
    nb = k5.plan(b, m, node_block, H100_SMS).nb
    assert torch.equal(_k5_walk(h, w, nb, split, stage), ref)


# ---- K12 ---------------------------------------------------------------------

@pytest.mark.parametrize("n_sm", [H100_SMS, 114])
def test_k12_plan_gives_two_blocks_per_sm(n_sm):
    assert k12.plan(32, 32, 32, 2, H100_SMS) == (2, 64)  # gb = 2 at 32^3
    assert k12.plan(64, 64, 64, 1, H100_SMS) == (4, 128)  # gb = 1 at 64^3
    least = k12.BLOCKS_PER_SM * n_sm
    for grid, groups in (((32, 32, 32), 2), ((64, 64, 64), 1), ((48, 48, 48), 1),
                         ((32, 32, 32), 1), ((6, 8, 10), 1)):
        run, threads = k12.plan(*grid, groups, n_sm)
        nx, ny, nz = grid
        blocks = -(-nx * ny * -(-nz // run) // threads) * groups
        most = -(-nx * ny * nz // 64) * groups  # the widest grid the plan can pick
        assert blocks >= least or (run, threads) == (1, 64) and most < least


def test_k12_table_slots_match_the_source():
    """The wrapper's ``SLOT_*`` numbers are the ``Slot`` enum of the source,
    which pins them to ``HPtrs``'s fields; ``_table`` fills the slots up to
    the output."""
    import re
    from pathlib import Path

    src = (Path(k12.__file__).parents[1] / "csrc" / "oz_hadamard_half.cu").read_text()
    enum = dict((k, int(v)) for k, v in re.findall(
        r"(k\w+) = (\d+)", re.search(r"enum Slot \{([^}]*)\}", src).group(1)))
    assert enum == {"kPlanes": k12.SLOT_PLANES, "kSigns": k12.SLOT_SIGNS, "kW": k12.SLOT_W,
                    "kAcc": k12.SLOT_ACC, "kOut": k12.SLOT_OUT, "kNumPtrs": k12.N_SLOTS}
    r, planes, signs, w, acc = _k12_inputs(2, (4, 4, 4), 1, True, 1, True)
    ops = k12._table(r[0], planes[0], r[1], planes[1], w, signs, acc)
    assert len(ops) == k12.SLOT_OUT
    assert ops[k12.SLOT_PLANES] is planes[0][0].re.hi
    assert ops[k12.SLOT_SIGNS:k12.SLOT_W] == list(signs)
    assert ops[k12.SLOT_W] is w.hi and ops[k12.SLOT_ACC + 1] is acc.lo


def _k12_walk(grid, run, threads):
    """Per element a thread of group 0 handles, in launch order: its offsets
    at node 0 in the main block (= the output's, within a group), px, py
    and pz, and its x, y, z indices, as ``hwh_kernel`` forms them."""
    nx, ny, nz = grid
    runs = -(-nz // run)
    per_group = nx * ny * runs
    t = np.arange(-(-per_group // threads) * threads)
    t = t[t < per_group]
    row = t // runs
    z0 = (t - row * runs) * run
    jx = row // ny
    jy = row - jx * ny
    n = np.minimum(run, nz - z0)
    cols = []
    for i in range(run):  # element i of each run, where the run has one
        ok = i < n
        r, z, x, y = row[ok], z0[ok] + i, jx[ok], jy[ok]
        cols.append(np.stack([r * nz + z, y * nz + z, x * nz + z, r, x, y, z]))
    return np.concatenate(cols, axis=1)


def _raw(t):
    """The storage of a float32 tensor from its first element on, flat."""
    off = t.storage_offset()
    return torch.as_strided(t, (t.untyped_storage().nbytes() // 4 - off,), (1,), off)


def _k12_inputs(c, grid, seed, weighted, groups, with_acc, transposed=False):
    """Seeded operands; ``transposed``: py and pz laid out as the ds eval
    hands them over, memory (C, Nz, Nx) and (C, Ny, Nx)."""
    nx, ny, nz = grid
    rng = np.random.default_rng(seed)

    def cds(s, flip=False):
        z = rng.standard_normal(s) + 1j * rng.standard_normal(s)
        if not flip:
            return ds.cds_from_f64(z, device="cpu")
        z = ds.cds_from_f64(np.ascontiguousarray(z.transpose(0, 2, 1)), device="cpu")
        return ds.tree_map(lambda a: a.transpose(1, 2), z)

    r = [ds.from_f64(rng.standard_normal((c, nx, ny, nz)), device="cpu") for _ in range(2)]
    planes = [(cds((c, ny, nz)), cds((c, nx, nz), transposed), cds((c, nx, ny), transposed))
              for _ in range(2)]
    signs = tuple(torch.as_tensor((-1.0) ** np.arange(k), dtype=torch.float32) for k in grid)
    w = ds.from_f64(rng.uniform(0.5, 1.5, c), device="cpu") if weighted else None
    oshape = ((groups,) if groups > 1 else ()) + grid
    acc = ds.from_f64(rng.standard_normal(oshape), device="cpu") if with_acc else None
    return r, planes, signs, w, acc


@pytest.mark.parametrize("grid", [(8, 8, 8), (6, 8, 10), (4, 6, 12)])
@pytest.mark.parametrize("run", [4, 2, 1])
@pytest.mark.parametrize("groups,weighted,with_acc,transposed", [
    (1, False, False, False), (1, False, True, True), (2, True, True, True),
    (3, False, True, False),
])
def test_k12_walk_matches_reference(grid, run, groups, weighted, with_acc, transposed):
    nx, ny, nz = grid
    n3 = nx * ny * nz
    c = 2 * groups
    r, planes, signs, w, acc = _k12_inputs(c, grid, 11, weighted, groups, with_acc, transposed)
    ref = k12.hadamard_wsum_half_reference(r[0], planes[0], r[1], planes[1], w, grid, signs,
                                           groups, acc)
    copies = k12.COPIES
    ops = k12._operands(k12._table(r[0], planes[0], r[1], planes[1], w, signs, acc), c, grid,
                        groups)
    # transposed py and pz (both streams, four components each) are copied
    assert k12.COPIES == copies + (16 if transposed else 0)
    flat = [None if t is None else _raw(t) for t in ops]
    e, ox, oy, oz, jx, jy, jz = (torch.from_numpy(a) for a in _k12_walk(grid, run, 64))
    ps = (ny * nz, 0, 0, nx * nz, 0, 0, nx * ny)  # node strides of px, py, pz
    assert np.array_equal(np.sort(e.numpy()), np.arange(n3))  # each output once a group
    sg = k12.SLOT_SIGNS
    sx, sy, sz = flat[sg][jx], flat[sg + 1][jy], flat[sg + 2][jz]
    got = [torch.empty(groups * n3), torch.empty(groups * n3)]
    ns_pg = c // groups
    for g in range(groups):
        s = None
        for j in range(g * ns_pg, (g + 1) * ns_pg):
            gre, gim = [], []
            for st in range(2):
                p = k12.SLOT_PLANES + 12 * st
                at = lambda k, off, node: flat[p + k][j * node + off]
                h = ds.DS(flat[2 * st][j * n3 + e], flat[2 * st + 1][j * n3 + e])
                h = ds.add(h, ds.DS(sx * at(0, ox, ps[0]), sx * at(1, ox, ps[0])))
                im = ds.DS(sx * at(2, ox, ps[0]), sx * at(3, ox, ps[0]))
                h = ds.add(h, ds.DS(sy * at(4, oy, ps[3]), sy * at(5, oy, ps[3])))
                im = ds.add(im, ds.DS(sy * at(6, oy, ps[3]), sy * at(7, oy, ps[3])))
                h = ds.add(h, ds.DS(sz * at(8, oz, ps[6]), sz * at(9, oz, ps[6])))
                im = ds.add(im, ds.DS(sz * at(10, oz, ps[6]), sz * at(11, oz, ps[6])))
                gre.append(h)
                gim.append(im)
            term = ds.add(ds.mul(gre[0], gre[1]), ds.neg(ds.mul(gim[0], gim[1])))
            if w is not None:
                term = ds.mul(term, ds.DS(flat[k12.SLOT_W][j], flat[k12.SLOT_W + 1][j]))
            s = term if s is None else ds.add(s, term)
        if acc is not None:
            at_acc = g * n3 + e
            s = ds.add(ds.DS(flat[k12.SLOT_ACC][at_acc], flat[k12.SLOT_ACC + 1][at_acc]), s)
        got[0][g * n3 + e], got[1][g * n3 + e] = s.hi, s.lo
    assert torch.equal(got[0].reshape(ref.hi.shape), ref.hi)
    assert torch.equal(got[1].reshape(ref.lo.shape), ref.lo)


def test_k12_plain_acc_is_the_callers_add():
    grid, groups = (6, 8, 10), 2
    r, planes, signs, w, acc = _k12_inputs(4, grid, 12, True, groups, True)
    args = (r[0], planes[0], r[1], planes[1], w, grid, signs)
    part = k12.hadamard_wsum_half(*args, groups=groups)
    got = k12.hadamard_wsum_half(*args, groups=groups, acc=acc)
    want = ds.add(acc, part)
    assert torch.equal(got.hi, want.hi) and torch.equal(got.lo, want.lo)
    copies = k12.COPIES
    ops = k12._operands(k12._table(*args[:5], signs, acc), 4, grid, groups)
    assert k12.COPIES == copies and all(a is b for a, b in zip(
        ops, k12._table(*args[:5], signs, acc)))  # nothing copied, nothing stacked
    mixed = (planes[0][0], ds.tree_map(lambda a: a.transpose(1, 2).contiguous().transpose(1, 2)
                                       if a is planes[0][1].re.hi else a, planes[0][1]),
             planes[0][2])
    k12._operands(k12._table(r[0], mixed, r[1], planes[1], w, signs, acc), 4, grid, groups)
    assert k12.COPIES == copies + 1  # the one tensor out of order
    with pytest.raises(ValueError, match=f"operand {k12.SLOT_ACC} has shape"):
        k12._operands(k12._table(*args[:5], signs, ds.tree_map(lambda a: a[0], acc)), 4, grid,
                      groups)


@pytest.mark.parametrize("group_batch,gmain", [(1, "12"), (2, "3")])
def test_k12_default_route_operands_need_no_copy(monkeypatch, group_batch, gmain):
    """The operands the ds eval hands K12 (the card's route, run on the CPU)
    pass the CUDA wrapper's checks without a copy; each call after a radial
    group's first sub-batch carries the running sum."""
    cfg = bt.CollisionConfig(nv=8, ns=6, n_radial=2, impl="c2c", dtype="float32")
    pre = dso.build_ds_precomp(cfg, device="cpu")
    fm = np.abs(np.random.default_rng(3).standard_normal(cfg.grid_shape)) + 0.1
    seen = []
    real = k12.hadamard_wsum_half

    def spy(r1, c1, r2, c2, w, grid_shape, signs, groups=1, acc=None):
        c = r1.hi.shape[0]
        ops = k12._table(r1, c1, r2, c2, w, signs, acc)
        copies = k12.COPIES
        k12._operands(ops, c, tuple(grid_shape), groups)
        seen.append((k12.COPIES - copies, acc is not None))
        return real(r1, c1, r2, c2, w, grid_shape, signs, groups, acc)

    monkeypatch.setattr(k12, "hadamard_wsum_half", spy)
    dso.collide_ds(cfg, pre, ds.from_f64(fm, device="cpu"), contract="oz", g_stream="half",
                   gmain_fused=gmain, group_batch=group_batch, sub_batch=2)
    assert seen and all(n == 0 for n, _ in seen)
    calls_per_group = -(-cfg.ns_eff // 2) if group_batch == 1 else 1  # sub_batch 2
    assert calls_per_group > 1 or group_batch > 1
    assert [a for _, a in seen] == [i % calls_per_group > 0 for i in range(len(seen))]
