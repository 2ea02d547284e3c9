"""The ds engine's CUDA kernels (K7 ``preslice_rows``, K8 the two contraction
entries and its phased mode, K9 ``gmain3_nodemat``, K10 ``gmain12_nodemat``
at every z block, K11 ``hadamard_wsum``, K12 ``hadamard_wsum_half``) against
their plain PyTorch versions on a card, at small shapes: every result must be
bitwise equal to the plain version's and to itself run to run.  Then
``collide_ds`` on the card's default route, and on the full, phased and
"12" routes, against the same route on the CPU (plain versions) and against
the vpu engine.

No test here imports jax, so the file also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_ds_cuda.py -m cuda

Without a card every test skips.
"""

import numpy as np
import pytest
import torch

import boltzfft_torch as bt
from boltzfft_torch import ds, oz
from boltzfft_torch.ds_operator import build_ds_precomp, collide_ds
from boltzfft_torch.kernels import oz_contract as k8
from boltzfft_torch.kernels import oz_gmain as k9
from boltzfft_torch.kernels import oz_gmain12 as k10
from boltzfft_torch.kernels import oz_hadamard as k12
from boltzfft_torch.kernels import oz_hadamard_full as k11
from boltzfft_torch.kernels import oz_preslice as k7

GRIDS = [(8, 8, 8), (6, 8, 10)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _cds(shape, seed, device, scale=1.0):
    rng = np.random.default_rng(seed)
    z = scale * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
    return ds.cds_from_f64(z, torch.float32, device)


def _same(a, b):
    """Bitwise equality of two (trees of) float tensors, on any devices."""
    if isinstance(a, tuple):
        return all(_same(x, y) for x, y in zip(a, b))
    return torch.equal(a.cpu(), b.cpu())


def _to(x, device):
    return ds.tree_map(lambda a: a.to(device) if isinstance(a, torch.Tensor) else a, x)


def _cfg(grid):
    return bt.CollisionConfig(nv=grid[0], nvy=grid[1], nvz=grid[2], ns=6, n_radial=2,
                              impl="c2c", dtype="float32")


@pytest.mark.cuda
@pytest.mark.parametrize("merged", [False, True])
def test_k7_matches_plain(cuda_device, merged):
    x = _cds((8, 5, 24), 1, cuda_device)
    a = k7.preslice_rows(x, cmax=6, merged=merged)
    b = k7.preslice_rows(x, cmax=6, merged=merged)
    ref = k7.preslice_rows_reference(_to(x, "cpu"), cmax=6, merged=merged)
    torch.cuda.synchronize()
    assert _same(a, ref) and _same(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["plain", "real_in", "real_out", "cmax4", "fold_tail"])
def test_k8_shared_matches_plain(cuda_device, mode):
    x = _cds((3, 7, 10), 2, cuda_device)
    m = oz.slice_matrix(np.exp(2j * np.pi * np.random.default_rng(3).random((10, 12))),
                        device=cuda_device)
    kw = dict(cmax=4 if mode == "cmax4" else 6, real_in=mode == "real_in",
              real_out=mode == "real_out", fold_tail=4 if mode == "fold_tail" else None)
    a = k8.contract_last_oz_kernel(x, m, **kw)
    b = k8.contract_last_oz_kernel(x, m, **kw)
    ref = k8.contract_last_oz_kernel(_to(x, "cpu"), _to(m, "cpu"), **kw)
    torch.cuda.synchronize()
    assert _same(a, ref) and _same(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("repeat,x_pre,merged,real_out", [
    (True, False, False, False), (True, True, False, False), (True, True, True, False),
    (True, False, True, False), (False, False, True, False), (False, False, False, True),
    (False, False, True, True),
])
def test_k8_nodemat_matches_plain(cuda_device, repeat, x_pre, merged, real_out):
    c, k, ell = 3, 8, 10
    rng = np.random.default_rng(4)
    m = oz.slice_matrix_nodes(rng.standard_normal((c, k, ell)) + 1j * rng.standard_normal((c, k, ell)),
                              device=cuda_device)
    x = _cds((5, 6, k) if repeat else (c, 6, k), 5, cuda_device)
    kw = dict(cmax=6, repeat=repeat, merged=merged, real_out=real_out)
    pre = k7.preslice_rows(x, cmax=6, merged=merged) if x_pre else None
    pre_cpu = k7.preslice_rows_reference(_to(x, "cpu"), cmax=6, merged=merged) if x_pre else None
    a = k8.contract_last_oz_nodemat(x, m, x_pre=pre, **kw)
    b = k8.contract_last_oz_nodemat(x, m, x_pre=pre, **kw)
    ref = k8.contract_last_oz_nodemat(_to(x, "cpu"), _to(m, "cpu"), x_pre=pre_cpu, **kw)
    torch.cuda.synchronize()
    assert _same(a, ref) and _same(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("im_list", [False, True])
@pytest.mark.parametrize("real_out", [False, True])
@pytest.mark.parametrize("merged", [True, False])
def test_k8_edge_operands_match_plain(cuda_device, merged, real_out, im_list):
    """The tensor-core tile at the edge of exactness: every chunk and slice
    at 127 units, K = 64, sx = sm = 7, cmax = 6 (a merged level sums 14.45 M
    of the 2^24 units of float32)."""
    x, m, x_pre = k8.edge_operands(64, 64, 40, 2, merged, im_list=im_list, device=cuda_device)
    kw = dict(cmax=6, repeat=True, x_pre=x_pre, merged=merged, real_out=real_out)
    a = k8.contract_last_oz_nodemat(x, m, **kw)
    b = k8.contract_last_oz_nodemat(x, m, **kw)
    ref = k8.contract_last_oz_nodemat(_to(x, "cpu"), _to(m, "cpu"), **{**kw, "x_pre": _to(x_pre, "cpu")})
    torch.cuda.synchronize()
    assert _same(a, ref) and _same(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("grid", GRIDS + [(32, 32, 32)])
def test_k9_matches_plain_and_k8_chain(cuda_device, grid):
    from boltzfft_torch.ds_operator import _g_main_half

    nx, ny, nz = grid
    cfg = _cfg(grid)
    pre = build_ds_precomp(cfg, device=cuda_device)
    fhs = _cds((nx, nz // 2, ny), 6, cuda_device)
    x_pre = k7.preslice_rows(fhs, cmax=6, merged=True)
    first = lambda m: ds.tree_map(lambda a: a[0], m)  # radial group 0: (ns, sm, K, L)
    mats = (first(pre.pm1[1]), first(pre.pm1[0]), first(pre.pmz_half1w))
    a = k9.gmain3_nodemat(x_pre, *mats, grid, cmax=6)
    b = k9.gmain3_nodemat(x_pre, *mats, grid, cmax=6)
    chain = _g_main_half(fhs, x_pre, *mats, 6, 7, None, merged=True, grid_shape=grid)
    ref = k9.gmain3_reference(_to(x_pre, "cpu"), *(_to(m, "cpu") for m in mats), grid, cmax=6)
    torch.cuda.synchronize()
    assert _same(a, ref) and _same(a, b) and _same(a, chain)


@pytest.mark.cuda
@pytest.mark.parametrize("groups,weighted", [(1, False), (2, False), (1, True), (2, True)])
def test_k12_matches_plain(cuda_device, groups, weighted):
    nx, ny, nz = 6, 8, 10
    c = 2 * groups
    rng = np.random.default_rng(7)
    r = [ds.from_f64(rng.standard_normal((c, nx, ny, nz)), torch.float32, cuda_device)
         for _ in range(2)]
    planes = [tuple(_cds((c,) + s, 8 + 3 * i + j, cuda_device)
                    for j, s in enumerate(((ny, nz), (nx, nz), (nx, ny)))) for i in range(2)]
    signs = tuple(torch.as_tensor((-1.0) ** np.arange(n), dtype=torch.float32, device=cuda_device)
                  for n in (nx, ny, nz))
    w = ds.from_f64(rng.uniform(0.5, 1.5, c), torch.float32, cuda_device) if weighted else None
    args = (r[0], planes[0], r[1], planes[1], w, (nx, ny, nz), signs)
    a = k12.hadamard_wsum_half(*args, groups=groups)
    b = k12.hadamard_wsum_half(*args, groups=groups)
    ref = k12.hadamard_wsum_half(*_to(args, "cpu"), groups=groups)
    torch.cuda.synchronize()
    assert _same(a, ref) and _same(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("grid", GRIDS)
def test_collide_ds_default_route_on_card(cuda_device, grid):
    cfg = _cfg(grid)
    rng = np.random.default_rng(12345)
    fm = np.abs(rng.standard_normal(cfg.grid_shape)) + 0.1
    pre = build_ds_precomp(cfg, device=cuda_device)
    pre_cpu = build_ds_precomp(cfg, device="cpu")
    counts0 = [k.LAUNCHES for k in (k7, k8, k9, k12)]
    q = collide_ds(cfg, pre, ds.from_f64(fm, torch.float32, cuda_device), contract="oz")
    torch.cuda.synchronize()
    launched = [k.LAUNCHES - c0 for k, c0 in zip((k7, k8, k9, k12), counts0)]
    assert all(n > 0 for n in launched), launched
    # the same route on the CPU: the card's defaults named explicitly
    q_cpu = collide_ds(cfg, pre_cpu, ds.from_f64(fm), contract="oz", g_stream="half",
                       gmain_fused="3", group_batch=2, herm_downstream=True)
    q_vpu = collide_ds(cfg, pre, ds.from_f64(fm, torch.float32, cuda_device), contract="vpu")
    assert _same(q, q_cpu)
    a, v = ds.to_f64(q), ds.to_f64(q_vpu)
    assert np.abs(a - v).max() <= 1e-12 * np.abs(v).max()


@pytest.mark.cuda
def test_unported_modes_raise_on_card(cuda_device):
    """The routes that raised before K10, K11 and K8's phased mode run on the
    card: the full streams, the phased route and "12", each bitwise equal to
    the same route on the CPU (plain versions), and "12" to the staged one."""
    cfg = _cfg((8, 8, 8))
    pre = build_ds_precomp(cfg, device=cuda_device)
    pre0 = build_ds_precomp(cfg, node_mats=False, device=cuda_device)
    fm = np.abs(np.random.default_rng(5).standard_normal(cfg.grid_shape)) + 0.1
    f = ds.from_f64(fm, torch.float32, cuda_device)
    cpu = lambda p: build_ds_precomp(cfg, node_mats=p is pre, device="cpu")
    for tables, kw in ((pre, dict(g_stream="full")), (pre0, {}),
                       (pre, dict(g_stream="half", gmain_fused="12"))):
        q = collide_ds(cfg, tables, f, contract="oz", **kw)
        ref = collide_ds(cfg, cpu(tables), ds.from_f64(fm), contract="oz", **kw)
        torch.cuda.synchronize()
        assert _same(q, ref), kw
    staged = collide_ds(cfg, pre, f, contract="oz", g_stream="half", gmain_fused=False)
    assert _same(q, staged)
    x = _cds((4, 8), 1, cuda_device)
    ph = _cds((4, 8), 2, cuda_device)
    a = k8.contract_last_oz_kernel(x, pre.vinv_sl, phase=ph)
    ref = k8.contract_last_oz_kernel(_to(x, "cpu"), _to(pre.vinv_sl, "cpu"), phase=_to(ph, "cpu"))
    torch.cuda.synchronize()
    assert _same(a, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("repeat", [True, False])
@pytest.mark.parametrize("conj", [False, True])
@pytest.mark.parametrize("grid", GRIDS)
def test_k8_phased_matches_plain(cuda_device, grid, repeat, conj):
    """The phased 3-D transform's three stages (z with a shared x, y and x
    per node) and one stage alone, on the card's kernel and the plain
    version."""
    c = 3
    mats = tuple(oz.slice_matrix(np.exp(2j * np.pi * np.random.default_rng(n).random((n, n))),
                                 device=cuda_device) for n in grid)
    phases = tuple(_cds((c, n), 10 + n, cuda_device) for n in grid)
    x = _cds(grid if repeat else (c,) + grid, 9, cuda_device)
    if repeat:
        a = oz.transform3_oz_phased(x, mats, phases, conj=conj)
        b = oz.transform3_oz_phased(x, mats, phases, conj=conj)
        ref = oz.transform3_oz_phased(_to(x, "cpu"), _to(mats, "cpu"), _to(phases, "cpu"),
                                      conj=conj)
    else:
        kw = dict(phase=phases[2], conj=conj)
        a = k8.contract_last_oz_kernel(x, mats[2], **kw)
        b = k8.contract_last_oz_kernel(x, mats[2], **kw)
        ref = k8.contract_last_oz_kernel_reference(x, mats[2], **kw)
    torch.cuda.synchronize()
    assert _same(a, ref) and _same(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("grid", GRIDS + [(16, 16, 16), (32, 32, 32), (48, 48, 48), (64, 64, 64)])
def test_k10_matches_plain_every_zh_block(cuda_device, grid):
    """K10 at every z block whose plan fits (the rule's too), against the
    plain version and the staged K8 chain; node by node equal to the batch,
    and the same bits run to run."""
    from boltzfft_torch.ds_operator import _g_main_half

    nx, ny, nz = grid
    nzh = nz // 2
    cfg = _cfg(grid)
    pre = build_ds_precomp(cfg, device=cuda_device)
    fhs = _cds((nx, nzh, ny), 6, cuda_device)
    x_pre = k7.preslice_rows(fhs, cmax=6, merged=True)
    first = lambda m: ds.tree_map(lambda a: a[0], m)
    m_y, m_x = first(pre.pm1[1]), first(pre.pm1[0])
    c, sm = m_y.re.shape[0], m_y.re.shape[-3]
    ref = k10.gmain12_reference(_to(x_pre, "cpu"), _to(m_y, "cpu"), _to(m_x, "cpu"), grid, cmax=6)
    blocks = [zb for zb in range(1, nzh + 1)
              if nzh % zb == 0 and k10.plan(nx, ny, nzh, c, 7, min(sm, 7), zb).fits]
    assert k10.plan(nx, ny, nzh, c, 7, min(sm, 7)).zb in blocks
    outs = [k10.gmain12_nodemat(x_pre, m_y, m_x, grid, cmax=6, zh_block=zb) for zb in blocks]
    again = k10.gmain12_nodemat(x_pre, m_y, m_x, grid, cmax=6)
    node = lambda m, j: ds.tree_map(lambda a: a[j:j + 1], m)
    items = [k10.gmain12_nodemat(x_pre, node(m_y, j), node(m_x, j), grid, cmax=6) for j in range(c)]
    chain = _g_main_half(fhs, x_pre, m_y, m_x, first(pre.pmz_half1w), 6, 7, None, merged=True,
                         grid_shape=grid, fused=False)
    via12 = _g_main_half(fhs, x_pre, m_y, m_x, first(pre.pmz_half1w), 6, 7, None, merged=True,
                         grid_shape=grid, fused="12")
    torch.cuda.synchronize()
    assert all(_same(o, ref) for o in outs) and _same(again, ref)
    assert all(_same(it, ds.tree_map(lambda a: a[j:j + 1], again)) for j, it in enumerate(items))
    assert _same(via12, chain)


@pytest.mark.cuda
@pytest.mark.parametrize("cmax,fold_tail,nslices", [
    (6, 4, 8), (4, None, 8), (7, None, 8), (7, 3, 8), (6, None, 4), (5, 2, 3),
])
@pytest.mark.parametrize("grid", GRIDS + [(32, 32, 32)])
def test_k10_matches_plain_every_level_count(cuda_device, grid, cmax, fold_tail, nslices):
    """K10's other instances and branches: 8 levels (cmax = 7), fewer chunks
    than levels (cmax < 6), fewer matrix slices than levels (zero slices in
    shared memory) and a fold tail, against the plain version."""
    nx, ny, nz = grid
    nzh = nz // 2
    rng = np.random.default_rng(cmax + 10 * nslices)
    fhs = _cds((nx, nzh, ny), 6, cuda_device)
    x_pre = k7.preslice_rows(fhs, cmax=cmax, merged=True)
    mats = [oz.slice_matrix_nodes(rng.standard_normal((3, n, n)) + 1j * rng.standard_normal((3, n, n)),
                                  nslices=nslices, device=cuda_device) for n in (ny, nx)]
    kw = dict(cmax=cmax, fold_tail=fold_tail)
    a = k10.gmain12_nodemat(x_pre, *mats, grid, **kw)
    b = k10.gmain12_nodemat(x_pre, *mats, grid, **kw)
    ref = k10.gmain12_reference(_to(x_pre, "cpu"), *(_to(m, "cpu") for m in mats), grid, **kw)
    torch.cuda.synchronize()
    assert _same(a, ref) and _same(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("grid", GRIDS + [(16, 16, 16), (48, 48, 48)])
def test_k10_plan_mirrors_the_library(cuda_device, grid):
    """The Python plan (``kernels.oz_gmain12.plan``) against the kernel's own
    count (``bfft_oz_gmain12_plan``), for the rule and every z block."""
    import ctypes

    from boltzfft_torch._build import load_library

    nx, ny, nz = grid
    nzh = nz // 2
    lib = load_library()
    for c in (1, 4, 24):
        for zb in [0] + [d for d in range(1, nzh + 1) if nzh % d == 0]:
            out = (ctypes.c_int * 7)()
            assert lib.bfft_oz_gmain12_plan(nx, ny, nzh, c, 7, 7, zb, out) == 0
            p = k10.plan(nx, ny, nzh, c, 7, 7, zb or None)
            assert list(out) == [p.zb, p.lg[0], p.tr[0], p.lg[1], p.tr[1], p.smem, int(p.fits)]


def _k11_stream(shape, seed, device, layout):
    """A stream of logical shape ``(C, Nx, Ny, Nz)``: in order, the x
    stage's rolled view (memory (C, Ny, Nz, Nx)), or a transposed view
    (memory (C, Nz, Ny, Nx))."""
    c, nx, ny, nz = shape
    if layout == "contiguous":
        return _cds(shape, seed, device)
    if layout == "rolled":
        return ds._roll_axis(_cds((c, ny, nz, nx), seed, device), -1, -3)
    raw = _cds((c, nz, ny, nx), seed, device)
    return ds.tree_map(lambda a: a.permute(0, 3, 2, 1), raw)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["contiguous", "rolled", "transposed"])
@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("grid", GRIDS + [(32, 32, 32), (48, 48, 48), (64, 64, 64)])
def test_k11_matches_plain(cuda_device, grid, weighted, layout):
    """K11 on streams in order and, as the full routes hand them over, on
    the x stage's rolled views (read in place through their strides), and on
    transposed views."""
    c = 2
    g1 = _k11_stream((c,) + grid, 11, cuda_device, layout)
    g2 = _k11_stream((c,) + grid, 12, cuda_device, layout)
    assert tuple(g1.re.hi.shape) == (c,) + grid
    assert g1.re.hi.is_contiguous() == (layout == "contiguous")
    rng = np.random.default_rng(13)
    w = ds.from_f64(rng.uniform(0.5, 1.5, c), torch.float32, cuda_device) if weighted else None
    a = k11.hadamard_wsum(g1, g2, w)
    b = k11.hadamard_wsum(g1, g2, w)
    ref = k11.hadamard_wsum(_to(g1, "cpu"), _to(g2, "cpu"), _to(w, "cpu"))
    torch.cuda.synchronize()
    assert _same(a, ref) and _same(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("grid", [(16, 16, 16), (32, 32, 32), (48, 48, 48)])
def test_route_12_whole_eval_bitwise_equal_to_staged(cuda_device, grid):
    """The whole ds eval through K10 (``gmain_fused="12"``) is bitwise equal
    to the staged main block's (``gmain_fused=False``) and to itself."""
    cfg = _cfg(grid)
    fm = np.abs(np.random.default_rng(21).standard_normal(cfg.grid_shape)) + 0.1
    pre = build_ds_precomp(cfg, device=cuda_device)
    f = ds.from_f64(fm, torch.float32, cuda_device)
    n10 = k10.LAUNCHES
    q12 = collide_ds(cfg, pre, f, contract="oz", g_stream="half", gmain_fused="12")
    again = collide_ds(cfg, pre, f, contract="oz", g_stream="half", gmain_fused="12")
    staged = collide_ds(cfg, pre, f, contract="oz", g_stream="half", gmain_fused=False)
    torch.cuda.synchronize()
    assert k10.LAUNCHES > n10
    assert _same(q12, staged) and _same(q12, again)
