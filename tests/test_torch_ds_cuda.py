"""The ds engine's CUDA kernels (K7 ``preslice_rows``, K8 the two contraction
entries, K9 ``gmain3_nodemat``, K12 ``hadamard_wsum_half``) against their
plain PyTorch versions on a card, at small shapes: every result must be
bitwise equal to the plain version's and to itself run to run.  Then
``collide_ds`` on the card's default route against the same route on the
CPU (plain versions) and against the vpu engine.

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
from boltzfft_torch.kernels import oz_hadamard as k12
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
@pytest.mark.parametrize("grid", GRIDS)
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
    cfg = _cfg((8, 8, 8))
    pre = build_ds_precomp(cfg, device=cuda_device)
    f = ds.from_f64(np.ones(cfg.grid_shape), torch.float32, cuda_device)
    with pytest.raises(NotImplementedError, match="next slice"):
        collide_ds(cfg, pre, f, contract="oz", g_stream="full")
    with pytest.raises(NotImplementedError, match="next slice"):
        collide_ds(cfg, pre, f, contract="oz", gmain_fused="12")
    x = _cds((4, 8), 1, cuda_device)
    with pytest.raises(NotImplementedError, match="next slice"):
        k8.contract_last_oz_kernel(x, pre.vinv_sl, phase=x)
