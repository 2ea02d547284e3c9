"""K9 (``gmain3_nodemat``) and K12 (``hadamard_wsum_half``): their plain
PyTorch versions against the JAX package's on the CPU (K9 in Pallas
interpret mode, K12 through its staged twin) and against the port's own
staged K8 chain.

K9's stage 1 meets JAX's ``_phase_sigma`` row scale (see
``tests/test_torch_oz.py``); the test asserts that the seeded spectrum's
rows scale alike, and the later stages' rows come out of exact arithmetic on
both sides.  K12's JAX twin multiplies with ``ds.cmul`` under XLA, which may
contract a product into an FMA: agreement at the ds noise floor, not bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import boltzfft as bz
from boltzfft import ds as jds
from boltzfft import oz as joz
from boltzfft.ds_operator import _assemble_g_half as j_assemble
from boltzfft.ds_operator import build_ds_precomp as j_build

import boltzfft_torch as bt
from boltzfft_torch import ds, oz
from boltzfft_torch.ds_operator import _g_main_half, build_ds_precomp
from boltzfft_torch.kernels import oz_gmain as k9
from boltzfft_torch.kernels import oz_hadamard as k12
from boltzfft_torch.kernels import oz_preslice as k7


def _first(tree):
    return jax.tree.map(lambda a: a[0], tree)


def _tfirst(tree):
    return ds.tree_map(lambda a: a[0], tree)


@pytest.mark.parametrize("grid", [(8, 8, 8)])
def test_k9_plain_matches_jax_interpret_and_k8_chain(grid):
    nx, ny, nz = grid
    kw = dict(nv=nx, nvy=ny, nvz=nz, ns=6, n_radial=2, impl="c2c", dtype="float32")
    pj = j_build(bz.CollisionConfig(**kw))
    pt = build_ds_precomp(bt.CollisionConfig(**kw), device="cpu")
    rng = np.random.default_rng(21)
    z = rng.standard_normal((nx, nz // 2, ny)) + 1j * rng.standard_normal((nx, nz // 2, ny))
    fj, ft = jds.cds_from_f64(z), ds.cds_from_f64(z, device="cpu")
    rows = lambda a: a.reshape(-1, ny)
    sig = torch.maximum(oz.row_sigma(rows(ft.re.hi)), oz.row_sigma(rows(ft.im.hi))).numpy()
    sig_j = np.maximum(np.asarray(joz._phase_sigma(rows(fj.re.hi))),
                       np.asarray(joz._phase_sigma(rows(fj.im.hi))))
    assert np.array_equal(sig, sig_j)
    mats_j = (_first(pj.pm1[1]), _first(pj.pm1[0]), _first(pj.pmz_half1w))
    mats_t = (_tfirst(pt.pm1[1]), _tfirst(pt.pm1[0]), _tfirst(pt.pmz_half1w))
    xj = joz.preslice_rows(fj, cmax=6, interpret=True, merged=True)
    xt = k7.preslice_rows(ft, cmax=6, merged=True)
    oj = joz.gmain3_nodemat(xj, *mats_j, grid, cmax=6, interpret=True)
    ot = k9.gmain3_nodemat(xt, *mats_t, grid, cmax=6)
    np.testing.assert_array_equal(np.asarray(oj.hi), ot.hi.numpy())
    np.testing.assert_array_equal(np.asarray(oj.lo), ot.lo.numpy())
    chain = _g_main_half(ft, xt, *mats_t, 6, 7, None, merged=True, grid_shape=grid)
    assert torch.equal(chain.hi, ot.hi) and torch.equal(chain.lo, ot.lo)
    with pytest.raises(ValueError, match="merge_ok"):
        big = oz.CSlicedMatrix(torch.zeros(1, 8, 80, 80), torch.zeros(1, 8, 80, 80))
        k9.gmain3_nodemat(xt, big, big, big, (80, 80, 80))


def _half_inputs(c, grid, seed, weighted):
    nx, ny, nz = grid
    rng = np.random.default_rng(seed)
    r = [rng.standard_normal((c, nx, ny, nz)) for _ in range(2)]
    cplx = lambda s: rng.standard_normal(s) + 1j * rng.standard_normal(s)
    planes = [[cplx((c, ny, nz)), cplx((c, nx, nz)), cplx((c, nx, ny))] for _ in range(2)]
    w = rng.uniform(0.5, 1.5, c) if weighted else None
    return r, planes, w


@pytest.mark.parametrize("groups,weighted", [(1, False), (2, False), (1, True)])
def test_k12_plain_matches_jax_staged(groups, weighted):
    grid = (6, 8, 10)
    c = 3 * groups
    r, planes, w = _half_inputs(c, grid, 22, weighted)
    signs_np = [(-1.0) ** np.arange(n) for n in grid]
    oj = joz.hadamard_wsum_half(
        jds.from_f64(r[0]), tuple(jds.cds_from_f64(p) for p in planes[0]),
        jds.from_f64(r[1]), tuple(jds.cds_from_f64(p) for p in planes[1]),
        None if w is None else jds.from_f64(w), grid,
        tuple(jnp.asarray(s, jnp.float32) for s in signs_np), j_assemble,
        kernel=False, groups=groups)
    ot = k12.hadamard_wsum_half(
        ds.from_f64(r[0], device="cpu"), tuple(ds.cds_from_f64(p, device="cpu") for p in planes[0]),
        ds.from_f64(r[1], device="cpu"), tuple(ds.cds_from_f64(p, device="cpu") for p in planes[1]),
        None if w is None else ds.from_f64(w, device="cpu"), grid,
        tuple(torch.as_tensor(s, dtype=torch.float32) for s in signs_np), groups=groups)
    a, b = jds.to_f64(oj), ds.to_f64(ot)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= 2.0**-45 * np.abs(a).max()
    # the exact value: Re sum_j w_j g1_j g2_j from the host float64 inputs
    g = []
    for s in range(2):
        px, py, pz = planes[s]
        sx, sy, sz = signs_np
        g.append(r[s] + sx[None, :, None, None] * px[:, None] + sy[None, None, :, None] * py[:, :, None]
                 + sz[None, None, None, :] * pz[..., None])
    h = (g[0] * g[1]).real * (1.0 if w is None else w[:, None, None, None])
    exact = h.reshape((groups, c // groups) + grid).sum(1)
    exact = exact[0] if groups == 1 else exact
    assert np.abs(b - exact).max() <= 1e-13 * np.abs(exact).max()


@pytest.mark.parametrize("groups,weighted", [(1, False), (2, False), (1, True), (2, True)])
def test_k12_plain_with_acc_matches_jax(groups, weighted):
    """The running sum: ``acc`` given, the plain version is bitwise
    ``ds.add(acc, .)`` of the call without it, and agrees with JAX's
    ``hadamard_wsum_half`` followed by JAX's ``ds.add`` (the staged twin
    multiplies under XLA: the ds noise floor, not bits)."""
    grid = (6, 8, 10)
    c = 3 * groups
    r, planes, w = _half_inputs(c, grid, 23, weighted)
    oshape = ((groups,) if groups > 1 else ()) + grid
    acc = np.random.default_rng(24).standard_normal(oshape)
    signs_np = [(-1.0) ** np.arange(n) for n in grid]

    def jax_half(sel, g):
        return joz.hadamard_wsum_half(
            jds.from_f64(r[0][sel]), tuple(jds.cds_from_f64(p[sel]) for p in planes[0]),
            jds.from_f64(r[1][sel]), tuple(jds.cds_from_f64(p[sel]) for p in planes[1]),
            None if w is None else jds.from_f64(w[sel]), grid,
            tuple(jnp.asarray(s, jnp.float32) for s in signs_np), j_assemble,
            kernel=False, groups=g)

    if weighted and groups > 1:  # JAX batches groups only unweighted: one call a group
        parts = [jax_half(slice(g * 3, g * 3 + 3), 1) for g in range(groups)]
        oj = jds.DS(jnp.stack([p.hi for p in parts]), jnp.stack([p.lo for p in parts]))
    else:
        oj = jax_half(slice(None), groups)
    oj = jds.add(jds.from_f64(acc), oj)
    args = (ds.from_f64(r[0], device="cpu"), tuple(ds.cds_from_f64(p, device="cpu") for p in planes[0]),
            ds.from_f64(r[1], device="cpu"), tuple(ds.cds_from_f64(p, device="cpu") for p in planes[1]),
            None if w is None else ds.from_f64(w, device="cpu"), grid,
            tuple(torch.as_tensor(s, dtype=torch.float32) for s in signs_np))
    acc_t = ds.from_f64(acc, device="cpu")
    calls = k12.REFERENCE_CALLS
    ot = k12.hadamard_wsum_half(*args, groups=groups, acc=acc_t)
    assert k12.REFERENCE_CALLS == calls + 1
    want = ds.add(acc_t, k12.hadamard_wsum_half(*args, groups=groups))
    assert torch.equal(ot.hi, want.hi) and torch.equal(ot.lo, want.lo)
    a, b = jds.to_f64(oj), ds.to_f64(ot)
    assert a.shape == b.shape == oshape
    assert np.abs(a - b).max() <= 2.0**-45 * np.abs(a).max()
