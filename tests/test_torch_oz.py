"""The port's Ozaki engine against the JAX package's on the CPU: the host
tables (``slice_matrix``, ``slice_matrix_nodes``, every ``DsPrecomp`` field
and ``ds_precomp_from_numpy``), K7's plain version against
``preslice_rows(interpret=True)``, K8's plain version against the jnp twin of
``contract_last_oz_kernel`` and against ``contract_last_oz_nodemat``
(interpret), and the staged ``contract_last_oz``.

Row scales.  The port cuts every row at the exponent-bit scale (JAX's
``_pow2_ceil``); JAX's ``preslice_rows`` and ``contract_last_oz_nodemat``
take ``_phase_sigma`` (``exp2(floor(log2 max) + 1)``).  The two agree except
where ``log2`` rounds a value just below a power of two up; each test that
meets ``_phase_sigma`` asserts that its seeded rows are not such a case, and
then asks for the same bits.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import boltzfft as bz
from boltzfft import ds as jds
from boltzfft import oz as joz
from boltzfft.ds_operator import build_ds_precomp as j_build

import boltzfft_torch as bt
from boltzfft_torch import ds, oz
from boltzfft_torch.ds_operator import build_ds_precomp
from boltzfft_torch.kernels import oz_contract as k8
from boltzfft_torch.kernels import oz_preslice as k7


def _equal(j, t):
    """Bitwise equality of a JAX tree and a port tree (bf16 via float32)."""
    if j is None:
        assert t is None
        return
    if isinstance(j, tuple):
        assert isinstance(t, tuple) and len(j) == len(t)
        for a, b in zip(j, t):
            _equal(a, b)
        return
    a = np.asarray(j).astype(np.float32 if np.asarray(j).dtype.name == "bfloat16" else None)
    b = t.to(torch.float32 if t.dtype == torch.bfloat16 else t.dtype).cpu().numpy()
    assert a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _cds_pair(shape, seed):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal(shape) * 3 + 1j * rng.standard_normal(shape)
    return jds.cds_from_f64(z), ds.cds_from_f64(z, device="cpu"), z


def _scales_agree(x, merged):
    """The port's scale equals JAX's _phase_sigma on every row of ``x``."""
    rows = lambda a: a.reshape(-1, a.shape[-1]).float()
    rh, ih = rows(x.re.hi), rows(x.im.hi)
    phase = lambda a: np.asarray(joz._phase_sigma(jnp.asarray(a.numpy())))
    if merged:
        mine = torch.maximum(oz.row_sigma(rh), oz.row_sigma(ih)).numpy()
        theirs = np.maximum(phase(rh), phase(ih))
        return np.array_equal(mine, theirs)
    return (np.array_equal(oz.row_sigma(rh).numpy(), phase(rh))
            and np.array_equal(oz.row_sigma(ih).numpy(), phase(ih)))


def test_slice_matrix_bitwise():
    rng = np.random.default_rng(0)
    m = rng.standard_normal((9, 7)) + 1j * rng.standard_normal((9, 7))
    _equal(tuple(joz.slice_matrix(m)), tuple(oz.slice_matrix(m, device="cpu")))
    _equal(tuple(joz.slice_matrix(m, 6, 8)), tuple(oz.slice_matrix(m, 6, 8, device="cpu")))
    mn = rng.standard_normal((2, 3, 5, 6)) + 1j * rng.standard_normal((2, 3, 5, 6))
    _equal(tuple(joz.slice_matrix_nodes(mn)), tuple(oz.slice_matrix_nodes(mn, device="cpu")))
    # the slices sum back to the matrix at 2^-56 of its scale
    s = oz.slice_matrix(m, device="cpu")
    back = s.re.double().sum(0).numpy() + 1j * s.im.double().sum(0).numpy()
    assert np.abs(back - m).max() <= 2.0**-52 * np.abs(m).max()


@pytest.mark.parametrize("make", [oz.slice_matrix, oz.slice_matrix_nodes])
def test_slice_matrix_defaults_to_the_card(make):
    # an entry point runs on the card unless asked for the CPU
    assert inspect.signature(make).parameters["device"].default == "cuda"
    m = np.ones((2, 3, 4)) + 1j
    s = make(m, device="cpu")
    assert all(t.device.type == "cpu" and t.dtype == torch.bfloat16 for t in s)


@pytest.mark.parametrize("shape,node_mats", [((6, 6, 6), True), ((6, 8, 10), True),
                                             ((6, 6, 6), False)])
def test_ds_precomp_bitwise_and_from_numpy(shape, node_mats):
    kw = dict(nv=shape[0], nvy=shape[1], nvz=shape[2], ns=6, n_radial=2, impl="c2c",
              dtype="float32")
    pj = j_build(bz.CollisionConfig(**kw), node_mats=node_mats)
    pt = build_ds_precomp(bt.CollisionConfig(**kw), node_mats=node_mats, device="cpu")
    for field in pj._fields:
        _equal(getattr(pj, field), getattr(pt, field))
    carried = bt.ds_precomp_from_numpy(jax.tree.map(np.asarray, pj), device="cpu")
    for field in pj._fields:
        _equal(getattr(pj, field), getattr(carried, field))


def test_merge_ok_matches_jax():
    for k in (8, 32, 64, 73, 74, 146, 147):
        for cmax in (4, 6, 7):
            assert oz.merge_ok(k, cmax=cmax) == joz.merge_ok(k, cmax=cmax)
    assert oz.unmerged_ok(146, cmax=6) and not oz.unmerged_ok(147, cmax=6)


@pytest.mark.parametrize("merged", [False, True])
@pytest.mark.parametrize("cmax", [6, 4])
def test_k7_plain_matches_jax_preslice(merged, cmax):
    xj, xt, z = _cds_pair((3, 5, 12), 1)
    assert _scales_agree(xt, merged)
    pj = joz.preslice_rows(xj, cmax=cmax, interpret=True, merged=merged)
    pt = k7.preslice_rows(xt, cmax=cmax, merged=merged)
    _equal(tuple(pj), tuple(pt))
    # the chunks rebuild every row to 2^-49 of its scale (all 7 chunks)
    if cmax == 6:
        k = 12
        rows = z.reshape(-1, k)
        if merged:
            c = pt.full.double().reshape(-1, 7, 2, k).sum(1)
            back = c[:, 0].numpy() + 1j * c[:, 1].numpy()
        else:
            back = (pt.all_re.double().reshape(-1, 7, k).sum(1).numpy()
                    + 1j * pt.all_im.double().reshape(-1, 7, k).sum(1).numpy())
        exact = ds.cds_to_c128(xt).reshape(-1, k)
        scale = np.maximum(np.abs(rows.real), np.abs(rows.imag)).max(1, keepdims=True)
        assert np.all(np.abs(back - exact) <= 2.0**-49 * 2 * scale)


@pytest.mark.parametrize("real_in,real_out,cmax,fold_tail", [
    (False, False, 6, None), (True, False, 6, None), (False, True, 6, None),
    (False, False, 4, None), (False, False, 6, 4),
])
def test_k8_plain_matches_jax_twin(real_in, real_out, cmax, fold_tail):
    """contract_last_oz_kernel: JAX's off-TPU jnp twin uses _pow2_ceil, the
    port's rule, so the result is bitwise equal."""
    xj, xt, _ = _cds_pair((4, 6, 10), 2)
    if real_in:
        xj = jds.cds_from_real(xj.re)
        xt = ds.cds_from_real(xt.re)
    m = np.exp(2j * np.pi * np.random.default_rng(3).random((10, 12)))
    kw = dict(cmax=cmax, real_in=real_in, real_out=real_out, fold_tail=fold_tail)
    oj = joz.contract_last_oz_kernel(xj, joz.slice_matrix(m), interpret=True, **kw)
    ot = k8.contract_last_oz_kernel(xt, oz.slice_matrix(m, device="cpu"), **kw)
    _equal(tuple(oj), tuple(ot))


@pytest.mark.parametrize("repeat,x_pre,merged,real_out", [
    (True, False, False, False), (True, True, False, False), (True, True, True, False),
    (False, False, True, False), (False, False, False, True), (False, False, True, True),
])
def test_k8_nodemat_plain_matches_jax(repeat, x_pre, merged, real_out):
    c, k, ell = 3, 8, 10
    rng = np.random.default_rng(4)
    mats = rng.standard_normal((c, k, ell)) + 1j * rng.standard_normal((c, k, ell))
    xj, xt, _ = _cds_pair((5, 6, k) if repeat else (c, 6, k), 5)
    assert _scales_agree(xt, merged)
    kw = dict(cmax=6, repeat=repeat, merged=merged, real_out=real_out)
    pj = joz.preslice_rows(xj, cmax=6, interpret=True, merged=merged) if x_pre else None
    pt = k7.preslice_rows(xt, cmax=6, merged=merged) if x_pre else None
    oj = joz.contract_last_oz_nodemat(xj, joz.slice_matrix_nodes(mats), interpret=True,
                                      x_pre=pj, **kw)
    ot = k8.contract_last_oz_nodemat(xt, oz.slice_matrix_nodes(mats, device="cpu"), x_pre=pt, **kw)
    _equal(tuple(oj), tuple(ot))


def test_k8_merged_past_merge_ok_raises():
    """A merged call past merge_ok raises; the phased mode, unmerged, runs
    there (K = 74 <= 146) and is the shared-matrix contraction of the
    operand phase * x, bitwise."""
    _, xt, _ = _cds_pair((2, 74), 6)
    m = oz.slice_matrix_nodes(np.ones((2, 74, 4)) + 0j, device="cpu")
    with pytest.raises(ValueError, match="merge_ok"):
        k8.contract_last_oz_nodemat(xt, m, repeat=True, merged=True)
    _, ph, _ = _cds_pair((2, 74), 7)
    ms = oz.slice_matrix(np.exp(2j * np.pi * np.random.default_rng(8).random((74, 4))),
                         device="cpu")
    for conj in (False, True):
        got = k8.contract_last_oz_kernel(xt, ms, phase=ph, conj=conj)
        t = k8.phase_operand([xt.re.hi, xt.re.lo, xt.im.hi, xt.im.lo],
                             [ph.re.hi, ph.re.lo, ph.im.hi, ph.im.lo], conj, 2, True)
        want = k8.contract_last_oz_kernel(ds.CDS(ds.DS(t[0], t[1]), ds.DS(t[2], t[3])), ms)
        _equal(tuple(want), tuple(got))


def test_staged_contract_last_oz_matches_jax():
    xj, xt, z = _cds_pair((3, 4, 9), 7)
    m = np.exp(2j * np.pi * np.random.default_rng(8).random((9, 5)))
    oj = joz.contract_last_oz(xj, joz.slice_matrix(m), cmax=6)
    ot = oz.contract_last_oz(xt, oz.slice_matrix(m, device="cpu"), cmax=6)
    _equal(tuple(oj), tuple(ot))
    # the kernel route folds in another order: same value at the ds floor
    ok = ds.cds_to_c128(k8.contract_last_oz_kernel(xt, oz.slice_matrix(m, device="cpu"), cmax=6))
    st = ds.cds_to_c128(ot)
    assert np.abs(ok - st).max() <= 1e-14 * np.abs(z @ m).max()


def test_level_groups_matches_jax():
    for nlev in range(1, 9):
        for sx in (5, 7):
            assert oz._level_groups(nlev, sx) == joz._level_groups(nlev, sx)


@pytest.mark.parametrize("merged", [False, True])
def test_transform3_oz_nodemat_matches_jax(merged):
    """The per-node phase-folded 3-D inverse: port (K8's plain version) vs
    JAX's jnp twin route; the later stages meet _phase_sigma only on rows of
    exact intermediate values, so the scales are checked on the input."""
    rng = np.random.default_rng(14)
    shape, c = (6, 6, 8), 2
    mats = tuple(rng.standard_normal((c, n, n)) + 1j * rng.standard_normal((c, n, n))
                 for n in shape)
    xj, xt, z = _cds_pair(shape, 15)
    oj = joz.transform3_oz_nodemat(xj, tuple(joz.slice_matrix_nodes(m) for m in mats), cmax=6,
                                   kernel=True, merged=merged)
    ot = oz.transform3_oz_nodemat(xt, tuple(oz.slice_matrix_nodes(m, device="cpu") for m in mats),
                                  cmax=6, merged=merged)
    a, b = jds.cds_to_c128(oj), ds.cds_to_c128(ot)
    exact = np.einsum("xyz,czk,cyj,cxi->cijk", z, mats[2], mats[1], mats[0])
    assert np.abs(a - b).max() <= 1e-14 * np.abs(exact).max()
    assert np.abs(b - exact).max() <= 1e-13 * np.abs(exact).max()


@pytest.mark.parametrize("kernel", [None, False])
def test_transform3_oz_matches_jax(kernel):
    """kernel None: K8 (bitwise to JAX's jnp twin); False: the staged engine."""
    xj, xt, z = _cds_pair((6, 8, 10), 16)
    mats = [np.exp(-2j * np.pi * np.outer(np.arange(n), np.arange(n)) / n) for n in (6, 8, 10)]
    oj = joz.transform3_oz(xj, tuple(joz.slice_matrix(m) for m in mats), cmax=6,
                           kernel=True if kernel is None else False)
    ot = oz.transform3_oz(xt, tuple(oz.slice_matrix(m, device="cpu") for m in mats), cmax=6,
                          kernel=kernel)
    _equal(tuple(oj), tuple(ot))
    assert np.abs(ds.cds_to_c128(ot) - np.fft.fftn(z)).max() <= 1e-13 * np.abs(np.fft.fftn(z)).max()


def test_config_oz_cmax():
    with pytest.raises(ValueError, match="oz_cmax"):
        bt.CollisionConfig(oz_cmax=15)
    kw = dict(nv=6, ns=6, n_radial=2, impl="c2c", dtype="float32")
    cfg4 = bt.CollisionConfig(oz_cmax=4, **kw)
    pre = build_ds_precomp(cfg4, device="cpu")
    f = ds.from_f64(np.abs(np.random.default_rng(17).standard_normal((6, 6, 6))) + 0.1, device="cpu")
    from boltzfft_torch.ds_operator import collide_ds

    a = collide_ds(cfg4, pre, f, contract="oz", g_stream="half")
    b = collide_ds(bt.CollisionConfig(**kw), pre, f, contract="oz", g_stream="half", oz_cmax=4)
    c = collide_ds(cfg4, pre, f, contract="oz", g_stream="half", oz_cmax=6)
    assert torch.equal(a.hi, b.hi) and torch.equal(a.lo, b.lo)
    assert not torch.equal(a.lo, c.lo)
