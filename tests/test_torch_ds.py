"""The port's double-single arithmetic (``boltzfft_torch.ds``), its vpu engine
(compensated rank-1 contractions), the ds branch of the RK steppers and the
ds relaxation, each against the JAX package's on the same seeded inputs
(CPU, x64 JAX as the root ``conftest.py`` sets it up).

Bitwise where the operation has no product (two_sum, quick_two_sum, add,
sub, split); within 2^-46 relative where XLA may contract a product into an
FMA that eager PyTorch does not (mul, cmul); 1e-13 for the contractions.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import boltzfft as bz
from boltzfft import ds as jds
from boltzfft.ds_operator import make_ds_collision_operator as j_make

import boltzfft_torch as bt
from boltzfft_torch import ds
from boltzfft_torch.ds_operator import make_ds_collision_operator

F32 = np.float32


def _pairs(seed, shape=(257,)):
    """Float32 operands spread over 2^-20..2^20, both signs, with ds low
    words, as host float64 values."""
    rng = np.random.default_rng(seed)
    mag = 2.0 ** rng.uniform(-20, 20, shape)
    return rng.choice([-1.0, 1.0], shape) * mag * (1 + rng.uniform(0, 1, shape))


def _t(a):
    return torch.as_tensor(np.asarray(a, F32))


def _np(a):
    return np.asarray(a, np.float64)


@pytest.mark.parametrize("fn", ["two_sum", "quick_two_sum"])
def test_eft_bitwise(fn):
    a, b = _pairs(1).astype(F32), _pairs(2).astype(F32)
    if fn == "quick_two_sum":  # |a| >= |b|
        a, b = np.where(np.abs(a) >= np.abs(b), a, b), np.where(np.abs(a) >= np.abs(b), b, a)
    sj, ej = getattr(jds, fn)(jnp.asarray(a), jnp.asarray(b))
    st, et = getattr(ds, fn)(_t(a), _t(b))
    np.testing.assert_array_equal(_np(sj), st.numpy())
    np.testing.assert_array_equal(_np(ej), et.numpy())
    # error-free: s + e == a + b exactly (float64 holds both sides)
    np.testing.assert_array_equal(st.double().numpy() + et.double().numpy(),
                                  a.astype(np.float64) + b.astype(np.float64))


def test_split_and_two_prod():
    a, b = _pairs(3).astype(F32), _pairs(4).astype(F32)
    hj, lj = jds.split(jnp.asarray(a))
    ht, lt = ds.split(_t(a))
    np.testing.assert_array_equal(_np(hj), ht.numpy())
    np.testing.assert_array_equal(_np(lj), lt.numpy())
    p, e = ds.two_prod(_t(a), _t(b))
    exact = a.astype(np.float64) * b.astype(np.float64)
    np.testing.assert_array_equal(p.double().numpy() + e.double().numpy(), exact)


@pytest.mark.parametrize("op", ["add", "sub"])
def test_ds_add_sub_bitwise(op):
    x64, y64 = _pairs(5), _pairs(6)
    rj = getattr(jds, op)(jds.from_f64(x64), jds.from_f64(y64))
    rt = getattr(ds, op)(ds.from_f64(x64, device="cpu"), ds.from_f64(y64, device="cpu"))
    np.testing.assert_array_equal(_np(rj.hi), rt.hi.numpy())
    np.testing.assert_array_equal(_np(rj.lo), rt.lo.numpy())


def test_ds_mul_cmul_close():
    x64, y64 = _pairs(7), _pairs(8)
    want = x64 * y64
    got = ds.to_f64(ds.mul(ds.from_f64(x64, device="cpu"), ds.from_f64(y64, device="cpu")))
    jgot = jds.to_f64(jds.mul(jds.from_f64(x64), jds.from_f64(y64)))
    assert np.all(np.abs(got - jgot) <= 2.0**-46 * np.abs(want))
    assert np.all(np.abs(got - want) <= 2.0**-44 * np.abs(want))
    z1 = x64 + 1j * _pairs(9)
    z2 = y64 + 1j * _pairs(10)
    ct = ds.cds_to_c128(ds.cmul(ds.cds_from_f64(z1, device="cpu"), ds.cds_from_f64(z2, device="cpu")))
    cj = jds.cds_to_c128(jds.cmul(jds.cds_from_f64(z1), jds.cds_from_f64(z2)))
    scale = np.abs(z1) * np.abs(z2)
    assert np.all(np.abs(ct - cj) <= 2.0**-46 * scale)
    # the shared-product pair
    a_f, c_f = ds.cmul_both(ds.cds_from_f64(z1, device="cpu"), ds.cds_from_f64(z2, device="cpu"))
    np.testing.assert_allclose(ds.cds_to_c128(a_f), z1 * z2, rtol=0, atol=1e-13 * scale.max())
    np.testing.assert_allclose(ds.cds_to_c128(c_f), np.conj(z1) * z2, rtol=0,
                               atol=1e-13 * scale.max())


def test_from_f64_to_f64_exact():
    a = _pairs(11)
    x = ds.from_f64(a, device="cpu")
    np.testing.assert_array_equal(x.hi.numpy(), a.astype(F32))
    back = ds.to_f64(x)
    assert np.all(np.abs(back - a) <= 2.0**-48 * np.abs(a))


@pytest.mark.parametrize("make,arg", [
    (ds.from_f64, np.ones((2, 3))),
    (ds.zeros, (2, 3)),
    (ds.cds_from_f64, np.ones((2, 3)) + 1j),
    (ds.czeros, (2, 3)),
])
def test_ds_constructors_default_to_the_card(make, arg):
    # an entry point runs on the card unless asked for the CPU
    assert inspect.signature(make).parameters["device"].default == "cuda"
    x = make(arg, device="cpu")
    leaves = []
    ds.tree_map(leaves.append, x)
    assert len(leaves) == (4 if isinstance(x, ds.CDS) else 2)
    assert all(t.device.type == "cpu" and t.dtype == torch.float32 and tuple(t.shape) == (2, 3)
               for t in leaves)


#: Names of ``boltzfft.__all__`` the port does not have yet (ROADMAP Queue 1)
#: or will not have ("Do not port"), and the port's names beyond the
#: reference's.
NOT_YET_PORTED = set()
DO_NOT_PORT = {"enable_compilation_cache", "fused_fits_vmem"}
PORT_ONLY = {"antipodal_reduce", "ds_precomp_from_numpy", "pick_scheme", "precomp_from_numpy",
             "transport"}


def test_exports_match_the_reference():
    assert set(bt.__all__) == (set(bz.__all__) - NOT_YET_PORTED - DO_NOT_PORT) | PORT_ONLY
    assert all(hasattr(bt, name) for name in bt.__all__)
    assert bt.ds is ds and bt.DsPrecomp is bt.ds_operator.DsPrecomp
    assert bt.build_ds_precomp is bt.ds_operator.build_ds_precomp


@pytest.mark.parametrize("real_in,real_out", [(False, False), (True, False), (False, True)])
def test_contract_last_matches_jax(real_in, real_out):
    rng = np.random.default_rng(12)
    x = rng.standard_normal((4, 5, 6)) + 1j * rng.standard_normal((4, 5, 6))
    if real_in:
        x = x.real + 0j
    m = np.exp(2j * np.pi * rng.random((6, 7)))
    oj = jds.cds_to_c128(jds.contract_last(jds.cds_from_f64(x), jds.cds_from_f64(m),
                                           real_in=real_in, real_out=real_out))
    ot = ds.cds_to_c128(ds.contract_last(ds.cds_from_f64(x, device="cpu"), ds.cds_from_f64(m, device="cpu"),
                                         real_in=real_in, real_out=real_out))
    exact = x @ m
    if real_out:
        exact = exact.real + 0j
    scale = np.abs(exact).max()
    assert np.abs(ot - oj).max() <= 1e-13 * scale
    assert np.abs(ot - exact).max() <= 1e-13 * scale


@pytest.mark.parametrize("shape", [(6, 6, 6), (6, 8, 10)])
def test_transform3_matches_jax(shape):
    rng = np.random.default_rng(13)
    x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    mats = [np.exp(-2j * np.pi * np.outer(np.arange(n), np.arange(n)) / n) for n in shape]
    mj = tuple(jds.cds_from_f64(m) for m in mats)
    mt = tuple(ds.cds_from_f64(m, device="cpu") for m in mats)
    oj = jds.cds_to_c128(jds.transform3(jds.cds_from_f64(x), mj))
    ot = ds.cds_to_c128(ds.transform3(ds.cds_from_f64(x, device="cpu"), mt))
    exact = np.fft.fftn(x)
    scale = np.abs(exact).max()
    assert np.abs(ot - oj).max() <= 1e-13 * scale
    assert np.abs(ot - exact).max() <= 1e-13 * scale


def test_ds_rk4_relaxation_matches_jax():
    """Two RK4 steps of a BKW state at 6^3 through the vpu engine, ds state
    (the ds branches of _axpy and rk4_step), against the JAX package's."""
    kw = dict(nv=6, ns=6, n_radial=3, impl="c2c", dtype="float32")
    cfg_j, cfg_t = bz.CollisionConfig(**kw), bt.CollisionConfig(**kw)
    rsq = cfg_t.velocity_grid.r_squared()
    f0 = np.asarray(bt.bkw_f(rsq, 5.5), np.float64)
    cj, pj = j_make(cfg_j, contract="vpu")
    ct, pt = make_ds_collision_operator(cfg_t, contract="vpu", device="cpu")
    tj = bz.make_relaxation(cj, pj, dt=0.25, n_steps=2, method="rk4")(jds.from_f64(f0))
    tt = bt.make_relaxation(ct, pt, dt=0.25, n_steps=2, method="rk4")(ds.from_f64(f0, device="cpu"))
    fj, ft = jds.to_f64(tj.f), ds.to_f64(tt.f)
    assert np.abs(ft - fj).max() <= 1e-13 * np.abs(fj).max()
    # and a ds euler step is f + dt*Q with the scalar split
    q = ds.to_f64(ct(ds.from_f64(f0, device="cpu"), pt))
    fe = ds.to_f64(bt.euler_step(lambda x: ct(x, pt), ds.from_f64(f0, device="cpu"), 0.1))
    assert np.abs(fe - (f0 + 0.1 * q)).max() <= 1e-14 * np.abs(f0).max()
