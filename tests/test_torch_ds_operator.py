"""``collide_ds`` of the port end to end on the CPU (the kernels' plain
versions) against the JAX package's ``collide_ds(contract="ozk",
g_stream="half")`` and its vpu engine, on a seeded Nyquist-rich noise input,
for every combination of the knobs the card's default route reaches: the
fused main block ("3", K9) or the staged K8 chain, Hermitian downstream on
and off, group batch 1 and 2, merged stages on and off; ``g1_reversal`` on
a centrally symmetric input; an anisotropic grid; and, at 8^3, the port's
own float64 c2c pipeline.  Then the other oz routes against JAX's ``ozk``
on the same input: the full g-streams (K8, K11), the phased full streams of
tables built with ``node_mats=False`` (K8's phased mode, K11) and the fused
y+x main block ``gmain_fused="12"`` (K10; bitwise equal to the staged
chain).

The bar is 1e-12 of max|Q|, the JAX package's own half-vs-vpu bar
(``tests/test_half_spectrum.py``); the measured gaps are ~1e-14.
"""

import itertools

import numpy as np
import pytest
import torch

import boltzfft as bz
from boltzfft import ds as jds
from boltzfft.ds_operator import build_ds_precomp as j_build
from boltzfft.ds_operator import collide_ds as j_collide

import boltzfft_torch as bt
from boltzfft_torch import ds
from boltzfft_torch.ds_operator import build_ds_precomp, collide_ds, default_contract
from boltzfft_torch.kernels import oz_contract as k8
from boltzfft_torch.kernels import oz_gmain as k9
from boltzfft_torch.kernels import oz_gmain12 as k10
from boltzfft_torch.kernels import oz_hadamard_full as k11

TOL = 1e-12
KW = dict(ns=6, impl="c2c", dtype="float32")


def _noise(shape, seed=3, even=False):
    rng = np.random.default_rng(seed)
    fm = np.abs(rng.standard_normal(shape)) + 0.1
    if even:
        fm = 0.5 * (fm + fm[::-1, ::-1, ::-1])
    return fm


def _rel(a, ref):
    return np.abs(a - ref).max() / np.abs(ref).max()


@pytest.fixture(scope="module")
def case6():
    """6^3, 4 radial groups: the port's tables and the JAX references."""
    kw = dict(nv=6, n_radial=4, **KW)
    cfg_j, cfg_t = bz.CollisionConfig(**kw), bt.CollisionConfig(**kw)
    pj = j_build(cfg_j)
    fm, fe = _noise(cfg_t.grid_shape), _noise(cfg_t.grid_shape, even=True)
    return dict(
        cfg=cfg_t, pre=build_ds_precomp(cfg_t, device="cpu"), fm=fm, fe=fe,
        ozk=jds.to_f64(j_collide(cfg_j, pj, jds.from_f64(fm), contract="ozk", g_stream="half")),
        vpu=jds.to_f64(j_collide(cfg_j, pj, jds.from_f64(fm), contract="vpu")),
        vpu_even=jds.to_f64(j_collide(cfg_j, pj, jds.from_f64(fe), contract="vpu")),
    )


COMBOS = list(itertools.product(["3", False], [True, False], [1, 2], [True, False]))


@pytest.mark.parametrize("gmain,herm,gb,merged", COMBOS)
def test_half_route_matches_jax(case6, gmain, herm, gb, merged):
    q = collide_ds(case6["cfg"], case6["pre"], ds.from_f64(case6["fm"]), contract="oz",
                   g_stream="half", gmain_fused=gmain, herm_downstream=herm, group_batch=gb,
                   oz_merge=merged)
    q = ds.to_f64(q)
    assert _rel(q, case6["ozk"]) <= TOL
    assert _rel(q, case6["vpu"]) <= TOL


def test_fused_main_block_bitwise_equal_to_staged(case6):
    """K9's plain version == the staged K8 chain inside the pipeline, and
    the pipeline launches K9's plain version when "3" is asked for."""
    f = ds.from_f64(case6["fm"])
    calls = k9.REFERENCE_CALLS
    a = collide_ds(case6["cfg"], case6["pre"], f, contract="oz", g_stream="half", gmain_fused="3")
    assert k9.REFERENCE_CALLS > calls
    b = collide_ds(case6["cfg"], case6["pre"], f, contract="oz", g_stream="half",
                   gmain_fused=False)
    assert torch.equal(a.hi, b.hi) and torch.equal(a.lo, b.lo)


def test_g1_reversal_on_even_input(case6):
    f = ds.from_f64(case6["fe"])
    for gmain in ("3", False):
        q = ds.to_f64(collide_ds(case6["cfg"], case6["pre"], f, contract="oz", g_stream="half",
                                 g1_reversal=True, gmain_fused=gmain))
        assert _rel(q, case6["vpu_even"]) <= TOL


def test_vpu_engine_matches_jax(case6):
    q = ds.to_f64(collide_ds(case6["cfg"], case6["pre"], ds.from_f64(case6["fm"]),
                             contract="vpu"))
    assert _rel(q, case6["vpu"]) <= TOL


def test_anisotropic_half_route_matches_jax_vpu():
    kw = dict(nv=6, nvy=8, nvz=10, n_radial=2, **KW)
    cfg_j, cfg_t = bz.CollisionConfig(**kw), bt.CollisionConfig(**kw)
    fm = _noise(cfg_t.grid_shape, seed=5)
    ref = jds.to_f64(j_collide(cfg_j, j_build(cfg_j), jds.from_f64(fm), contract="vpu"))
    pre = build_ds_precomp(cfg_t, device="cpu")
    for gmain in ("3", False):
        q = collide_ds(cfg_t, pre, ds.from_f64(fm), contract="oz", g_stream="half",
                       gmain_fused=gmain, group_batch=2)
        assert _rel(ds.to_f64(q), ref) <= TOL


def test_half_route_matches_port_f64_c2c_at_8():
    kw = dict(nv=8, ns=6, n_radial=4)
    cfg = bt.CollisionConfig(impl="c2c", dtype="float32", **kw)
    fm = _noise(cfg.grid_shape, seed=9)
    q = ds.to_f64(collide_ds(cfg, build_ds_precomp(cfg, device="cpu"), ds.from_f64(fm),
                             contract="oz", g_stream="half", gmain_fused="3", group_batch=2))
    cfg64 = bt.CollisionConfig(impl="c2c", dtype="float64", **kw)
    collide, pre64 = bt.make_collision_operator(cfg64, "cpu")
    q64 = collide(torch.as_tensor(fm), pre64).numpy()
    assert _rel(q, q64) <= TOL


@pytest.fixture(scope="module")
def case6_full(case6):
    """JAX's ozk references of the full g-streams on case6's input, with
    the per-node matrices and without them (the phased route)."""
    kw = dict(nv=6, n_radial=4, **KW)
    cfg_j = bz.CollisionConfig(**kw)
    fj = jds.from_f64(case6["fm"])
    return dict(
        pre0=build_ds_precomp(case6["cfg"], node_mats=False, device="cpu"),
        full=jds.to_f64(j_collide(cfg_j, j_build(cfg_j), fj, contract="ozk", g_stream="full")),
        phased=jds.to_f64(j_collide(cfg_j, j_build(cfg_j, node_mats=False), fj, contract="ozk")),
    )


@pytest.mark.parametrize("route", ["full", "phased", "12", "True"])
def test_oz_routes_match_jax(case6, case6_full, route):
    """Each route launches its kernels' plain versions and lands within 1e-12
    of JAX's ozk result of the same route; "12" (and True, which is "3" at
    6^3) is bitwise equal to the staged chain."""
    cfg, pre = case6["cfg"], case6["pre"]
    f = ds.from_f64(case6["fm"])
    calls = {k: k.REFERENCE_CALLS for k in (k8, k9, k10, k11)}
    if route == "full":
        q = collide_ds(cfg, pre, f, contract="oz", g_stream="full")
        ref, used = case6_full["full"], (k8, k11)
    elif route == "phased":  # no per-node matrices: K8's phased mode
        q = collide_ds(cfg, case6_full["pre0"], f, contract="oz")
        ref, used = case6_full["phased"], (k8, k11)
    else:
        q = collide_ds(cfg, pre, f, contract="oz", g_stream="half",
                       gmain_fused="12" if route == "12" else True)
        ref, used = case6["ozk"], (k8, k10) if route == "12" else (k8, k9)
        staged = collide_ds(cfg, pre, f, contract="oz", g_stream="half", gmain_fused=False)
        assert torch.equal(q.hi, staged.hi) and torch.equal(q.lo, staged.lo)
    assert all(k.REFERENCE_CALLS > calls[k] for k in used)
    assert _rel(ds.to_f64(q), ref) <= TOL
    assert _rel(ds.to_f64(q), case6["vpu"]) <= TOL


def test_cpu_defaults_and_unported_modes(case6, case6_full):
    """The CPU defaults (vpu; the oz engine on full streams), and the routes
    that raised before K10, K11 and K8's phased mode existed."""
    cfg, pre = case6["cfg"], case6["pre"]
    f = ds.from_f64(case6["fm"])
    assert default_contract("cpu") == "vpu" and default_contract("cuda") == "oz"
    calls = k8.REFERENCE_CALLS
    q = collide_ds(cfg, pre, f)  # the CPU default: vpu engine, full streams
    assert k8.REFERENCE_CALLS == calls
    assert _rel(ds.to_f64(q), case6["vpu"]) <= TOL
    calls11 = k11.REFERENCE_CALLS
    q = collide_ds(cfg, pre, f, contract="oz")  # full streams on the CPU by default
    assert k11.REFERENCE_CALLS > calls11
    assert _rel(ds.to_f64(q), case6_full["full"]) <= TOL
    a = collide_ds(cfg, pre, f, contract="oz", g_stream="half", gmain_fused="12")
    b = collide_ds(cfg, pre, f, contract="oz", g_stream="half", gmain_fused=False)
    assert torch.equal(a.hi, b.hi) and torch.equal(a.lo, b.lo)
    with pytest.raises(ValueError, match="half-spectrum path only"):
        collide_ds(cfg, pre, f, contract="vpu", group_batch=2)
    with pytest.raises(ValueError, match="must divide"):
        collide_ds(cfg, pre, f, contract="oz", g_stream="half", group_batch=3)
