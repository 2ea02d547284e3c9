"""The ds engine's full g-stream, phased and fused-y+x routes on the CPU: K8's
phased mode, K10 (``gmain12_nodemat``) and K11 (``hadamard_wsum``) as plain
PyTorch versions against the JAX package's (K8 phased through its jnp twin,
K10 in Pallas interpret mode, K11 through its staged twin), the phased 3-D
transform, K10's z-block rule, the full and phased routes against the half
route and the float64 c2c pipeline, ``selfcheck_ds`` on the full streams,
and the probes' refusal to run without a card.  ``collide_ds`` through each
new route against JAX's ``contract="ozk"`` is in
``tests/test_torch_ds_operator.py``, which computes JAX's references once.

Row scales: JAX's phased twin and K10 cut each row at ``_phase_sigma``, the
port at the exponent-bit rule (``tests/test_torch_oz.py``); each bitwise test
asserts that its seeded rows scale alike under both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boltzfft import ds as jds
from boltzfft import oz as joz

import boltzfft_torch as bt
from boltzfft_torch import ds, health, oz
from boltzfft_torch.ds_operator import build_ds_precomp, collide_ds
from boltzfft_torch.kernels import oz_contract as k8
from boltzfft_torch.kernels import oz_gmain12 as k10
from boltzfft_torch.kernels import oz_hadamard_full as k11
from boltzfft_torch.kernels import oz_preslice as k7

TOL = 1e-12


def _equal(j, t):
    """Bitwise equality of a JAX CDS/DS and a port one."""
    leaves = jax.tree.leaves(j)
    mine = []
    ds.tree_map(mine.append, t)
    assert len(leaves) == len(mine)
    for a, b in zip(leaves, mine):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def _cds_pair(shape, seed, scale=3.0):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal(shape) * scale + 1j * rng.standard_normal(shape)
    return jds.cds_from_f64(z), ds.cds_from_f64(z), z


def _scales_agree(planes):
    """The port's row scale equals JAX's _phase_sigma on every row of each
    float32 plane."""
    for a in planes:
        rows = a.reshape(-1, a.shape[-1])
        if not np.array_equal(oz.row_sigma(rows).numpy(),
                              np.asarray(joz._phase_sigma(jnp.asarray(rows.numpy())))):
            return False
    return True


def _rel(a, ref):
    return np.abs(a - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("repeat", [True, False])
@pytest.mark.parametrize("conj", [False, True])
def test_k8_phased_plain_matches_jax(repeat, conj):
    c, k, ell = 3, 8, 10
    m = np.exp(2j * np.pi * np.random.default_rng(1).random((k, ell)))
    phj, pht, _ = _cds_pair((c, k), 7)
    xj, xt, z = _cds_pair((5, 6, k) if repeat else (c, 6, k), 5)
    rep = c if repeat else None
    planes = [xt.re.hi, xt.re.lo, xt.im.hi, xt.im.lo]
    phase = [pht.re.hi, pht.re.lo, pht.im.hi, pht.im.lo]
    t = k8.phase_operand(planes, phase, conj, c, not repeat)
    assert _scales_agree((t[0], t[2]))
    oj = joz.contract_last_oz_kernel(xj, joz.slice_matrix(m), phase=phj, conj=conj,
                                     repeat=rep, interpret=True)
    ot = k8.contract_last_oz_kernel(xt, oz.slice_matrix(m), phase=pht, conj=conj, repeat=rep)
    _equal(oj, ot)
    # the value: (phase * x) @ m in float64
    p = ds.cds_to_c128(pht)
    p = np.conj(p) if conj else p
    xx = np.broadcast_to(z, (c,) + z.shape) if repeat else z
    exact = np.einsum("ck,c...k,kl->c...l", p, xx, m)
    assert np.abs(ds.cds_to_c128(ot) - exact).max() <= 1e-13 * np.abs(exact).max()


def test_k8_phased_rejects_bad_shapes():
    _, xt, _ = _cds_pair((4, 5, 8), 2)
    _, pht, _ = _cds_pair((3, 8), 3)
    m = oz.slice_matrix(np.ones((8, 4)) + 0j)
    with pytest.raises(ValueError, match="repeat=2"):
        k8.contract_last_oz_kernel(xt, m, phase=pht, repeat=2)
    with pytest.raises(ValueError, match="split over 3 nodes"):
        k8.contract_last_oz_kernel(xt, m, phase=pht)
    with pytest.raises(ValueError, match="repeat requires phase"):
        k8.contract_last_oz_kernel(xt, m, repeat=3)


@pytest.mark.parametrize("conj", [False, True])
def test_transform3_oz_phased_matches_jax(conj):
    shape, c = (6, 8, 10), 2
    mats = [np.exp(2j * np.pi * np.outer(np.arange(n), np.arange(n)) / n) / n for n in shape]
    phs = [_cds_pair((c, n), 20 + i) for i, n in enumerate(shape)]
    xj, xt, z = _cds_pair(shape, 30)
    oj = joz.transform3_oz_phased(xj, tuple(joz.slice_matrix(m) for m in mats),
                                  tuple(p[0] for p in phs), conj=conj, kernel=True)
    ot = oz.transform3_oz_phased(xt, tuple(oz.slice_matrix(m) for m in mats),
                                 tuple(p[1] for p in phs), conj=conj)
    _equal(oj, ot)
    ph = [ds.cds_to_c128(p[1]) for p in phs]
    ph = [np.conj(p) for p in ph] if conj else ph
    exact = np.einsum("xyz,cx,cy,cz,xi,yj,zk->cijk", z, *ph, *mats)
    assert np.abs(ds.cds_to_c128(ot) - exact).max() <= 1e-13 * np.abs(exact).max()


@pytest.mark.parametrize("weighted", [True, False])
def test_k11_plain_matches_jax_staged(weighted):
    g1j, g1t, g1 = _cds_pair((3, 6, 8, 10), 40)
    g2j, g2t, g2 = _cds_pair((3, 6, 8, 10), 41)
    w = np.random.default_rng(42).uniform(0.5, 1.5, 3) if weighted else None
    oj = joz.hadamard_wsum(g1j, g2j, None if w is None else jds.from_f64(w), kernel=False)
    ot = k11.hadamard_wsum(g1t, g2t, None if w is None else ds.from_f64(w))
    _equal(oj, ot)
    exact = np.einsum("c,c...->...", np.ones(3) if w is None else w, g1 * g2)
    assert np.abs(ds.cds_to_c128(ot) - exact).max() <= 1e-13 * np.abs(exact).max()


@pytest.mark.parametrize("grid", [(8, 8, 8), (6, 8, 10)])
def test_k10_plain_matches_jax_interpret_and_zh_blocks(grid):
    nx, ny, nz = grid
    nzh = nz // 2
    rng = np.random.default_rng(21)
    z = rng.standard_normal((nx, nzh, ny)) + 1j * rng.standard_normal((nx, nzh, ny))
    fj, ft = jds.cds_from_f64(z), ds.cds_from_f64(z)
    rows = lambda a: a.reshape(-1, ny)
    sig = torch.maximum(oz.row_sigma(rows(ft.re.hi)), oz.row_sigma(rows(ft.im.hi))).numpy()
    assert np.array_equal(sig, np.maximum(np.asarray(joz._phase_sigma(rows(fj.re.hi))),
                                          np.asarray(joz._phase_sigma(rows(fj.im.hi)))))
    my = rng.standard_normal((3, ny, ny)) + 1j * rng.standard_normal((3, ny, ny))
    mx = rng.standard_normal((3, nx, nx)) + 1j * rng.standard_normal((3, nx, nx))
    xj = joz.preslice_rows(fj, cmax=6, interpret=True, merged=True)
    xt = k7.preslice_rows(ft, cmax=6, merged=True)
    oj = joz.gmain12_nodemat(xj, joz.slice_matrix_nodes(my), joz.slice_matrix_nodes(mx), grid,
                             cmax=6, zh_block=1, interpret=True)
    mt = (oz.slice_matrix_nodes(my), oz.slice_matrix_nodes(mx))
    blocks = [d for d in range(1, nzh + 1) if nzh % d == 0]
    outs = [k10.gmain12_nodemat(xt, *mt, grid, cmax=6, zh_block=zb) for zb in blocks]
    for o in outs:
        _equal(oj, o)
    with pytest.raises(ValueError, match="must divide"):
        k10.gmain12_nodemat(xt, *mt, grid, cmax=6, zh_block=nzh + 1)
    # the value: the y then x transforms of the spectrum, (C, Nx, Ny, Nz/2)
    exact = np.einsum("xzy,cyj,cxi->cijz", z, my, mx)
    assert np.abs(ds.cds_to_c128(outs[0]) - exact).max() <= 1e-13 * np.abs(exact).max()
    with pytest.raises(ValueError, match="merge_ok"):
        big = oz.CSlicedMatrix(torch.zeros(1, 8, 80, 80), torch.zeros(1, 8, 80, 80))
        k10.gmain12_nodemat(xt, big, big, (80, 80, 80))


def test_default_zh_block_rule():
    """K10's z block (``kernels.oz_gmain12.plan``, the mirror of the
    kernel's count): the largest fitting divisor of Nz/2 that leaves at
    least MIN_CTAS blocks, else the smallest that fits."""
    assert k10.plan(64, 64, 32, 4).zb == 1  # 128 blocks: no larger block keeps more
    assert k10.plan(64, 64, 32, 4).smem <= k10.SMEM_MAX
    assert not k10.plan(64, 64, 32, 4, zh_block=4).fits
    for n, c in ((8, 12), (16, 12), (32, 24), (32, 4), (48, 4), (64, 4), (64, 24)):
        nzh = n // 2
        p = k10.plan(n, n, nzh, c)
        fitting = [d for d in range(1, nzh + 1) if nzh % d == 0 and k10.plan(n, n, nzh, c, zh_block=d).fits]
        keep = [d for d in fitting if c * (nzh // d) >= k10.MIN_CTAS]
        assert p.fits and p.zb == (max(keep) if keep else min(fitting)), (n, c, p)
    # a grid whose blocks never fit: zb 0
    assert k10.plan(400, 400, 2, 1).zb == 0


def test_full_routes_agree_with_half_and_f64_c2c_at_8():
    kw = dict(nv=8, ns=6, n_radial=2)
    cfg = bt.CollisionConfig(impl="c2c", dtype="float32", **kw)
    fm = np.abs(np.random.default_rng(9).standard_normal(cfg.grid_shape)) + 0.1
    f = ds.from_f64(fm)
    pre = build_ds_precomp(cfg, device="cpu")
    full = ds.to_f64(collide_ds(cfg, pre, f, contract="oz", g_stream="full"))
    half = ds.to_f64(collide_ds(cfg, pre, f, contract="oz", g_stream="half"))
    phased = ds.to_f64(collide_ds(cfg, build_ds_precomp(cfg, node_mats=False, device="cpu"), f,
                                  contract="oz"))
    cfg64 = bt.CollisionConfig(impl="c2c", dtype="float64", **kw)
    collide, pre64 = bt.make_collision_operator(cfg64, "cpu")
    q64 = collide(torch.as_tensor(fm), pre64).numpy()
    for q in (full, phased):
        assert _rel(q, q64) <= TOL and _rel(q, half) <= TOL


def test_selfcheck_ds_full_streams_on_cpu():
    calls = k11.REFERENCE_CALLS
    r = health.selfcheck_ds(nv=8, ns=6, n_radial=4, device="cpu")
    assert r["ok"] and r["finite"] and r["rel_linf"] < 1e-12, r
    assert k11.REFERENCE_CALLS > calls  # the CPU default: full streams, K11


@pytest.mark.parametrize("probe", ["selfcheck", "selfcheck_ds"])
def test_probes_raise_without_a_card(monkeypatch, probe):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        getattr(health, probe)(nv=8, ns=6)


def test_entry_argtypes_match_the_sources():
    """Every ctypes signature in ``_build`` has the C entry's parameters, in
    order: a pointer for each ``void*``, a ``c_int`` for each ``int``, a
    ``c_double`` for each ``double`` (a wrong count passes garbage through
    the stack, which no CPU test would otherwise see)."""
    import ctypes
    import re

    from boltzfft_torch import _build

    kinds = {"void*": ctypes.c_void_p, "int": ctypes.c_int, "double": ctypes.c_double}
    entries = {}
    for src in sorted(_build._SRC_DIR.glob("*.cu")):
        text = src.read_text()
        for m in re.finditer(r'extern "C" int (bfft_\w+)\(([^)]*)\)', text):
            params = [p.strip() for p in m.group(2).split(",")]
            types = [re.sub(r"\bconst\b|\w+$", "", p).replace(" ", "") for p in params]
            entries[m.group(1)] = [kinds[t] for t in types]
    table = dict(_build._ENTRY_ARGS_F32)
    for stem, argtypes in _build._ENTRY_ARGS.items():
        for suffix in ("_f32", "_f64"):
            table[stem + suffix] = argtypes
    for name, argtypes in table.items():
        if name in entries:  # the f32/f64 pairs come from macros, not read here
            assert entries[name] == argtypes, name
    assert {"bfft_oz_contract", "bfft_oz_gmain12", "bfft_oz_gmain12_plan",
            "bfft_oz_hadamard"} <= set(entries)


def _k11_layouts(name):
    rng = np.random.default_rng(31)
    c, grid = 3, (4, 5, 6)
    cds = lambda shape: ds.cds_from_f64(rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
    rolled = lambda: ds._roll_axis(cds((c, grid[1], grid[2], grid[0])), -1, -3)
    if name == "rolled":
        return rolled(), rolled()
    if name == "rolled, in order":
        return rolled(), cds((c,) + grid)
    if name == "in order, rolled":
        return cds((c,) + grid), rolled()
    if name == "two axes":
        return ds._roll_axis(cds((c, 6, 5)), -1, -2), cds((c, 5, 6))
    # planes of one stream in different layouts: copied into order
    g = rolled()
    return ds.CDS(g.re, ds.tree_map(lambda a: a.contiguous(), g.im)), rolled()


@pytest.mark.parametrize("layout", ["rolled", "rolled, in order", "in order, rolled",
                                    "two axes", "planes differ"])
def test_k11_wrapper_addresses_strided_streams(monkeypatch, layout):
    """The CUDA wrapper's layout arguments (streams read in place through
    their strides, axes in the first stream's memory order, the output
    written through its strides), held on the CPU against an entry that does
    the kernel's addressing in NumPy on the raw memory and copies one input
    element through to each output plane."""
    import contextlib
    import ctypes
    import types

    from boltzfft_torch import _build

    seen = {}

    def entry(*args):
        planes, outs = args[:8], args[10:14]
        c, d1, d2, d3 = args[14:18]
        s1, s2, so = args[18:22], args[22:26], args[26:29]
        seen["s1"] = s1
        e = np.arange(d1 * d2 * d3)
        i1, i2, i3 = e // (d2 * d3), (e // d3) % d2, e % d3
        view = lambda p, o: np.ctypeslib.as_array((ctypes.c_float * (int(o.max()) + 1)).from_address(p))
        oe = i1 * so[0] + i2 * so[1] + i3 * so[2]
        assert np.array_equal(np.sort(oe), e)  # the output: each element once, in bounds
        for out, p, s, j in ((outs[0], planes[0], s1, c - 1), (outs[1], planes[4], s2, c - 1),
                             (outs[2], planes[3], s1, 0), (outs[3], planes[7], s2, 0)):
            o = j * s[0] + i1 * s[1] + i2 * s[2] + i3 * s[3]
            view(out, oe)[oe] = view(p, o)[o]
        return 0

    monkeypatch.setattr(_build, "load_library",
                        lambda: types.SimpleNamespace(bfft_oz_hadamard=entry))
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=None))
    g1, g2 = _k11_layouts(layout)
    out = k11._hadamard_cuda(g1, g2, None)
    assert torch.equal(out.re.hi, g1.re.hi[-1]) and torch.equal(out.re.lo, g2.re.hi[-1])
    assert torch.equal(out.im.hi, g1.im.lo[0]) and torch.equal(out.im.lo, g2.im.lo[0])
    assert out.re.hi.is_contiguous() and tuple(out.re.hi.shape) == tuple(g1.re.hi.shape[1:])
    assert seen["s1"][3] == 1  # consecutive threads read consecutive elements of g1
