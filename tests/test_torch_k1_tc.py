"""K1's axis transforms on the tensor cores (``boltzfft_torch/csrc/
spectral_common.cuh``), checked on the CPU: a model of the float32 product,
a model of the two-factor split of the 64-point y and z axes (the lanes'
fragments as the kernel gathers them from the dense matrix, DMMA m16n8k8 by
its fragment layout), a model of the float64 dense tile (the lanes' DMMA
m16n8k16 fragments over the whole k loop), the shared-memory plan's mirror,
and the SASS counts; on a card only, the plan against the library's own, the
tensor-core instructions and their shapes, K1 on the dense tile at 16^3 (the
TG-2D batch) and 32^3, its float32 bits, and K1 and K2/K4 at 64^3 through the
split.

The float32 transforms run as 3xTF32: each operand is split hi = tf32(a),
lo = tf32(a - hi) (round to nearest, ties away, 10 mantissa bits), and each
k8 step of ``mma.sync m16n8k8`` puts each hi*hi product of Yr = Mr Xr - Mi Xi
(and of Yi = Mr Xi + Mi Xr) into a zeroed fragment of its own and chains the
four small products (lo*hi, hi*lo) into a third; float32 adds gather them.
The tensor core's adder truncates: ``tc_apply`` models each fragment as the
exact sum of its products truncated to float32.  At 16^3 the test prints,
without asserting, how far single-pass TF32 and 3xTF32 chained over the
whole k loop (the first design) miss.  Run through K1's plain
chain (``fused_collide_reference``, axes z, y, x as the kernel runs them),
the model must stay within the float32 tolerances of the float64 result.

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_k1_tc.py -m cuda
"""

import ast
import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import boltzfft_torch as bt
from boltzfft_torch import _build
from boltzfft_torch import operator as bt_op
from boltzfft_torch.kernels import fused_collide as k1

CSRC = Path(__file__).resolve().parents[1] / "boltzfft_torch" / "csrc"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The models run many small products and elementwise passes, which
    torch's thread pool makes slower, and beside other test workers stalls:
    one thread while this module runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits), to nearest, ties away:
    ``cvt.rna.tf32.f32``."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi.double(), tf32(x - hi).double()


def truncate(x: torch.Tensor) -> torch.Tensor:
    """float64 to float32, toward zero: the tensor core's adder."""
    r = x.float()
    return torch.where(r.double().abs() > x.abs(), torch.nextafter(r, torch.zeros_like(r)), r)


def tc_apply(m, t, axis, single=False, chained=False):
    """``fused_collide._apply`` on the tensor cores: contract ``m`` (N, K)
    or (C, N, K) with grid axis ``axis`` of ``t`` in k8 steps, as the float
    kernel does (``single``: one TF32 product, hi*hi only; ``chained``:
    3xTF32 with every product of the k loop chained in one fragment)."""
    t = t.movedim(axis - 3, -1)
    spec_m = "pcnk" if m.dim() == 3 else "pnk"
    spec_t = "p" + ("c" if t.dim() == 4 else "") + "abk"
    out = "p" + ("c" if m.dim() == 3 or t.dim() == 4 else "") + "abn"
    eq = f"{spec_m},{spec_t}->{out}"
    mr, mi = split(m.real.float()), split(m.imag.float())
    nmi = tuple(-p for p in mi)
    xr, xi = split(t.real.float()), split(t.imag.float())
    # the six products of each output component, (hi, lo) pairs in the
    # kernel's order: lo*hi, hi*lo, hi*hi of re = Mr Xr + (-Mi) Xi (0-5) and
    # of im = Mr Xi + Mi Xr (6-11)
    pairs = [(a[i], x[j]) for a1, x1, a2, x2 in ((mr, xr, nmi, xi), (mr, xi, mi, xr))
             for a, x in ((a1, x1), (a2, x2)) for i, j in ((1, 0), (0, 1), (0, 0))]
    a_all = torch.stack([a for a, _ in pairs])
    x_all = torch.stack([x for _, x in pairs])
    acc = [0.0, 0.0]
    for k0 in range(0, m.shape[-1], 8):
        d = torch.einsum(eq, a_all[..., k0:k0 + 8], x_all[..., k0:k0 + 8])
        for c in range(2):
            p = d[6 * c:6 * c + 6]
            if single:  # hi*hi of both products, chained
                acc[c] = acc[c] + truncate(truncate(p[2]).double() + p[5])
            elif chained:
                run = acc[c].double() if torch.is_tensor(acc[c]) else 0.0
                for q in range(6):
                    run = truncate(run + p[q]).double()
                acc[c] = run.float()
            else:
                small = 0.0
                for q in (0, 1, 3, 4):
                    small = truncate(small + p[q]).double()
                acc[c] = ((acc[c] + truncate(p[2])) + truncate(p[5])) + small.float()
    return torch.complex(acc[0], acc[1]).movedim(-1, axis - 3)


def _dft3_zyx(mats, t):
    for axis in (2, 1, 0):
        t = k1._apply(mats[axis], t, axis)
    return t


def _k1_args(cfg, pre, f):
    ax, ay, az = bt_op._alpha_factors(cfg, pre, pre.rho, pre.sigma)
    args = (pre.rho, pre.gain_w, ax, ay, az, f, pre.beta2,
            pre.dft_inv_axes(), pre.dft_fwd_axes(), pre.norm_l)
    kw = dict(length=cfg.domain_length, b_gamma=cfg.b_gamma, radial_group=cfg.ns_eff)
    return args, kw


def _q(shape, ns, dtype):
    cfg = bt.CollisionConfig(nv=shape[0], nvy=shape[1], nvz=shape[2], ns=ns,
                             impl="fused", fused_scheme="ct", dtype=dtype)
    pre = bt.build_precomp(cfg, "cpu")
    f = torch.as_tensor(bt.bkw_f(cfg.velocity_grid.r_squared(), 6.5), dtype=cfg.real_dtype)
    args, kw = _k1_args(cfg, pre, f)
    return k1.fused_collide_reference(*args, **kw)


# (grid, ns, tolerance in max|Q| of the float64 result): the float32 gates
# of the kernel, 4e-5 at 16^3 (the gain and loss terms cancel there), 1e-5
# beyond
MODEL_CASES = [((16, 16, 16), 6, 4e-5), ((32, 16, 48), 12, 1e-5)]


@pytest.mark.parametrize("shape,ns,tol", MODEL_CASES)
def test_3xtf32_model_holds_the_float32_tolerance(monkeypatch, shape, ns, tol):
    q64 = _q(shape, ns, "float64")
    scale = float(q64.abs().max())
    monkeypatch.setattr(k1, "_dft3", _dft3_zyx)
    monkeypatch.setattr(k1, "_apply", tc_apply)
    q3 = _q(shape, ns, "float32")
    d3 = float((q3.double() - q64).abs().max()) / scale
    miss = {}
    variants = (("single-pass TF32", dict(single=True)), ("chained 3xTF32", dict(chained=True)))
    for name, kw in variants if shape == MODEL_CASES[0][0] else ():  # the cheap grid only
        monkeypatch.setattr(k1, "_apply", lambda m, t, axis, kw=kw: tc_apply(m, t, axis, **kw))
        miss[name] = float((_q(shape, ns, "float32").double() - q64).abs().max()) / scale
    print(f"{shape} Ns={ns}: 3xTF32 model {d3:.3e} max|Q| from float64 (tolerance {tol:g});"
          + "".join(f" {k} {v:.3e};" for k, v in miss.items()))
    assert bool(torch.isfinite(q3).all())
    assert d3 <= tol


def test_tf32_rounding_is_to_nearest_ties_away():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -11 + 2.0 ** -20, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -12, 3.0], dtype=torch.float32)
    want = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0, 3.0])
    assert torch.equal(tf32(x), want)
    # hi + lo carries 22 bits: the split misses a float32 by at most 2^-22
    v = torch.rand(1000, dtype=torch.float32, generator=torch.Generator().manual_seed(3)) + 0.5
    hi, lo = split(v)
    assert float(((hi + lo) - v.double()).abs().div(v.double()).max()) <= 2.0 ** -22


# --------------------------------------------------------------------------
# the split: a 64-point y or z axis as two 8-point stages on DMMA
# --------------------------------------------------------------------------

LANE = np.arange(32)
G, T = LANE // 4, LANE % 4  # lane = 4 g + t


def _a_at(q):  # (row, column) of A fragment value q of every lane
    return G + 8 * (q & 1), T + 4 * (q >> 1)


def _b_at(q):  # (depth, column) of B fragment value q
    return T + 4 * q, G


def _c_at(r):  # (row, column) of accumulator r
    return G + 8 * (r >> 1), 2 * T + (r & 1)


def mma16(c, a, b):
    """``mma_dmma16`` (m16n8k8, ``a`` (32, 4), ``b`` (32, 2)) or
    ``mma_dmma16k16`` (m16n8k16, ``a`` (32, 8), ``b`` (32, 4)) over a warp,
    ``c`` (32, 4), one row per lane, laid out as the kernel's fragments;
    returns the accumulators plus A B (the sums in NumPy's order, which
    differs from the tensor core's by rounding)."""
    depth = 2 * a.shape[1]
    A, B, C = np.zeros((16, depth)), np.zeros((depth, 8)), np.zeros((16, 8))
    for q in range(a.shape[1]):
        A[_a_at(q)] = a[:, q]
    for q in range(b.shape[1]):
        B[_b_at(q)] = b[:, q]
    for r in range(4):
        C[_c_at(r)] = c[:, r]
    d = C + A @ B
    return np.stack([d[_c_at(r)] for r in range(4)], axis=1)


def split_frags(m):
    """``split_frags``: each lane's entries of the dense (64, 64) complex
    matrix ``m`` = c w^(k n): stage 1's A ([W1r; W1i] at depth t and t + 4,
    [-W1i; W1r] at t + 8 and t + 12, W1[k2, n2] = m[k2, 8 n2] / c), the
    twiddles m[g, 2t + h] / c, stage 2's B for the real and the imaginary
    output (re, re, -im, -im and im, im, re, re of m[8 g, 2t + h])."""
    inv_c = 1.0 / m[0, 0].real
    w = [m[G, 8 * (T + 4 * h)] * inv_c for h in (0, 1)]
    a1 = np.stack([w[0].real, w[0].imag, w[1].real, w[1].imag,
                   -w[0].imag, w[0].real, -w[1].imag, w[1].real], axis=1)
    tw = [m[G, 2 * T + h] * inv_c for h in (0, 1)]
    b2 = [m[8 * G, 2 * T + h] for h in (0, 1)]
    b2re = np.stack([b2[0].real, b2[1].real, -b2[0].imag, -b2[1].imag], axis=1)
    b2im = np.stack([b2[0].imag, b2[1].imag, b2[0].real, b2[1].real], axis=1)
    return a1, tw, b2re, b2im


def split_pair(fr, xa, xb, ph=None, fa=1.0, fb=1.0, real=False):
    """``split_pair`` on two lines of 64 complex points: stage 1 (one
    m16n8k16, or m16n8k8 on a real line) and the twiddle per line, stage 2
    (two m16n8k16) on the pair, outputs where the kernel stores them
    (accumulator r: line r // 2, point g + 16 t + 8 (r % 2))."""
    a1, tw, b2re, b2im = fr
    i0 = 8 * T + G
    cs = []
    for x in (xa, xb):
        x0, x1 = x[i0], x[i0 + 32]
        if ph is not None:
            x0, x1 = ph[i0] * x0, ph[i0 + 32] * x1
        if real:
            c = mma16(np.zeros((32, 4)), a1[:, :4], np.stack([x0.real, x1.real], axis=1))
        else:
            b = np.stack([x0.real, x1.real, x0.imag, x1.imag], axis=1)
            c = mma16(np.zeros((32, 4)), a1, b)
        t2 = [tw[h] * (c[:, h] + 1j * c[:, 2 + h]) for h in (0, 1)]
        cs.append(np.stack([t2[0].real, t2[1].real, t2[0].imag, t2[1].imag], axis=1))
    a = np.stack([cs[q][:, r] for r in range(4) for q in (0, 1)], axis=1)
    o_re = mma16(np.zeros((32, 4)), a, b2re)
    o_im = mma16(np.zeros((32, 4)), a, b2im)
    out = np.full((2, 64), np.nan, dtype=complex)
    for r in range(4):
        v = o_re[:, r] + 1j * o_im[:, r]
        if ph is not None:
            v = (fa if r < 2 else fb) * v
        out[r >> 1, G + 16 * T + 8 * (r & 1)] = v
    return out[0], out[1]


def split_plane(m, x, phases=None, real=False):
    """``plane_split_body`` on one (64, 64) plane x[y, z]: z in place (row
    pairs; with ``phases`` = (ax at the plane, ay, az): az folded into the
    input, ax ay into the output), then y in place (column pairs)."""
    fr = split_frags(m)
    buf = x.astype(complex)
    for q in range(32):
        la, lb = 2 * q, 2 * q + 1
        if phases is None:
            buf[la], buf[lb] = split_pair(fr, buf[la], buf[lb], real=real)
        else:
            fx, fy, fz = phases
            buf[la], buf[lb] = split_pair(fr, buf[la], buf[lb], fz, fx * fy[la], fx * fy[lb])
    for q in range(32):
        buf[:, 2 * q], buf[:, 2 * q + 1] = split_pair(fr, buf[:, 2 * q], buf[:, 2 * q + 1])
    return buf


def _dft_pair(n):
    # weights.build_precomp's matrices, complex: forward, inverse
    ph = 2.0 * np.pi * np.outer(np.arange(n), np.arange(n)) / n
    return np.exp(-1j * ph), np.exp(1j * ph) / n


def test_split_fragments_cover_the_mma_tiles_once():
    for at, shape, count in ((_a_at, (16, 8), 4), (_b_at, (8, 8), 2), (_c_at, (16, 8), 4),
                             (_a_at, (16, 16), 8), (_b_at, (16, 8), 4)):
        hits = np.zeros(shape, dtype=int)
        for q in range(count):
            np.add.at(hits, at(q), 1)
        assert (hits == 1).all()
    # the points a thread reads (8 t + g, + 32) and stores (g + 16 t, + 8)
    assert sorted(np.concatenate([8 * T + G, 8 * T + G + 32])) == list(range(64))
    assert sorted(np.concatenate([G + 16 * T, G + 16 * T + 8])) == list(range(64))


def test_split_tables_are_entries_of_the_dense_matrix():
    # W1 and the twiddles divided by c = m[0, 0] (a power of two: exact),
    # stage 2's table as it stands, for the forward and the inverse matrix
    for m, c in zip(_dft_pair(64), (1.0, 1.0 / 64)):
        a1, tw, b2re, b2im = split_frags(m)
        w = np.exp(-2j * np.pi / 64) if c == 1.0 else np.exp(2j * np.pi / 64)
        assert np.allclose(a1[:, 0] + 1j * a1[:, 1], w ** (8 * G * T), rtol=0, atol=1e-13)
        assert np.array_equal(a1[:, 4], -a1[:, 1]) and np.array_equal(a1[:, 5], a1[:, 0])
        assert np.allclose(tw[1], w ** (G * (2 * T + 1)), rtol=0, atol=1e-13)
        assert np.allclose(b2re[:, 0] + 1j * b2im[:, 0], c * w ** (8 * G * 2 * T), rtol=0,
                           atol=1e-13 * c)
        assert np.array_equal(b2re[:, 2:], -b2im[:, :2]) and np.array_equal(b2im[:, 2:], b2re[:, :2])
        assert np.array_equal(a1[:, 0] * c, m[G, 8 * T].real)  # the scale is exact


# The dense matrices' entries are cos and sin of 2 pi k n / 64 for k n up to
# 63^2: their arguments' rounding leaves the dense product up to ~1.6e-14 of
# its largest value from the exact DFT, while the split's tables reach k n of
# at most 392 and it stays within ~2e-15 of it.  So the split is held to the
# exact DFT (np.fft) within 1e-14 and to the dense product within 4e-14.
SPLIT_TO_EXACT, SPLIT_TO_DENSE = 1e-14, 4e-14


def _exact(x, inverse, axis=-1):
    return np.fft.ifft(x, axis=axis) if inverse else np.fft.fft(x, axis=axis)


def _close(got, want, tol):
    return np.isfinite(got).all() and np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("real", [False, True])
def test_split_line_pair_matches_the_dense_product(inverse, real):
    m = _dft_pair(64)[int(inverse)]
    rng = np.random.default_rng(20)
    xa, xb = rng.standard_normal((2, 64)) + (0 if real else 1j * rng.standard_normal((2, 64)))
    ya, yb = split_pair(split_frags(m), xa, xb, real=real)
    for y, x in ((ya, xa), (yb, xb)):
        assert _close(y, m @ x, SPLIT_TO_DENSE)
        assert _close(y, _exact(x, inverse), SPLIT_TO_EXACT)


@pytest.mark.parametrize("inverse", [False, True])
def test_split_plane_with_the_node_phase_matches_the_dense_product(inverse):
    # a node stream's plane: az folded into z's input, ax ay into its output,
    # then y; against the dense products of the plain chain, one plane
    m = _dft_pair(64)[int(inverse)]
    rng = np.random.default_rng(7)
    x = rng.standard_normal((64, 64)) + 1j * rng.standard_normal((64, 64))
    fx, fy, fz = (np.exp(1j * rng.uniform(0, 2 * np.pi, n)) for n in (1, 64, 64))
    got = split_plane(m, x, (fx[0], fy, fz))
    assert _close(got, fx[0] * (m @ (fy[:, None] * ((x * fz[None, :]) @ m.T))), SPLIT_TO_DENSE)
    exact = fx[0] * _exact(fy[:, None] * _exact(x * fz[None, :], inverse), inverse, axis=0)
    assert _close(got, exact, SPLIT_TO_EXACT)
    # a real plane (f, the group sums): no phase, one stage-1 product
    xr = rng.standard_normal((64, 64))
    got = split_plane(m, xr, real=True)
    assert _close(got, m @ xr @ m.T, SPLIT_TO_DENSE)
    assert _close(got, _exact(_exact(xr, inverse), inverse, axis=0), SPLIT_TO_EXACT)


# --------------------------------------------------------------------------
# the float64 dense tile: DMMA m16n8k16 on the stacked complex depth
# --------------------------------------------------------------------------
#
# A warp's 16 x 16 output tile is two m16n8 tiles.  Each k step takes 8
# complex points of the depth as one real product of depth 16 per output
# part: A [Mr -Mi] (Yr) and [Mi Mr] (Yi), B [Xr; Xi]; a real B takes
# m16n8k8, Mr Xr and Mi Xr.  The padded length is a multiple of 16, so the
# steps (np / 8: 2 at 16, 6 at 48, 10 at 80) always go in pairs.


def dense_frags(mp, i0, k0):
    """``load_frags`` + ``mma_frags``: the lanes' A values of the step at
    depth k0 for rows i0 of the padded matrix ``mp``: ar, ai (32, 4) as
    loaded (value q at row g + 8 (q % 2), depth t + 4 (q / 2)), and the
    stacked m16n8k16 operands [ar, -ai] and [ai, ar] (32, 8)."""
    at = [(i0 + G + 8 * (q & 1), k0 + T + 4 * (q >> 1)) for q in range(4)]
    ar = np.stack([mp[a].real for a in at], axis=1)
    ai = np.stack([mp[a].imag for a in at], axis=1)
    return ar, ai, np.concatenate([ar, -ai], axis=1), np.concatenate([ai, ar], axis=1)


def dense_b(xp, k0, col):
    """The lanes' B values of the step at depth k0, columns ``col`` (32,):
    Xr at depths t and t + 4, then Xi at the same depths."""
    x0, x1 = xp[k0 + T, col], xp[k0 + T + 4, col]
    return np.stack([x0.real, x1.real, x0.imag, x1.imag], axis=1)


def dense_product(m, x, real=False):
    """``tile_product`` of the (n, n) complex matrix ``m`` with the (n, C)
    columns ``x`` (C a multiple of 16), zero-padded to pad16(n), one warp
    tile at a time, the accumulators stored where the epilogues take them
    (accumulator r of n8 tile b: row g + 8 (r / 2), column 8 b + 2 t + r % 2)."""
    n, cols = m.shape[0], x.shape[1]
    npd = k1._pad16(n)
    mp = np.zeros((npd, npd), complex)
    mp[:n, :n] = m
    xp = np.zeros((npd, cols), complex)
    xp[:n] = x
    out = np.full((npd, cols), np.nan, complex)
    for i0 in range(0, npd, 16):
        for n0 in range(0, cols, 16):
            acc = np.zeros((2, 2, 32, 4))  # (n8 tile, re / im, lane, r)
            for k0 in range(0, npd, 8):
                ar, ai, are, aim = dense_frags(mp, i0, k0)
                for b in (0, 1):
                    xb = dense_b(xp, k0, n0 + 8 * b + G)
                    if real:
                        acc[b, 0] = mma16(acc[b, 0], ar, xb[:, :2])
                        acc[b, 1] = mma16(acc[b, 1], ai, xb[:, :2])
                    else:
                        acc[b, 0] = mma16(acc[b, 0], are, xb)
                        acc[b, 1] = mma16(acc[b, 1], aim, xb)
            for b in (0, 1):
                for r in range(4):
                    out[i0 + G + 8 * (r >> 1), n0 + 8 * b + 2 * T + (r & 1)] = (
                        acc[b, 0][:, r] + 1j * acc[b, 1][:, r])
    return out[:n]


def test_dense_fragments_cover_the_tile_once():
    # the stacked A covers 16 rows x 16 slots and B 16 slots x 8 columns once
    # (the split's test holds the layouts); each slot is one complex point of
    # the step: slots t + 4 (q / 2) its real part, slots 8 + t + 4 (q / 2) its
    # imaginary part, so every one of the 8 points is met once as each
    a_pts = np.zeros((16, 8, 2), dtype=int)
    for q in range(8):
        row, slot = _a_at(q)
        np.add.at(a_pts, (row, slot % 8, slot // 8), 1)
    b_pts = np.zeros((8, 8, 2), dtype=int)
    for q in range(4):
        slot, col = _b_at(q)
        np.add.at(b_pts, (slot % 8, col, slot // 8), 1)
    assert (a_pts == 1).all() and (b_pts == 1).all()
    # the lanes' loads: A value q (q < 4) and B value q (q < 2) of each n8
    # tile cover the step's 16 rows x 8 points and 8 points x 16 columns once
    hits_a = np.zeros((16, 8), dtype=int)
    for q in range(4):
        np.add.at(hits_a, (G + 8 * (q & 1), T + 4 * (q >> 1)), 1)
    hits_b = np.zeros((8, 16), dtype=int)
    for b in (0, 1):
        for q in (0, 1):
            np.add.at(hits_b, (T + 4 * q, 8 * b + G), 1)
    assert (hits_a == 1).all() and (hits_b == 1).all()
    # the two n8 tiles' accumulators cover the warp's 16 x 16 output once
    hits_c = np.zeros((16, 16), dtype=int)
    for b in (0, 1):
        for r in range(4):
            row, col = _c_at(r)
            np.add.at(hits_c, (row, 8 * b + col), 1)
    assert (hits_c == 1).all()


def test_dense_stacked_planes_are_the_matrix():
    # [Mr -Mi] and [Mi Mr] as the m16n8k16 A tile sees them, against the
    # matrix's 16 x 8 block of the step, for every step of a 48-point inverse
    m = _dft_pair(40)[1]
    mp = np.zeros((48, 48), complex)
    mp[:40, :40] = m
    for i0 in (0, 32):
        for k0 in range(0, 48, 8):
            ar, ai, are, aim = dense_frags(mp, i0, k0)
            A_re, A_im = np.zeros((16, 16)), np.zeros((16, 16))
            for q in range(8):
                A_re[_a_at(q)], A_im[_a_at(q)] = are[:, q], aim[:, q]
            blk = mp[i0:i0 + 16, k0:k0 + 8]
            assert np.array_equal(A_re, np.hstack([blk.real, -blk.imag]))
            assert np.array_equal(A_im, np.hstack([blk.imag, blk.real]))
            assert np.array_equal(are[:, 4:], -ai) and np.array_equal(aim[:, 4:], ar)


# The dense matrices' own distance from the exact DFT grows with k n: up to
# ~1.9e-14 of the largest value at 80 points.  So the model is held to the
# matrix product within 1e-14 (it reads ~1e-15) and to np.fft within
# SPLIT_TO_DENSE, the room this file already gives that distance.
DENSE_TO_MATRIX = 1e-14


@pytest.mark.parametrize("n", [12, 32, 40, 64, 80])  # padded: 16, 32, 48, 64, 80
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("real", [False, True])
def test_dense_tile_matches_the_matrix_product(n, inverse, real):
    m = _dft_pair(n)[int(inverse)]
    rng = np.random.default_rng(n + 2 * inverse + real)
    x = rng.standard_normal((n, 32)) + (0 if real else 1j * rng.standard_normal((n, 32)))
    y = dense_product(m, x, real=real)
    assert _close(y, m @ x, DENSE_TO_MATRIX)
    assert _close(y, _exact(x, inverse, axis=0), SPLIT_TO_DENSE)


# --------------------------------------------------------------------------
# the shared-memory plan
# --------------------------------------------------------------------------


def _source_int(name):
    m = re.search(rf"constexpr int {name} = (\d+);", (CSRC / "spectral_common.cuh").read_text())
    assert m, f"{name} not found in spectral_common.cuh"
    return int(m.group(1))


def test_plan_constants_mirror_the_source():
    assert k1._PAD == _source_int("kPad")
    assert k1._SMEM_LIMIT == _source_int("kSmemLimit")
    assert k1._PLANE_ELEMS == _source_int("kPlaneElems")
    assert k1._MAT_PAD == _source_int("kMatPad")
    assert k1._RAW_PAD == _source_int("kRawPad")
    assert k1._LINE_PAD32 == _source_int("kLinePad32")
    assert k1._LINE_PAD64 == _source_int("kLinePad64")
    assert k1._SPLIT_N == _source_int("kSplitN")
    assert k1._SPLIT_R == _source_int("kSplitR") and k1._SPLIT_R ** 2 == k1._SPLIT_N
    assert k1._SPLIT_PAD == _source_int("kSplitPad")
    text = (CSRC / "spectral_common.cuh").read_text()
    assert "const int cand[3][2] = {{32, 2}, {16, 2}, {16, 1}};" in text
    # the split's rule and block, as the mirror counts them
    assert "return csize == 16 && ny == kSplitN && nz == kSplitN ? kSplitR : 0;" in text
    assert "return ((long long)ny * (nz + kSplitPad) + 1 + ny + nz) * 16;" in text
    assert "threads = 32 * kSplitWarps;" in text
    # the B tiles' row padding, as the mirror counts it
    assert "return csize == 8 ? kLinePad32 : (resident ? kLinePad64 : 0);" in text
    assert "const int ld = lines + tile_pad(csize, resident);" in text
    assert "const int ld_mid = pad16(nz) + tile_pad(csize, true);" in text


# (grid, dtype, route, the split's factor): the split takes 64-point y and z
# axes in float64 only, whatever x is
@pytest.mark.parametrize("shape,dtype,want,split", [
    ((16, 16, 16), torch.float64, "plane", 0),
    ((32, 32, 32), torch.float64, "plane", 0),
    ((64, 64, 64), torch.float64, "plane", 8),
    ((64, 64, 64), torch.float32, "plane", 0),
    ((32, 16, 48), torch.float32, "plane", 0),
    ((12, 12, 12), torch.float32, "plane", 0),
    ((96, 32, 48), torch.float64, "plane", 0),
    ((16, 72, 72), torch.float64, "last pass", 0),
    ((80, 80, 80), torch.float64, "last pass", 0),
    ((16, 96, 96), torch.float32, "last pass", 0),
    ((104, 8, 104), torch.float64, "last pass", 0),
    ((128, 8, 128), torch.float32, "last pass", 0),
    ((104, 8, 8), torch.float64, "plane", 0),
    ((8, 8, 8), torch.float64, "plane", 0),
    ((16, 64, 64), torch.float64, "plane", 8),
    ((96, 64, 64), torch.float64, "plane", 8),
    ((64, 64, 32), torch.float64, "plane", 0),
    ((64, 32, 64), torch.float64, "plane", 0),
])
def test_plan_routes(shape, dtype, want, split):
    assert k1.plan(shape, dtype)[1:] == [-1, 0, split]
    assert k1.route(shape, dtype) == want
    assert k1.split_yz(shape, dtype) == ("8x8" if split else "dense")
    csize = 16 if dtype == torch.float64 else 8
    nx, ny, nz = shape
    p = k1.plane_count(nx, ny, nz, csize)
    if want == "plane":
        assert p >= 1 and nx % p == 0
        assert k1.plane_smem(nx, ny, nz, csize, p) <= k1._SMEM_LIMIT
    else:
        assert p == 0 and k1.plane_smem(nx, ny, nz, csize, 1) > k1._SMEM_LIMIT
    # every pass fits: x gain (2 streams, a real accumulator), beta1 (a
    # complex accumulator) and store; y and z stores on the last-pass route
    passes = [(nx, 2, csize // 2), (nx, 1, csize), (nx, 1, 0)]
    if want != "plane":
        passes += [(ny, 1, 0), (nz, 1, 0)]
    for n, streams, acc in passes:
        lines, nbuf, resident, b = k1.line_plan(n, streams, acc, csize)
        assert lines in (16, 32) and nbuf in (1, 2)
        assert b == k1.line_smem(n, streams, acc, csize, lines, nbuf, resident)
        assert b <= k1._SMEM_LIMIT
        # the matrix stays in shared memory up to 96 points
        assert resident or n > 96


def test_every_axis_the_cuda_core_kernel_took_still_fits():
    # The CUDA-core kernel before the tensor-core one took every even axis
    # whose (n, n) matrix and (n, 33) tile fit: n <= 104 in float64, 154 in
    # float32.  Over 96 points the line passes read the matrix from device
    # memory, so each of those grids still has a route.
    for dtype, top in ((torch.float64, 104), (torch.float32, 154)):
        csize = 16 if dtype == torch.float64 else 8
        for n in range(2, top + 1, 2):
            for shape in ((n, n, n), (n, 8, 8), (8, 8, n), (8, n, 16)):
                assert k1.route(shape, dtype) is not None, (shape, dtype)
                k1.check_grid(shape, dtype)
        assert k1.line_plan(96, 2, csize // 2, csize)[2]
        assert not k1.line_plan(top, 2, csize // 2, csize)[2]


@pytest.mark.parametrize("shape,dtype,axis", [((368, 16, 16), torch.float64, 0),
                                              ((528, 16, 16), torch.float32, 0),
                                              ((16, 16, 912), torch.float64, 2)])
def test_check_grid_raises_where_no_tile_fits(shape, dtype, axis):
    route_, failed, nbytes, split = k1.plan(shape, dtype)
    assert route_ == 0 and failed == axis and nbytes > k1._SMEM_LIMIT and split == 0
    with pytest.raises(ValueError, match="shared memory"):
        k1.check_grid(shape, dtype)


def test_plane_blocks_stay_under_the_point_budget():
    for n in (8, 12, 16, 24, 32, 40, 48, 64):
        for dtype in (torch.float32, torch.float64):
            csize = 16 if dtype == torch.float64 else 8
            p = k1.plane_count(n, n, n, csize)
            assert p >= 1 and n % p == 0
            assert p == 1 or p * k1._pad16(n) ** 2 <= k1._PLANE_ELEMS
            # a split block holds one plane of the padded rows, no matrix
            if k1.plane_split(n, n, csize):
                assert p == 1 and k1.plane_smem(n, n, n, csize, p) == k1.split_smem(n, n)


# (n, dtype, the split's factor, the plane block's bytes): 64^3 in float64
# takes the split (one plane of 64 rows of 65 points and the phase rows:
# 68,624 B) in place of the dense block (the 64 x 68 matrix, the input and
# z-pass planes: 207,872 B); float32 at 64^3, 16^3 and 8^3 keep the dense
# block as before, float64 at 16^3 and 8^3 too, with the z-pass planes' rows
# padded by kLinePad64 (8 planes x 16 rows x 2 points x 16 B more)
@pytest.mark.parametrize("n,dtype,split,smem", [
    (64, torch.float64, 8, 68_624),
    (64, torch.float32, 0, 142_848),
    (16, torch.float64, 0, 83_712),
    (16, torch.float32, 0, 50_560),
    (8, torch.float64, 0, 83_456),
    (8, torch.float32, 0, 50_432),
])
def test_split_block_replaces_the_dense_block_at_64(n, dtype, split, smem):
    csize = 16 if dtype == torch.float64 else 8
    p = k1.plane_count(n, n, n, csize)
    assert k1.plane_split(n, n, csize) == split
    assert k1.plane_smem(n, n, n, csize, p) == smem <= k1._SMEM_LIMIT
    assert k1.plan((n, n, n), dtype) == [1, -1, 0, split]
    if split:
        assert p == 1 and smem == (n * (n + k1._SPLIT_PAD) + 1 + 2 * n) * 16
        # three blocks share an SM's 228 KB (1 KB of it reserved per block);
        # the dense block it replaces took one
        assert 3 * (smem + 1024) <= 233_472
        dense = k1.mat_bytes(n) + n * (2 * n + 4) * 16 + 3 * n * 16  # the tile it replaces
        assert dense == 207_872 and 2 * (dense + 1024) > 233_472


# --------------------------------------------------------------------------
# the SASS count
# --------------------------------------------------------------------------

SASS = """
        code for sm_90a
                Function : _ZN4bfft15line_dft_kernelIdLb0ELi2ELi1EEEvNS_8LineArgsIT_EE
        /*0100*/                   DMMA.884 R4, R8, R10, R4 ;
        /*0110*/                   DMMA.884 R12, R8, R14, R12 ;
        /*0120*/                   DFMA R2, R4, R6, R2 ;
                Function : _ZN4bfft15line_dft_kernelIdLb1ELi1ELi0EEEvNS_8LineArgsIT_EE
        /*0100*/                   DMMA.884 R4, R8, R10, R4 ;
                Function : _ZN4bfft16plane_dft_kernelIfLb0EEEvNS_9PlaneArgsIT_EE
        /*0100*/                   HMMA.1688.F32.TF32 R4, R8, R10, R4 ;
        /*0110*/                   FADD R1, R2, R3 ;
                Function : _ZN12_GLOBAL__N_118oz_contract_kernelEPKfi
        /*0100*/                   HMMA.16816.F32.BF16 R4, R8, R10, R4 ;
        /*0110*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ ;
                Function : _ZN12_GLOBAL__N_113assemble_kernelIdEEvPKdS2_Pdx
        /*0100*/                   DMMA.884 R4, R8, R10, R4 ;
"""


def test_count_tc_reads_the_sass():
    counts = _build.count_tc(SASS)
    assert counts == {
        "line_dft_kernel<double>": {"HMMA": 0, "HGMMA": 0, "DMMA": 3},
        "plane_dft_kernel<float>": {"HMMA": 1, "HGMMA": 0, "DMMA": 0},
        "oz_contract_kernel": {"HMMA": 1, "HGMMA": 1, "DMMA": 0},
    }


SASS_SHAPES = """
        code for sm_90a
                Function : _ZN4bfft15line_dft_kernelIdLb0ELi2ELi1ELb0EEEvNS_8LineArgsIT_EE
        /*0100*/                   DMMA.16x8x16 R4, R8, R12, R4 ;
        /*0110*/                   DMMA.16x8x16 R20, R24, R12, R20 ;
                Function : _ZN4bfft16plane_dft_kernelIdLb1ELb0EEEvNS_9PlaneArgsIT_EE
        /*0100*/                   DMMA.16x8x8 R4, R8, R10, R4 ;
                Function : _ZN4bfft16plane_dft_kernelIfLb0ELb0EEEvNS_9PlaneArgsIT_EE
        /*0100*/                   HMMA.1688.F32.TF32 R4, R8, R10, R4 ;
                Function : _ZN4bfft16plane_dft_kernelIdLb0ELb0EEEvNS_9PlaneArgsIT_EE
        /*0100*/                   DMMA.8x8x4 R4, R8, R10, R4 ;
                Function : _ZN12_GLOBAL__N_113assemble_kernelIdEEvPKdS2_Pdx
        /*0100*/                   DMMA.884 R4, R8, R10, R4 ;
"""


def test_dmma_shapes_reads_the_sass():
    # per instance of a transform, its template arguments spelled out; other
    # kernels are not counted
    assert _build.dmma_shapes(SASS_SHAPES) == {
        "line_dft_kernel<double,false,2,1,false>": {"16x8x16": 2},
        "plane_dft_kernel<double,true,false>": {"16x8x8": 1},
        "plane_dft_kernel<float,false,false>": {},
        "plane_dft_kernel<double,false,false>": {"8x8x4": 1},
    }
    assert _build.dmma_shapes("") == {}


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_plan_mirror_matches_the_library(cuda_device):
    lib = _build.load_library()
    for shape in [(16, 16, 16), (32, 32, 32), (64, 64, 64), (32, 16, 48), (12, 12, 12),
                  (8, 10, 12), (96, 32, 48), (16, 72, 72), (16, 96, 96), (80, 80, 80),
                  (112, 16, 16), (128, 128, 128), (104, 8, 104), (128, 8, 128),
                  (368, 16, 16), (528, 16, 16), (16, 16, 912), (8, 8, 8), (16, 64, 64),
                  (64, 64, 32)]:
        for dtype in (torch.float32, torch.float64):
            out = (ctypes.c_int * 4)()
            assert lib.bfft_k1_plan(*shape, int(dtype == torch.float64),
                                    ctypes.cast(out, ctypes.c_void_p)) == 0
            assert list(out) == k1.plan(shape, dtype), (shape, dtype)


@pytest.mark.cuda
def test_transforms_run_on_the_tensor_cores(cuda_device):
    _build.load_library()
    line = next(ln for ln in _build.BUILD_LOG.read_text().splitlines()
                if ln.startswith("# tensor-core instructions"))
    counts = ast.literal_eval(line.split(": ", 1)[1])
    for kernel in ("line_dft_kernel", "plane_dft_kernel"):
        assert counts[f"{kernel}<double>"]["DMMA"] > 0
        assert counts[f"{kernel}<float>"]["HMMA"] > 0
    # every double instance of K1's transforms on m16n8k16 / m16n8k8, none on
    # m8n8k4: the dense tile's complex steps (16x8x16), a real B (16x8x8)
    line = next(ln for ln in _build.BUILD_LOG.read_text().splitlines()
                if ln.startswith("# DMMA shapes"))
    shapes = ast.literal_eval(line.split(": ", 1)[1])
    doubles = {k: v for k, v in shapes.items()
               if k.startswith(("line_dft_kernel<double", "plane_dft_kernel<double"))}
    assert doubles and all(sum(v.values()) > 0 and "8x8x4" not in v for v in doubles.values())
    assert "16x8x16" in shapes["plane_dft_kernel<double,false,false>"]
    assert "16x8x16" in shapes["line_dft_kernel<double,false,2,1,false>"]


# --------------------------------------------------------------------------
# on the card: K1 on the dense tile, 16^3 (the TG-2D batch) and 32^3
# --------------------------------------------------------------------------


def _bkw_batch(dev, n, batch, dtype="float64"):
    """K1's arguments at n^3, Ns = 12, on ``batch`` distributions: the BKW
    state at t = 6.5 scaled by 1 + 1e-3 i (``tools/k1_ab.py``'s inputs)."""
    cfg = bt.CollisionConfig(nv=n, ns=12, impl="fused", dtype=dtype)
    pre = bt.build_precomp(cfg, dev)
    f = torch.as_tensor(bt.bkw_f(cfg.velocity_grid.r_squared(), 6.5), dtype=cfg.real_dtype,
                        device=dev)
    if batch > 1:
        scale = 1.0 + 1e-3 * torch.arange(batch, dtype=cfg.real_dtype, device=dev)
        f = scale[:, None, None, None] * f
    args, kw = _k1_args(cfg, pre, f)
    return cfg, pre, args, kw


@pytest.mark.cuda
@pytest.mark.parametrize("n,batch", [(16, 256), (32, 2)])
def test_k1_dense_tile_matches_plain_bitwise_by_batch_and_chunk(cuda_device, n, batch):
    from boltzfft_torch import obs

    cfg, pre, args, kw = _bkw_batch(cuda_device, n, batch)
    q = k1.fused_collide(*args, **kw)
    note = obs.summary()["counters"]["k1_plan"][f"{batch}x{n}x{n}x{n}"]
    assert note["split_yz"] == "dense" and note["dense_tile"] == "m16n8k16"
    q_ref = k1.fused_collide_reference(*args, **kw)
    assert bool(torch.isfinite(q).all())
    assert float((q - q_ref).abs().max()) <= 1e-12 * float(q_ref.abs().max())
    for i in (0, batch - 1):
        one = list(args)
        one[5] = args[5][i]
        assert torch.equal(k1.fused_collide(*one, **kw), q[i])
    # one radial group a chunk against the whole node set in one
    assert torch.equal(k1.fused_collide(*args, chunk=cfg.ns_eff, **kw), q)


# sha256 (16 hex digits) of K1's float32 Q on _bkw_batch's inputs, from the
# parent of the float64 m16n8k16 tile (tools/k1_ab.py, H100): float32 keeps
# its 3xTF32 tile bit for bit
F32_DIGESTS = {(16, 256): "281e506410efd0ea", (32, 1): "b9b60aeb5776dfbf",
               (64, 1): "a01d23594cebfa9b"}


@pytest.mark.cuda
@pytest.mark.parametrize("n,batch", sorted(F32_DIGESTS))
def test_k1_float32_keeps_its_bits(cuda_device, n, batch):
    import hashlib

    from boltzfft_torch import obs

    _cfg, _pre, args, kw = _bkw_batch(cuda_device, n, batch, "float32")
    q = k1.fused_collide(*args, **kw)
    note = obs.summary()["counters"]["k1_plan"][f"{batch}x{n}x{n}x{n}"]
    assert note["dense_tile"] == "3xtf32"
    digest = hashlib.sha256(q.cpu().numpy().tobytes()).hexdigest()[:16]
    assert digest == F32_DIGESTS[(n, batch)]


# --------------------------------------------------------------------------
# on the card: K1, K2 and K4 at 64^3 in float64, where y and z take the split
# --------------------------------------------------------------------------


def _bkw64(dev, **kw):
    cfg = bt.CollisionConfig(nv=64, ns=12, impl="fused", **kw)
    pre = bt.build_precomp(cfg, dev)
    f = torch.as_tensor(bt.bkw_f(cfg.velocity_grid.r_squared(), 6.5), dtype=cfg.real_dtype,
                        device=dev)
    return cfg, pre, f


@pytest.mark.cuda
def test_k1_at_64_takes_the_split_and_matches_plain(cuda_device):
    from boltzfft_torch import obs

    cfg, pre, f = _bkw64(cuda_device)
    fs = torch.stack([f, 0.8 * f])
    args, kw = _k1_args(cfg, pre, fs)
    q = k1.fused_collide(*args, **kw)
    note = obs.summary()["counters"]["k1_plan"]["2x64x64x64"]
    assert note["split_yz"] == "8x8" and note["chunks_per_eval"] >= 1
    assert note["dense_tile"] == "m16n8k16"  # the x passes
    q_ref = k1.fused_collide_reference(*args, **kw)
    assert bool(torch.isfinite(q).all())
    assert float((q - q_ref).abs().max()) <= 1e-12 * float(q_ref.abs().max())


@pytest.mark.cuda
def test_k1_at_64_batch_and_chunks_are_bitwise(cuda_device):
    cfg, pre, f = _bkw64(cuda_device)
    fs = torch.stack([f, 0.8 * f])
    args, kw = _k1_args(cfg, pre, fs)
    q = k1.fused_collide(*args, **kw)
    assert torch.equal(q, k1.fused_collide(*args, **kw))
    for i in (0, 1):
        one = list(args)
        one[5] = fs[i]
        assert torch.equal(k1.fused_collide(*one, **kw), q[i])
    # one radial group a chunk (32 chunks) against the whole node set
    assert torch.equal(k1.fused_collide(*args, chunk=cfg.ns_eff, **kw), q)
    assert torch.equal(k1.fused_collide(*args, chunk=pre.rho.shape[0], **kw), q)


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", ["ct", "transpose"])
def test_k2_k4_at_64_match_plain(cuda_device, scheme):
    from boltzfft_torch.kernels import fused_gain_dft as k24

    cfg, pre, f = _bkw64(cuda_device, fused_scheme=scheme)
    fh = torch.fft.fftn(torch.stack([f, 0.8 * f]).to(cfg.complex_dtype), dim=(-3, -2, -1))
    ax, ay, az = bt_op._alpha_factors(cfg, pre, pre.rho, pre.sigma)
    args = (pre.rho, pre.gain_w, ax, ay, az, fh, pre.dft_inv_axes(), pre.dft_fwd_axes(),
            pre.norm_l)
    kw = dict(length=cfg.domain_length, b_gamma=cfg.b_gamma, radial_group=cfg.ns_eff)
    q = k24.fused_gain_dft(*args, scheme=scheme, **kw)
    one = list(args)
    one[5] = fh[1]
    assert torch.equal(k24.fused_gain_dft(*one, scheme=scheme, **kw), q[1])
    q_ref = k24.fused_gain_dft_reference(*args, **kw)
    assert float((q - q_ref).abs().max()) <= 1e-12 * float(q_ref.abs().max())


@pytest.mark.cuda
def test_maxwell_bkw_rk4_at_64_keeps_its_digits(cuda_device, capsys):
    # 10 RK4 steps of 0.125 from t = 5.5 through K1: the time step's error
    # against the analytic BKW f(6.75), 2.1834e-07 of max f before the split
    from boltzfft_torch.cli import maxwell_bkw

    assert maxwell_bkw.main(["--Nv", "64", "--Ns", "12", "--impl", "fused", "--steps", "10",
                             "--device", "cuda"]) == 0
    out = capsys.readouterr().out
    linf = float(re.search(r"Linf error: (\S+)", out).group(1))
    cfg = bt.CollisionConfig(nv=64, ns=12)
    f_end = bt.bkw_f(cfg.velocity_grid.r_squared(), 6.75)
    assert f"{linf / float(np.abs(f_end).max()):.4e}" == "2.1834e-07"
