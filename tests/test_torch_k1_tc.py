"""K1's axis transforms on the tensor cores (``boltzfft_torch/csrc/
spectral_common.cuh``), checked on the CPU: a model of the float32 product,
the shared-memory plan's mirror, and the SASS count; on a card only, the
plan against the library's own and the tensor-core instructions.

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
    text = (CSRC / "spectral_common.cuh").read_text()
    assert "const int cand[3][2] = {{32, 2}, {16, 2}, {16, 1}};" in text


@pytest.mark.parametrize("shape,dtype,want", [
    ((16, 16, 16), torch.float64, "plane"),
    ((32, 32, 32), torch.float64, "plane"),
    ((64, 64, 64), torch.float64, "plane"),
    ((64, 64, 64), torch.float32, "plane"),
    ((32, 16, 48), torch.float32, "plane"),
    ((12, 12, 12), torch.float32, "plane"),
    ((96, 32, 48), torch.float64, "plane"),
    ((16, 72, 72), torch.float64, "last pass"),
    ((80, 80, 80), torch.float64, "last pass"),
    ((16, 96, 96), torch.float32, "last pass"),
    ((104, 8, 104), torch.float64, "last pass"),
    ((128, 8, 128), torch.float32, "last pass"),
    ((104, 8, 8), torch.float64, "plane"),
])
def test_plan_routes(shape, dtype, want):
    assert k1.plan(shape, dtype)[1:] == [-1, 0]
    assert k1.route(shape, dtype) == want
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
    route_, failed, nbytes = k1.plan(shape, dtype)
    assert route_ == 0 and failed == axis and nbytes > k1._SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        k1.check_grid(shape, dtype)


def test_plane_blocks_stay_under_the_point_budget():
    for n in (8, 12, 16, 24, 32, 40, 48, 64):
        for dtype in (torch.float32, torch.float64):
            p = k1.plane_count(n, n, n, 16 if dtype == torch.float64 else 8)
            assert p >= 1 and n % p == 0
            assert p == 1 or p * k1._pad16(n) ** 2 <= k1._PLANE_ELEMS


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
                  (368, 16, 16), (528, 16, 16), (16, 16, 912)]:
        for dtype in (torch.float32, torch.float64):
            out = (ctypes.c_int * 3)()
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
