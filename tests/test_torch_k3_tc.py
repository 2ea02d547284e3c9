"""K3's y/z GEMM on the tensor cores (``boltzfft_torch/csrc/
fused_gain_kron.cu``), checked on the CPU: a model of its products held to
boltzfft's kron gain, the GEMM plan's mirror, the entry's ctypes signature
and the SASS count; on a card only, the plan against the library's own.

The model (``tc_matmul``) runs each product as the kernel does, the data
rows first: in float64 DMMA's order (m16n8k8: k in steps of 8, Ar B on
every tile, then Ai B), in float32 3xTF32 (each operand split hi = tf32(a), lo =
tf32(a - hi); each k8 step puts each hi*hi product into a zeroed fragment of
its own and chains the four small ones into a third, then float adds gather
them).  The tensor core's adder truncates: a fragment is the exact sum of its
products truncated to float32 (``truncate32``, K1's model's rule).  Patched into
``fused_gain_kron_reference`` for the y/z GEMM and for the x leg (K1's line
pass, the matrix first), the float32 model must stay within 1e-5
max|Q_gain_hat| of boltzfft's float64 ``fused_gain(scheme="kron")`` (interpret
mode) and the float64 model within 1e-12; chaining every product of the k
loop into one fragment misses the float32 tolerance, which is why the kernel
does not.

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_k3_tc.py -m cuda
"""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_k1_tc import split

import boltzfft_torch as bt
from boltzfft_torch import _build
from boltzfft_torch import operator as bt_op
from boltzfft_torch.kernels import fused_collide as k1
from boltzfft_torch.kernels import fused_gain as k3

SOURCE = Path(__file__).resolve().parents[1] / "boltzfft_torch" / "csrc" / "fused_gain_kron.cu"
TOL = {"float64": 1e-12, "float32": 1e-5}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The models run many small products and elementwise passes, which
    torch's thread pool makes slower, and beside other test workers stalls:
    one thread while this module runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def truncate32(x: torch.Tensor) -> torch.Tensor:
    """float64 to float32, toward zero: the tensor core's adder (``truncate``
    of K1's model, as a bit mask: exact for float32's normal range)."""
    return (x.view(torch.int64) & ~0x1FFFFFFF).view(torch.float64).float()


def _chunk_dots(a, b, k0, k1, step):
    """a[..., k] b[k, :] summed over each step-deep chunk of [k0, k1), exactly
    (float64): (chunks, rows, L) for a (rows, K)."""
    c = (k1 - k0) // step
    a_c = a[:, k0:k1].reshape(a.shape[0], c, step).transpose(0, 1)
    return torch.matmul(a_c, b[k0:k1].reshape(c, step, b.shape[1]))


def tc_matmul(a: torch.Tensor, b: torch.Tensor, chained: bool = False) -> torch.Tensor:
    """a (..., N, K) @ b (K, L), complex, as the tensor cores form it with
    ``a`` the first operand (``chained``: 3xTF32 with every product of the k
    loop chained in one fragment).  The chunk products are formed 8 chunks
    at a time; the accumulation runs chunk by chunk, in the kernel's order."""
    shape = a.shape[:-1] + b.shape[-1:]
    a = a.reshape(-1, a.shape[-1])
    k, block = a.shape[-1], 64
    if a.dtype == torch.complex128:
        ar, ai, br, bi = a.real, a.imag, b.real, b.imag
        re = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float64)
        im = torch.zeros_like(re)
        for k0 in range(0, k, block):
            k1 = min(k, k0 + block)
            dots = [_chunk_dots(x, y, k0, k1, 8) for x, y in ((ar, br), (ar, bi), (-ai, bi), (ai, br))]
            for c in range(dots[0].shape[0]):
                re = re + dots[0][c]
                im = im + dots[1][c]
                re = re + dots[2][c]
                im = im + dots[3][c]
        return torch.complex(re, im).reshape(shape)
    arh, arl = split(a.real)
    aih, ail = split(a.imag)
    brh, brl = split(b.real)
    bih, bil = split(b.imag)
    # each component: its two hi*hi products, then the four small ones in
    # the kernel's order (bfft::tf32_cmac)
    terms = (((arh, brh), (-aih, bih), ((arl, brh), (arh, brl), (-ail, bih), (-aih, bil))),
             ((arh, bih), (aih, brh), ((arl, bih), (arh, bil), (ail, brh), (aih, brl))))
    out = []
    for hh1, hh2, small in terms:
        acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
        for k0 in range(0, k, block):
            k1 = min(k, k0 + block)
            d1, d2 = (_chunk_dots(*pair, k0, k1, 8) for pair in (hh1, hh2))
            ds = [_chunk_dots(*pair, k0, k1, 8) for pair in small]
            if chained:
                for c in range(d1.shape[0]):
                    run = acc.double()
                    for d in (ds[0], ds[1], d1, ds[2], ds[3], d2):
                        run = truncate32(run + d[c]).double()
                    acc = run.float()
            else:
                part = truncate32(ds[0])
                for d in ds[1:]:
                    part = truncate32(part.double() + d)
                h1, h2 = truncate32(d1), truncate32(d2)
                for c in range(d1.shape[0]):
                    acc = ((acc + h1[c]) + h2[c]) + part[c]
        out.append(acc)
    return torch.complex(out[0], out[1]).reshape(shape)


def _patch(monkeypatch, chained=False):
    """The kernel's products in K3's plain version: the y/z GEMM (data rows
    first) and the x leg (K1's line pass: the matrix first)."""

    def x_product(m, t):
        c, nx, nyz = t.shape
        lines = t.permute(1, 0, 2).reshape(nx, c * nyz)
        return tc_matmul(m, lines, chained).reshape(nx, c, nyz).permute(1, 0, 2)

    monkeypatch.setattr(k3, "_yz_product", lambda a, k: tc_matmul(a, k, chained))
    monkeypatch.setattr(k3, "_x_product", x_product)


# (config kwargs, the BKW times of the batch)
CASES = {
    "16^3 Ns=12 E=3": (dict(nv=16, ns=12), (6.5, 7.0, 8.0)),
    "(8,12,16) Ns=6": (dict(nv=8, nvy=12, nvz=16, ns=6), (6.5,)),
}


@pytest.fixture(scope="module")
def jax_kron():
    """boltzfft's float64 kron gain of each case's batch, item by item
    (interpret mode), with its Precomp as NumPy and the distributions."""
    import jax.numpy as jnp

    import boltzfft as bz
    from boltzfft import pallas_kernels as pk

    cache = {}

    def get(name):
        if name not in cache:
            kw, times = CASES[name]
            cfg = bz.CollisionConfig(impl="fused", fused_scheme="kron", **kw)
            pre = bz.build_precomp(cfg)
            ax, ay, az = bz.operator._alpha_factors(cfg, pre, pre.rho, pre.sigma)
            fs = np.stack([bt.bkw_f(cfg.velocity_grid.r_squared(), t) for t in times])
            q = np.stack([np.asarray(pk.fused_gain(
                pre.rho, pre.gain_w, ax, ay, az, jnp.asarray(np.fft.fftn(f)),
                pre.dft_inv_axes(), pre.dft_fwd_axes(), pre.norm_l,
                length=cfg.domain_length, b_gamma=cfg.b_gamma, nodes_per_step=24,
                scheme="kron", radial_group=cfg.ns_eff)) for f in fs])
            pre_np = {k: None if v is None else np.asarray(v) for k, v in pre._asdict().items()}
            cache[name] = (pre_np, fs, q)
        return cache[name]

    return get


def _model_gain(monkeypatch, jax_kron, name, dtype, chained=False):
    """(max |model - boltzfft| in units of max|Q_gain_hat|, the model's
    result): K3's plain version with the kernel's products patched in."""
    pre_np, fs, q_j = jax_kron(name)
    cfg = bt.CollisionConfig(impl="fused", dtype=dtype, **CASES[name][0])
    pre = bt.precomp_from_numpy(pre_np, device="cpu", dtype=dtype)
    f_hat = torch.fft.fftn(torch.as_tensor(fs).to(cfg.complex_dtype), dim=(-3, -2, -1))
    _patch(monkeypatch, chained)
    q = k3.fused_gain_kron_reference(
        pre.rho, pre.gain_w, bt_op._kron_tables(cfg, pre), f_hat, pre.norm_l,
        length=cfg.domain_length, b_gamma=cfg.b_gamma, radial_group=cfg.ns_eff)
    monkeypatch.undo()
    d = float(np.abs(q.numpy().astype(np.complex128) - q_j).max() / np.abs(q_j).max())
    return d, q


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", list(CASES))
def test_tc_model_holds_boltzfft_kron_gain(monkeypatch, jax_kron, name, dtype):
    d, q = _model_gain(monkeypatch, jax_kron, name, dtype)
    print(f"{name} {dtype}: tensor-core model {d:.3e} max|Q_gain_hat| from boltzfft"
          f" (tolerance {TOL[dtype]:g})")
    assert q.shape == jax_kron(name)[2].shape and bool(torch.isfinite(torch.view_as_real(q)).all())
    assert d <= TOL[dtype]


@pytest.mark.parametrize("name", list(CASES))
def test_chained_3xtf32_misses_the_float32_tolerance(monkeypatch, jax_kron, name):
    # the first design of K1's float32 tile: every product of the k loop in
    # one fragment, whose truncating adder biases the (Ny Nz)-deep sums
    d, _ = _model_gain(monkeypatch, jax_kron, name, "float32", chained=True)
    print(f"{name}: chained 3xTF32 {d:.3e} max|Q_gain_hat| from boltzfft (tolerance 1e-5)")
    assert d > TOL["float32"]


def test_tc_matmul_against_float64():
    # the model itself: DMMA order is float64 to rounding; 3xTF32 with its
    # zeroed fragments keeps float32's digits over a 768-deep product, the
    # chained variant drifts low (truncation toward zero)
    g = torch.Generator().manual_seed(5)
    a = torch.complex(torch.rand(24, 768, generator=g, dtype=torch.float64),
                      torch.rand(24, 768, generator=g, dtype=torch.float64))
    b = torch.complex(torch.rand(768, 16, generator=g, dtype=torch.float64),
                      torch.rand(768, 16, generator=g, dtype=torch.float64))
    exact = a @ b
    scale = float(exact.abs().max())
    assert float((tc_matmul(a, b) - exact).abs().max()) <= 1e-14 * scale
    a32, b32 = a.to(torch.complex64), b.to(torch.complex64)
    exact32 = a32.to(torch.complex128) @ b32.to(torch.complex128)
    split3 = float((tc_matmul(a32, b32).to(torch.complex128) - exact32).abs().max()) / scale
    chained = tc_matmul(a32, b32, chained=True).to(torch.complex128) - exact32
    print(f"3xTF32 {split3:.3e}, chained {float(chained.abs().max()) / scale:.3e} of max|ab|")
    assert split3 <= 2e-6
    assert float(chained.imag.max()) < 0 and float(chained.abs().max()) / scale > 5 * split3


# --------------------------------------------------------------------------
# the GEMM plan, the entry's signature, the SASS count
# --------------------------------------------------------------------------


def _source_int(name):
    m = re.search(rf"constexpr int {name} = (\d+);", SOURCE.read_text())
    assert m, f"{name} not found in fused_gain_kron.cu"
    return int(m.group(1))


def test_gemm_plan_constants_mirror_the_source():
    text = SOURCE.read_text()
    assert k3._RESIDENT_K == _source_int("kResidentK")
    # 8 warps of 32 x 32 output tiles; units 128 x 64 by 16 (resident), 64 x
    # 128 by 32 (streamed); chunk rows padded by kMatPad; the row table
    assert (_source_int("kGemmWarps"), _source_int("kWarpM"), _source_int("kWarpN")) == (8, 32, 32)
    for body in ("gemm_bm(bool resident) { return resident ? 128 : 64; }",
                 "gemm_bn(bool resident) { return resident ? 64 : 128; }",
                 "gemm_bk(bool resident) { return resident ? 16 : 32; }",
                 "const int ld = bk + bfft::kMatPad, kp = (k + bk - 1) / bk * bk;",
                 "const long long rows = 2LL * bm * (8 + 4);"):
        assert body in text, body


@pytest.mark.parametrize("nyz,want", [
    (16, [1, 90_112, 1, 16]),
    (64, [1, 154_624, 1, 64]),     # 8^3, the default kron route
    (80, [0, 222_720, 1, 96]),     # (8, 8, 10)
    (144, [0, 222_720, 2, 160]),   # 12^3
    (192, [0, 222_720, 2, 192]),   # (8, 12, 16)
    (256, [0, 222_720, 2, 256]),   # 16^3, the TG-2D stack
    (768, [0, 222_720, 6, 768]),   # (16, 16, 48)
])
def test_kron_plan(nyz, want):
    assert k3.kron_plan(nyz) == want
    assert want[1] <= k1._SMEM_LIMIT
    # the streamed tile does not grow with the plane: every grid's GEMM fits
    assert k3.kron_plan(4096)[1] == k3.kron_plan(256)[1]


@pytest.mark.parametrize("shape,dtype", [((528, 16, 16), torch.float32),
                                         ((368, 16, 16), torch.float64)])
def test_check_kron_grid_raises_where_the_x_tile_does_not_fit(shape, dtype):
    with pytest.raises(ValueError, match="x axis of .* shared memory"):
        k3.check_kron_grid(shape, dtype)
    k3.check_kron_grid((16, 16, 48), dtype)
    k3.check_kron_grid((8, 64, 64), dtype)


def test_kron_entry_argtypes_match_the_macro():
    # the f32/f64 entries come from BFFT_KRON_ENTRY: one ctypes type per C
    # parameter, in order (a short list passes garbage through the stack)
    m = re.search(r'extern "C" int NAME\(([^)]*)\)', SOURCE.read_text())
    params = [p.strip() for p in m.group(1).replace("\\", " ").split(",")]
    kinds = {"void*": ctypes.c_void_p, "int": ctypes.c_int, "double": ctypes.c_double}
    types = [kinds[re.sub(r"\bconst\b|\w+$", "", p).replace(" ", "")] for p in params]
    assert types == _build._ENTRY_ARGS["bfft_fused_gain_kron"]
    assert "ksplit" in m.group(1)


SASS = """
        code for sm_90a
                Function : _ZN12_GLOBAL__N_116kron_gemm_kernelIdLb0EEEvNS_8GemmArgsIT_EE
        /*0100*/                   DMMA.884 R4, R8, R10, R4 ;
        /*0110*/                   DMMA.884 R12, R8, R14, R12 ;
                Function : _ZN12_GLOBAL__N_116kron_gemm_kernelIfLb1EEEvNS_8GemmArgsIT_EE
        /*0100*/                   HMMA.1688.F32.TF32 R4, R8, R10, R4 ;
        /*0110*/                   FADD R1, R2, R3 ;
                Function : _ZN12_GLOBAL__N_119split_matrix_kernelIfEEvPKNS_4CplxIT_E4typeEiiPNS_6PlanesIS2_E4typeE
        /*0100*/                   FADD R1, R2, R3 ;
"""


def test_count_tc_reads_the_kron_gemm():
    assert _build.count_tc(SASS) == {
        "kron_gemm_kernel<double>": {"HMMA": 0, "HGMMA": 0, "DMMA": 2},
        "kron_gemm_kernel<float>": {"HMMA": 1, "HGMMA": 0, "DMMA": 0},
    }


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------


@pytest.mark.cuda
def test_kron_plan_mirror_matches_the_library():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    lib = _build.load_library()
    for nyz in (4, 16, 36, 64, 80, 120, 144, 192, 256, 768, 1024, 4096):
        out = (ctypes.c_int * 4)()
        assert lib.bfft_kron_plan(nyz, ctypes.cast(out, ctypes.c_void_p)) == 0
        assert list(out) == k3.kron_plan(nyz), nyz
