"""K3: the gain spectrum Q_gain_hat by the Kronecker ("kron") scheme in one
hand-written CUDA kernel, and its plain PyTorch version; and
:func:`fused_gain`, the gain-only dispatcher over the fused schemes (K2, K3,
K4) with the ``"auto"`` rule :func:`pick_scheme`.

Counterpart of ``boltzfft/pallas_kernels.py``'s ``fused_gain(scheme="kron")``
-> ``_fused_gain_kron_kernel``.  :func:`fused_gain_kron` dispatches on the
device of ``f_hat``: a CUDA tensor runs the kernel of
``csrc/fused_gain_kron.cu`` (or raises), a CPU tensor runs
:func:`fused_gain_kron_reference`.  Any other device raises.

Both compute, per spectrum f_hat (Nx, Ny, Nz) viewed as (Nx, Ny*Nz), with
K = kron(Vy, Vz) and per node b, stream s in {+, -} (conjugated phases):

* t = (ayz_b^s * f_hat) K, one (Ny*Nz)-deep contraction for the y/z axes;
* g_s = Vx diag(ax_b^s) t, the x axis with its phase folded in;
* per radial group of ``radial_group`` consecutive nodes, the real sum
  s = sum_b w_b Re(g_+ g_-), nodes in order (Im is dropped exactly, as in K1);
* Q_gain_hat = sum over groups, in order, of beta1(rho_group, |l|)
  (Fx s)(Ny Nz conj K), beta1 = 4 pi b_gamma sin(a)/a with
  a = pi rho |l| / (2L) + eps.

The JAX kernel sums the groups of one grid step from zero and adds that
partial sum to its output; here every group is added to one running sum, so
the two agree to rounding (the tests hold them to 1e-12 max|Q_gain_hat| in
float64), not bitwise.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .fused_collide import _MAT_PAD, _SMEM_LIMIT, _chunk_nodes, _cplx, _pad16, line_plan
from .fused_gain_dft import fused_gain_dft

#: Launches of the CUDA kernel (one per :func:`fused_gain_kron` call on CUDA).
LAUNCHES = 0
#: Calls of the plain PyTorch version.
REFERENCE_CALLS = 0


@dataclasses.dataclass(frozen=True)
class KronTables:
    """The kron scheme's operands, complex, built once per ``Precomp``."""

    ax: torch.Tensor  # (B, Nx) x phase per node
    ayz: torch.Tensor  # (B, Ny*Nz) combined y/z phase ay (x) az per node
    vx: torch.Tensor  # (Nx, Nx) inverse DFT matrix (1/Nx)
    fx: torch.Tensor  # (Nx, Nx) forward DFT matrix
    kinv: torch.Tensor  # (NyNz, NyNz) kron(Vy, Vz)
    kfwd: torch.Tensor  # (NyNz, NyNz) Ny Nz conj(kron(Vy, Vz)) = kron(Fy, Fz)


def kron_tables(ax, ay, az, dft_inv, dft_fwd) -> KronTables:
    """The scheme's tables from the separable phases (B, N_axis) and the
    (x, y, z) triples of (2, N, N) [re, im] DFT matrix stacks."""
    vy, vz = _cplx(dft_inv[1]), _cplx(dft_inv[2])
    kinv = torch.kron(vy, vz)
    nyz = kinv.shape[0]
    ayz = (ay[:, :, None] * az[:, None, :]).reshape(ay.shape[0], nyz)
    return KronTables(
        ax=ax.contiguous(), ayz=ayz.contiguous(),
        vx=_cplx(dft_inv[0]).contiguous(), fx=_cplx(dft_fwd[0]).contiguous(),
        kinv=kinv.contiguous(), kfwd=(nyz * kinv.conj()).resolve_conj().contiguous(),
    )


# Mirror of the GEMM plan of ``csrc/fused_gain_kron.cu`` (``kron_plan``, the
# one count of its shared memory; the tests hold these constants to the
# source and, on the card, the plan to ``bfft_kron_plan``).
_RESIDENT_K = 64  # kResidentK: the matrix stays in shared memory up to pad16(Ny Nz) = 64


def kron_plan(nyz: int) -> list:
    """``kron_plan`` of the source, 4 ints for a y/z plane of ``nyz``
    points: 1 when the matrix stays in a block's shared memory, else 0 (its
    chunks stream through L2); a block's shared-memory bytes; the column
    tiles; ``kp``, nyz padded to whole chunks (the split planes are (kp,
    kp)).  A complex point takes 16 bytes in both precisions; a block's unit
    is 128 x 64 by 16 deep (resident) or 64 x 128 by 32 (streamed)."""
    resident = _pad16(nyz) <= _RESIDENT_K
    bm, bn, bk = (128, 64, 16) if resident else (64, 128, 32)
    ld, kp = bk + _MAT_PAD, -(-nyz // bk) * bk
    b = kp * (kp + _MAT_PAD) * 16 if resident else 2 * bn * ld * 16
    a = 2 * bm * ld * 16
    rows = 2 * bm * (8 + 4)
    return [int(resident), b + a + rows, 1 if resident else -(-kp // bn), kp]


def check_kron_grid(shape, dtype: torch.dtype) -> None:
    """Raise if K3 cannot take a grid of this shape and dtype: the x leg's
    line tile (K1's x pass, both streams and a real accumulator) does not
    fit in a block's shared memory.  The GEMM's tile always fits: its
    streamed unit does not grow with Ny Nz (``kron_plan``)."""
    nx = int(shape[0])
    csize = 16 if dtype == torch.float64 else 8
    lines, _, _, nbytes = line_plan(nx, 2, csize // 2, csize)
    if lines == 0:
        raise ValueError(
            f"fused_gain_kron: an x axis of {nx} points needs {nbytes} B of shared memory "
            f"for its DFT matrix tile (limit {_SMEM_LIMIT} B); use fused_scheme='ct'")


#: The largest y/z plane (Ny * Nz) on which ``fused_scheme="auto"`` takes K3.
KRON_MAX_NYZ = 64


def pick_scheme(nx: int, ny: int, nz: int) -> str:
    """The port's ``fused_scheme="auto"`` rule: ``"kron"`` (K3) when the
    y/z plane has at most ``KRON_MAX_NYZ`` points, ``"ct"`` on every other
    grid, so ``collide`` runs the whole eval in K1 and a ``gain_reduce`` hook
    gets K2.  Independent of the device and of ``nx``.

    It follows the whole Q of E BKW distributions at Ns=12 through K1
    against the kron route (K3 plus its cuFFT finale), ``chip_smoke.py``
    phase 4, NVIDIA H100 80GB HBM3 at 700 W, both kernels on the tensor
    cores (K3's y/z GEMM since its redesign); the mean of two runs' medians
    of 20 trials, in ms (f64 / f32):

    ====  =====  ===============  ===============
    grid  E      K1               kron route
    ====  =====  ===============  ===============
    8^3   1      1.143 / 0.891    0.866 / 0.381
    8^3   32     1.031 / 0.779    0.654 / 0.390
    8^3   256    1.922 / 1.736    0.986 / 0.843
    8^3   512    2.992 / 2.847    1.683 / 1.198
    12^3  1      1.245 / 0.901    1.972 / 0.624
    12^3  32     2.310 / 1.185    1.422 / 1.157
    12^3  256    5.252 / 4.016    6.624 / 6.270
    12^3  512    8.408 / 7.030    12.97 / 12.08
    16^3  1      1.030 / 1.175    0.898 / 1.132
    16^3  32     1.751 / 1.717    2.497 / 3.868
    16^3  256    7.689 / 6.658    16.22 / 15.55
    16^3  512    14.52 / 12.81    31.52 / 30.52
    ====  =====  ===============  ===============

    At 8^3 the kron route was faster in every (dtype, E) pair of both runs
    (1.3-2.6x), so the rule keeps it there.  From 12^3 on K1 wins the 256-
    and 512-cell solver stacks, where the time goes, in both dtypes and both
    runs (1.2-2.5x), so the rule takes K1 there; below 256 cells either
    route wins by up to 1.7 ms, and not the same one in both runs.
    """
    del nx
    return "kron" if ny * nz <= KRON_MAX_NYZ else "ct"


def fused_gain(
    rho, gain_w, ax, ay, az, f_hat, dft_inv, dft_fwd, norm_l,
    *, length: float, b_gamma: float, radial_group: int, scheme: str = "auto",
    tables: KronTables | None = None, chunk: int | None = None,
) -> torch.Tensor:
    """Q_gain_hat of f_hat (Nx, Ny, Nz) or (E, Nx, Ny, Nz), complex, by
    ``scheme``, as ``boltzfft``'s ``fused_gain`` dispatches: ``"ct"`` -> K2,
    ``"transpose"`` -> K4 (cubic only; both
    ``fused_gain_dft.fused_gain_dft``), ``"kron"`` -> K3
    (:func:`fused_gain_kron`, on ``tables`` when given, else built here),
    ``"auto"`` -> :func:`pick_scheme`.  ``chunk``: the kernels' nodes per
    chunk, as for ``fused_collide``."""
    if scheme == "auto":
        scheme = pick_scheme(*f_hat.shape[-3:])
    kw = dict(length=length, b_gamma=b_gamma, radial_group=radial_group, chunk=chunk)
    if scheme == "kron":
        if tables is None:
            tables = kron_tables(ax, ay, az, dft_inv, dft_fwd)
        return fused_gain_kron(rho, gain_w, tables, f_hat, norm_l, **kw)
    return fused_gain_dft(rho, gain_w, ax, ay, az, f_hat, dft_inv, dft_fwd, norm_l,
                          scheme=scheme, **kw)


def fused_gain_kron(
    rho, gain_w, tables: KronTables, f_hat, norm_l,
    *, length: float, b_gamma: float, radial_group: int, chunk: int | None = None,
) -> torch.Tensor:
    """Q_gain_hat for f_hat of shape (Nx, Ny, Nz) or (E, Nx, Ny, Nz), complex.

    ``rho``, ``gain_w``: (B,) node tables; ``tables``: :func:`kron_tables`;
    ``norm_l``: (Nx, Ny, Nz) mode norms.  Returns a complex tensor shaped like
    ``f_hat``.  ``chunk``: as for ``fused_collide``.
    """
    args = (rho, gain_w, tables, f_hat, norm_l)
    kw = dict(length=length, b_gamma=b_gamma, radial_group=radial_group)
    if f_hat.device.type == "cuda":
        return _fused_gain_kron_cuda(*args, chunk=chunk, **kw)
    if f_hat.device.type == "cpu":
        return fused_gain_kron_reference(*args, **kw)
    raise ValueError(f"fused_gain_kron: no kernel for device {f_hat.device}")


# --------------------------------------------------------------------------
# plain PyTorch version
# --------------------------------------------------------------------------


def _yz_product(a, k):
    """The y/z leg: rows a (..., Ny Nz) times the (Ny Nz, Ny Nz) matrix k,
    the kernel's GEMM."""
    return a @ k


def _x_product(m, t):
    """The x leg: the (Nx, Nx) matrix m along axis 1 of t (C, Nx, Ny Nz)."""
    return torch.einsum("xm,bmk->bxk", m, t)


def _reference_one(rho, gain_w, t: KronTables, fh, norm_l,
                   *, length, b_gamma, radial_group):
    """One spectrum fh (Nx, NyNz): every node at once, then the group sums
    node by node and the beta1 sum group by group, in order."""
    coef = math.pi / (2.0 * length)
    amp = 4.0 * math.pi * b_gamma
    eps = float(torch.finfo(rho.dtype).eps)
    n_nodes = rho.shape[0]
    gs = radial_group
    n_groups = -(-n_nodes // gs)

    def stream(ayz, ax):
        yz = _yz_product(ayz[:, None, :] * fh[None], t.kinv)  # (B, Nx, NyNz)
        return _x_product(t.vx, ax[:, :, None] * yz)

    g1 = stream(t.ayz, t.ax)
    g2 = stream(t.ayz.conj(), t.ax.conj())
    h = g1.real * g2.real - g1.imag * g2.imag
    pad = n_groups * gs - n_nodes  # zero-weight filler of a short last group
    w = torch.cat([gain_w, gain_w.new_zeros(pad)]).reshape(n_groups, gs)
    h = torch.cat([h, h.new_zeros((pad,) + h.shape[1:])]).reshape(
        (n_groups, gs) + h.shape[1:])
    s = torch.zeros_like(h[:, 0])
    for k in range(gs):
        s = s + w[:, k, None, None] * h[:, k]
    sh = _yz_product(_x_product(t.fx, s.to(fh.dtype)), t.kfwd)
    arg = (coef * rho[::gs])[:, None, None] * norm_l + eps
    beta1 = amp * torch.sin(arg) / arg
    acc = torch.zeros_like(fh)
    for g in range(n_groups):
        acc = acc + beta1[g] * sh[g]
    return acc


def fused_gain_kron_reference(
    rho, gain_w, tables: KronTables, f_hat, norm_l,
    *, length: float, b_gamma: float, radial_group: int,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: matmuls and einsums in the same
    order of stages, nodes and groups.  A batch is evaluated item by item, so
    a batched result equals the per-item results bitwise."""
    global REFERENCE_CALLS
    REFERENCE_CALLS += 1
    nx, ny, nz = f_hat.shape[-3:]
    rd = torch.float64 if f_hat.dtype == torch.complex128 else torch.float32
    kw = dict(length=length, b_gamma=b_gamma, radial_group=radial_group)
    one = lambda fh: _reference_one(  # noqa: E731
        rho.to(rd), gain_w.to(rd), tables, fh.reshape(nx, ny * nz),
        norm_l.to(rd).reshape(nx, ny * nz), **kw,
    ).reshape(nx, ny, nz)
    if f_hat.dim() == 4:
        return torch.stack([one(fh) for fh in f_hat])
    return one(f_hat)


# --------------------------------------------------------------------------
# CUDA kernel wrapper
# --------------------------------------------------------------------------


def _fused_gain_kron_cuda(
    rho, gain_w, tables: KronTables, f_hat, norm_l,
    *, length: float, b_gamma: float, radial_group: int, chunk: int | None = None,
) -> torch.Tensor:
    global LAUNCHES
    from .._build import load_library

    if f_hat.dim() not in (3, 4):
        raise ValueError(
            f"fused_gain_kron: f_hat must be (Nx,Ny,Nz) or (E,Nx,Ny,Nz), got {tuple(f_hat.shape)}")
    if f_hat.dtype not in (torch.complex64, torch.complex128):
        raise TypeError(f"fused_gain_kron: complex64/complex128 only, got {f_hat.dtype}")
    cd = f_hat.dtype
    rd = torch.float64 if cd == torch.complex128 else torch.float32
    dev = f_hat.device
    nx, ny, nz = f_hat.shape[-3:]
    nyz = ny * nz
    fb = f_hat.reshape(-1, nx, nyz).contiguous()
    n_batch = fb.shape[0]
    if n_batch > 65535:
        raise ValueError(
            f"fused_gain_kron: batch of {n_batch} exceeds one launch "
            "(E <= 65535, gridDim.y); split the batch")
    n_nodes = rho.shape[0]

    def arg(t, shape, dtype):
        if tuple(t.shape) != tuple(shape) or t.device != dev:
            raise ValueError(
                f"fused_gain_kron: expected {tuple(shape)} on {dev}, "
                f"got {tuple(t.shape)} on {t.device}")
        return t.to(dtype).contiguous()

    ins = [
        fb,
        arg(rho, (n_nodes,), rd),
        arg(gain_w, (n_nodes,), rd),
        arg(tables.ax, (n_nodes, nx), cd),
        arg(tables.ayz, (n_nodes, nyz), cd),
        arg(tables.vx, (nx, nx), cd),
        arg(tables.fx, (nx, nx), cd),
        arg(tables.kinv, (nyz, nyz), cd),
        arg(tables.kfwd, (nyz, nyz), cd),
        arg(norm_l, (nx, ny, nz), rd),
    ]
    check_kron_grid((nx, ny, nz), rd)
    n3 = nx * nyz
    csize = 16 if rd == torch.float64 else 8
    # the same two stream buffers per node as K1's, sized by K1's rule
    if chunk is None:
        chunk = _chunk_nodes(n_nodes, radial_group, n_batch, n3, csize, dev)
    t1 = torch.empty((2 * n_batch * chunk, n3), dtype=cd, device=dev)
    t2 = torch.empty_like(t1)
    # kinv and kfwd split into planes for the GEMM, 16 bytes a point
    kp = kron_plan(nyz)[3]
    ksplit = torch.empty((2, kp, kp), dtype=torch.complex128, device=dev)
    out = torch.empty_like(fb)

    lib = load_library()
    entry = lib.bfft_fused_gain_kron_f64 if rd == torch.float64 else lib.bfft_fused_gain_kron_f32
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = entry(
            *[t.data_ptr() for t in ins],
            t1.data_ptr(), t2.data_ptr(), ksplit.data_ptr(), out.data_ptr(),
            n_batch, nx, nyz, n_nodes, radial_group, chunk,
            math.pi / (2.0 * length), 4.0 * math.pi * b_gamma,
            float(torch.finfo(rd).eps), stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused_gain_kron: CUDA kernel failed with cudaError {rc}")
    LAUNCHES += 1
    return out.reshape(f_hat.shape)
