"""K2 and K4: the gain spectrum Q_gain_hat by per-axis DFTs in one
hand-written CUDA entry, and its plain PyTorch version.

Counterpart of ``boltzfft/pallas_kernels.py``'s ``fused_gain(scheme="ct")``
(``_fused_gain_ct`` -> ``_fused_ct_kernel`` in gain-only mode, K2) and
``fused_gain(scheme="transpose")`` (``_fused_gain_kernel``, K4).  On the TPU
the two schemes feed Mosaic's lane tiles differently; on the card both run
the same algorithm, a DFT along each axis with the node phase folded in
(dense, or split as K1 splits 64-point y and z axes in float64), which is
K1's node loop.  So both wrappers call one entry,
``bfft_fused_gain_*`` of ``csrc/fused_collide.cu``, and keep JAX's grid
rules: ct takes any even grid, transpose cubic grids only.

:func:`fused_gain_dft` dispatches on the device of ``f_hat``: a CUDA tensor
runs the kernel (or raises), a CPU tensor runs
:func:`fused_gain_dft_reference`, K1's plain node loop
(``fused_collide.gain_one_reference``).  Any other device raises.
"""

from __future__ import annotations

import math

import torch

from .fused_collide import _chunk_nodes, _cplx, check_grid, gain_one_reference

#: Launches of the CUDA entry, per scheme ("ct": K2, "transpose": K4).
LAUNCHES = {"ct": 0, "transpose": 0}
#: Calls of the plain PyTorch version, per scheme.
REFERENCE_CALLS = {"ct": 0, "transpose": 0}


def check_scheme(scheme: str, shape) -> None:
    """Raise if ``scheme`` is not K2's or K4's, or K4 gets a non-cubic grid
    (JAX's rule)."""
    if scheme not in LAUNCHES:
        raise ValueError(f"fused_gain_dft: scheme must be 'ct' or 'transpose', got {scheme!r}")
    if scheme == "transpose" and not shape[0] == shape[1] == shape[2]:
        raise ValueError(
            "fused scheme 'transpose' supports cubic grids only; use "
            "'kron'/'ct' for anisotropic resolutions"
        )


def fused_gain_dft(
    rho, gain_w, ax, ay, az, f_hat, dft_inv, dft_fwd, norm_l,
    *, length: float, b_gamma: float, radial_group: int, scheme: str,
    chunk: int | None = None,
) -> torch.Tensor:
    """Q_gain_hat for f_hat of shape (Nx, Ny, Nz) or (E, Nx, Ny, Nz), complex.

    ``rho``, ``gain_w``: (B,) node tables; ``ax``/``ay``/``az``: (B, N_axis)
    complex phase factors; ``dft_inv``/``dft_fwd``: (x, y, z) triples of
    (2, N, N) [re, im] stacks; ``norm_l``: (Nx, Ny, Nz).  ``scheme`` is
    ``"ct"`` (K2) or ``"transpose"`` (K4).  ``chunk``: as for
    ``fused_collide``.
    """
    check_scheme(scheme, f_hat.shape[-3:])
    args = (rho, gain_w, ax, ay, az, f_hat, dft_inv, dft_fwd, norm_l)
    kw = dict(length=length, b_gamma=b_gamma, radial_group=radial_group)
    if f_hat.device.type == "cuda":
        out = _fused_gain_cuda(*args, chunk=chunk, **kw)
        LAUNCHES[scheme] += 1
        return out
    if f_hat.device.type == "cpu":
        REFERENCE_CALLS[scheme] += 1
        return fused_gain_dft_reference(*args, **kw)
    raise ValueError(f"fused_gain_dft: no kernel for device {f_hat.device}")


def fused_gain_dft_reference(
    rho, gain_w, ax, ay, az, f_hat, dft_inv, dft_fwd, norm_l,
    *, length: float, b_gamma: float, radial_group: int,
) -> torch.Tensor:
    """Plain PyTorch version of the entry: per-axis einsums against the DFT
    matrices in the kernel's order of axes, nodes and groups, item by item."""
    rd = torch.float64 if f_hat.dtype == torch.complex128 else torch.float32
    inv = [_cplx(m.to(rd)) for m in dft_inv]
    fwd = [_cplx(m.to(rd)) for m in dft_fwd]
    tabs = (rho.to(rd), gain_w.to(rd), ax, ay, az)
    kw = dict(length=length, b_gamma=b_gamma, radial_group=radial_group)
    nl = norm_l.to(rd)
    if f_hat.dim() == 4:
        return torch.stack([gain_one_reference(*tabs, x, inv, fwd, nl, **kw) for x in f_hat])
    return gain_one_reference(*tabs, f_hat, inv, fwd, nl, **kw)


def _fused_gain_cuda(
    rho, gain_w, ax, ay, az, f_hat, dft_inv, dft_fwd, norm_l,
    *, length: float, b_gamma: float, radial_group: int, chunk: int | None = None,
) -> torch.Tensor:
    from .._build import load_library

    if f_hat.dim() not in (3, 4):
        raise ValueError(
            f"fused_gain_dft: f_hat must be (Nx,Ny,Nz) or (E,Nx,Ny,Nz), got {tuple(f_hat.shape)}")
    cd = f_hat.dtype
    if cd not in (torch.complex64, torch.complex128):
        raise TypeError(f"fused_gain_dft: complex64/complex128 only, got {cd}")
    rd = torch.float64 if cd == torch.complex128 else torch.float32
    nx, ny, nz = f_hat.shape[-3:]
    check_grid((nx, ny, nz), rd)
    dev = f_hat.device
    n3 = nx * ny * nz
    fb = f_hat.reshape(-1, n3).contiguous()
    n_batch = fb.shape[0]
    if n_batch > 65535:
        raise ValueError(
            f"fused_gain_dft: batch of {n_batch} exceeds one launch "
            "(E <= 65535, gridDim.y); split the batch")
    n_nodes = rho.shape[0]

    def arg(t, shape, dtype):
        if tuple(t.shape) != tuple(shape) or t.device != dev:
            raise ValueError(
                f"fused_gain_dft: expected {tuple(shape)} on {dev}, "
                f"got {tuple(t.shape)} on {t.device}")
        return t.to(dtype).contiguous()

    ins = [
        fb,
        arg(norm_l, (nx, ny, nz), rd),
        arg(rho, (n_nodes,), rd),
        arg(gain_w, (n_nodes,), rd),
        arg(ax, (n_nodes, nx), cd),
        arg(ay, (n_nodes, ny), cd),
        arg(az, (n_nodes, nz), cd),
    ]
    for mats in (dft_inv, dft_fwd):
        for m, n in zip(mats, (nx, ny, nz)):
            ins.append(_cplx(arg(m, (2, n, n), rd)).contiguous())

    csize = 16 if rd == torch.float64 else 8
    if chunk is None:
        chunk = _chunk_nodes(n_nodes, radial_group, n_batch, n3, csize, dev)
    t1 = torch.empty((2 * n_batch * chunk, n3), dtype=cd, device=dev)
    t2 = torch.empty_like(t1)
    out = torch.empty_like(fb)

    lib = load_library()
    entry = lib.bfft_fused_gain_f64 if rd == torch.float64 else lib.bfft_fused_gain_f32
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = entry(
            *[t.data_ptr() for t in ins],
            t1.data_ptr(), t2.data_ptr(), out.data_ptr(),
            n_batch, nx, ny, nz, n_nodes, radial_group, chunk,
            math.pi / (2.0 * length), 4.0 * math.pi * b_gamma,
            float(torch.finfo(rd).eps), stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused_gain_dft: CUDA kernel failed with cudaError {rc}")
    return out.reshape(f_hat.shape)
