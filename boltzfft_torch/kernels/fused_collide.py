"""K1: the whole collision eval Q(f, f) in one hand-written CUDA kernel, and
its plain PyTorch version.

Counterpart of the K1 part of ``boltzfft/pallas_kernels.py``
(``fused_collide`` -> ``_fused_gain_ct`` -> ``_fused_ct_kernel`` in io mode).
:func:`fused_collide` dispatches on the device of ``f``: a CUDA tensor runs
the kernel of ``csrc/fused_collide.cu`` (or raises), a CPU tensor runs
:func:`fused_collide_reference`.  Any other device raises.

Both compute, per distribution f (Nx, Ny, Nz), with per-axis DFT matrices:

* f_hat = DFT(f) and the loss convolution Re IDFT(beta2 f_hat);
* per node b, g1 = IDFT(alpha1 f_hat) and g2 = IDFT(conj(alpha1) f_hat) with
  the separable phases alpha1 = ax (x) ay (x) az folded in per axis;
* per radial group of ``radial_group`` consecutive nodes, the real sum
  s = sum_b w_b Re(g1 g2) (Im is dropped exactly: beta1 is real and even in
  l, so the imaginary part of the Hadamard product only reaches the Im of the
  final inverse, which Re removes);
* Q_gain_hat = sum over groups, in order, of beta1(rho_group, |l|) DFT(s),
  beta1 = 4 pi b_gamma sin(a)/a with a = pi rho |l| / (2L) + eps;
* Q = Re IDFT(Q_gain_hat) - Re IDFT(beta2 f_hat) f.

The plain version runs every transform's axes in the order x, y, z; the
kernel runs z, y, then x (fused with the group sum or the beta1 sum), on the
tensor cores (DMMA m16n8k16 in float64, 3xTF32 in float32), the y and z axes of
64-point float64 planes as a two-factor Cooley-Tukey split (64 = 8 * 8,
``plane_split``) and every other axis as a dense product.  The two agree to
rounding: within 1e-12 max|Q| in float64 and 1e-5 in float32 (4e-5 at 16^3,
where the gain and loss terms cancel).
"""

from __future__ import annotations

import math

import torch

from .. import obs

#: Launches of the CUDA kernel (one per :func:`fused_collide` call on CUDA).
LAUNCHES = 0
#: Calls of the plain PyTorch version.
REFERENCE_CALLS = 0
#: The free device memory :func:`_chunk_nodes` last read per (E, N^3, bytes
#: a complex point), for the ``k1_plan`` counter.
_SETTLED_FREE: dict = {}

# Mirror of the shared-memory plan of ``csrc/spectral_common.cuh``
# (``k1_plan``, the one count; the tests hold these constants to the source
# and, on the card, the plan to ``bfft_k1_plan``).
_PAD = 16            # kPad: every transformed axis is padded to this
_SMEM_LIMIT = 232_448  # kSmemLimit: shared memory an H100 block may use
_PLANE_ELEMS = 2048  # kPlaneElems: most padded points of a plane block
_MAT_PAD = 4         # kMatPad
_RAW_PAD = 4         # kRawPad
_LINE_PAD32 = 8      # kLinePad32
_LINE_PAD64 = 2      # kLinePad64
_SPLIT_N = 64        # kSplitN: the axis length the split takes (y and z)
_SPLIT_R = 8         # kSplitR: its factors, 64 = 8 * 8
_SPLIT_PAD = 1       # kSplitPad: split block row padding
#: k1_plan's routes: 1 the plane route (y and z of a block of x planes in one
#: launch), 2 the last-pass route (y and z as line passes), 0 none.
ROUTES = {1: "plane", 2: "last pass"}


def _cplx(stack: torch.Tensor) -> torch.Tensor:
    """(2, N, N) [re, im] planes -> complex (N, N)."""
    return torch.complex(stack[0], stack[1])


def _pad16(n: int) -> int:
    return -(-n // _PAD) * _PAD


def mat_bytes(n: int) -> int:
    """One padded (n, n) matrix, 16 bytes a point (double re/im planes, or
    float hi/lo splits of re and im)."""
    return _pad16(n) * (_pad16(n) + _MAT_PAD) * 16


def tile_pad(csize: int, resident: bool) -> int:
    """Row padding (complex points) of a B operand's tile: _LINE_PAD32 in
    float32, _LINE_PAD64 in float64 where the matrix is resident, else 0."""
    return _LINE_PAD32 if csize == 8 else (_LINE_PAD64 if resident else 0)


def line_smem(n, streams, acc_bytes, csize, lines, nbuf, resident) -> int:
    """A line-kernel block: the matrix if ``resident``, nbuf x streams tiles
    of pad16(n) x lines complex points (rows padded by :func:`tile_pad`),
    an accumulator of acc_bytes a point."""
    ld = lines + tile_pad(csize, resident)
    return ((mat_bytes(n) if resident else 0) + nbuf * streams * _pad16(n) * ld * csize
            + _pad16(n) * lines * acc_bytes)


def line_plan(n, streams, acc_bytes, csize):
    """(lines per tile, buffers, resident, bytes): the first of (32, 2),
    (16, 2), (16, 1) that fits with the matrix resident in shared memory,
    else without it (read from device memory); lines 0 if none fits."""
    for resident in (True, False):
        for lines, nbuf in ((32, 2), (16, 2), (16, 1)):
            b = line_smem(n, streams, acc_bytes, csize, lines, nbuf, resident)
            if b <= _SMEM_LIMIT:
                return lines, nbuf, resident, b
    return 0, 1, False, line_smem(n, streams, acc_bytes, csize, 16, 1, False)


def plane_split(ny, nz, csize) -> int:
    """The split's factor for the y and z axes of a plane block: _SPLIT_R
    where both are _SPLIT_N points in float64 (csize 16), else 0 (the dense
    tile)."""
    return _SPLIT_R if csize == 16 and ny == _SPLIT_N and nz == _SPLIT_N else 0


def split_smem(ny, nz) -> int:
    """A split block: one x plane of ny rows of nz + _SPLIT_PAD complex
    points (both passes in place), then a unit's phase rows (x, y, z)."""
    return (ny * (nz + _SPLIT_PAD) + 1 + ny + nz) * 16


def plane_smem(nx, ny, nz, csize, planes) -> int:
    """A plane-kernel block: the z matrix (and the y one unless ny == nz),
    then ``planes`` input planes and z-pass planes, and a unit's phase rows;
    a block that takes the split holds one plane and no matrix."""
    if plane_split(ny, nz, csize):
        return split_smem(ny, nz)
    mats = mat_bytes(nz) + (0 if ny == nz else mat_bytes(ny))
    ld_raw = _pad16(nz) + _RAW_PAD
    ld_mid = _pad16(nz) + tile_pad(csize, True)
    return mats + planes * _pad16(ny) * (ld_raw + ld_mid) * csize + (nx + ny + _pad16(nz)) * csize


def plane_count(nx, ny, nz, csize) -> int:
    """x planes per plane block: the largest divisor of nx that holds at
    most _PLANE_ELEMS padded points and fits; 0 if one plane does not fit.
    A split block holds one."""
    if plane_split(ny, nz, csize):
        return 1 if split_smem(ny, nz) <= _SMEM_LIMIT else 0
    best = 0
    for p in range(1, nx + 1):
        if nx % p:
            continue
        if p > 1 and p * _pad16(ny) * _pad16(nz) > _PLANE_ELEMS:
            break
        if plane_smem(nx, ny, nz, csize, p) > _SMEM_LIMIT:
            break
        best = p
    return best


def plan(shape, dtype: torch.dtype) -> list:
    """``k1_plan`` of the source, 4 ints: the route (see ``ROUTES``; 0 none),
    the first axis that fits no tile (-1: none), the bytes its smallest tile
    needs, and the split's factor on the plane route (0: the dense tile).  x
    runs the gain (2 streams, a real accumulator), beta1 (a complex
    accumulator) and store passes; y and z run store passes where a plane
    does not fit."""
    nx, ny, nz = (int(n) for n in shape)
    csize = 16 if dtype == torch.float64 else 8
    passes = [(0, line_plan(nx, 2, csize // 2, csize)), (0, line_plan(nx, 1, csize, csize)),
              (0, line_plan(nx, 1, 0, csize))]
    planes = plane_count(nx, ny, nz, csize) > 0
    if not planes:
        passes += [(1, line_plan(ny, 1, 0, csize)), (2, line_plan(nz, 1, 0, csize))]
    for axis, (lines, _nbuf, _resident, b) in passes:
        if lines == 0:
            return [0, axis, b, 0]
    return [1, -1, 0, plane_split(ny, nz, csize)] if planes else [2, -1, 0, 0]


def split_yz(shape, dtype: torch.dtype) -> str:
    """How the kernel transforms the y and z axes of a grid: "8x8" where the
    plane route takes the split, else "dense"."""
    r = plan(shape, dtype)[3]
    return f"{r}x{_SPLIT_N // r}" if r else "dense"


def dense_tile(dtype: torch.dtype) -> str:
    """The instruction shape of the dense tile (every axis the split does not
    take): "m16n8k16" DMMA in float64, "3xtf32" (m16n8k8 TF32) in float32."""
    return "m16n8k16" if dtype == torch.float64 else "3xtf32"


def stream_bytes(n_batch: int, n3: int, csize: int, chunk: int) -> int:
    """Bytes of the two node-stream buffers of a launch: each holds both
    phased streams of every node of a chunk for every distribution."""
    return 2 * (2 * n_batch * chunk * n3) * csize


def note_plan(n_batch: int, shape, dtype: torch.dtype, n_nodes: int, chunk: int) -> None:
    """The ``k1_plan`` counter of a launch shape: nodes per chunk, chunks per
    eval, ``split_yz``, ``dense_tile``, the stream buffers' bytes and the
    free device memory :func:`_chunk_nodes` read when it settled the chunk
    (None where the caller gave the chunk)."""
    nx, ny, nz = (int(n) for n in shape)
    n3, csize = nx * ny * nz, 16 if dtype == torch.float64 else 8
    obs.note("k1_plan", f"{n_batch}x{nx}x{ny}x{nz}",
             {"nodes_per_chunk": chunk, "chunks_per_eval": -(-n_nodes // chunk),
              "split_yz": split_yz(shape, dtype), "dense_tile": dense_tile(dtype),
              "stream_bytes": stream_bytes(n_batch, n3, csize, chunk),
              "free_bytes_at_settle": _SETTLED_FREE.get((n_batch, n3, csize))})


def route(shape, dtype: torch.dtype):
    """"plane", "last pass", or None where the kernel cannot take the grid."""
    return ROUTES.get(plan(shape, dtype)[0])


def check_grid(shape, dtype: torch.dtype) -> None:
    """Raise if the CUDA kernel cannot take a grid of this shape and dtype."""
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"fused_collide: float32/float64 only, got {dtype}")
    for n in shape:
        if n % 2:
            raise ValueError(f"fused_collide: grid axes must be even, got {tuple(shape)}")
    route_, axis, nbytes, _split = plan(shape, dtype)
    if route_ == 0:
        n = tuple(shape)[axis]
        raise ValueError(
            f"fused_collide: an axis of {n} points needs "
            f"{nbytes} B of shared memory for its DFT "
            f"matrix tile (limit {_SMEM_LIMIT} B); use impl='rfft' or 'c2c'"
        )


def fused_collide(
    rho, gain_w, ax, ay, az, f, beta2, dft_inv, dft_fwd, norm_l,
    *, length: float, b_gamma: float, radial_group: int, chunk: int | None = None,
) -> torch.Tensor:
    """Q(f, f) for f of shape (Nx, Ny, Nz) or (E, Nx, Ny, Nz).

    ``rho``, ``gain_w``: (B,) node tables; ``ax``/``ay``/``az``: (B, N_axis)
    complex phase factors; ``beta2``, ``norm_l``: (Nx, Ny, Nz);
    ``dft_inv``/``dft_fwd``: (x, y, z) triples of (2, N, N) [re, im] stacks.
    ``chunk``: the kernel's nodes per chunk (whole radial groups; it sets
    the buffers, not the result's bits), else :func:`_chunk_nodes` of the
    free memory; the plain version ignores it.
    """
    args = (rho, gain_w, ax, ay, az, f, beta2, dft_inv, dft_fwd, norm_l)
    kw = dict(length=length, b_gamma=b_gamma, radial_group=radial_group)
    if f.device.type == "cuda":
        return _fused_collide_cuda(*args, chunk=chunk, **kw)
    if f.device.type == "cpu":
        return fused_collide_reference(*args, **kw)
    raise ValueError(f"fused_collide: no kernel for device {f.device}")


# --------------------------------------------------------------------------
# plain PyTorch version
# --------------------------------------------------------------------------


def _apply(m: torch.Tensor, t: torch.Tensor, axis: int) -> torch.Tensor:
    """Contract ``m`` — (N, N), or (C, N, N) one per entry — with grid axis
    ``axis`` of ``t`` — (Nx, Ny, Nz), or (C, Nx, Ny, Nz)."""
    grid = "xyz"
    a = grid[axis]
    t_spec = ("c" if t.dim() == 4 else "") + grid.replace(a, "n")
    m_spec = ("c" if m.dim() == 3 else "") + a + "n"
    out = ("c" if t.dim() == 4 or m.dim() == 3 else "") + grid
    return torch.einsum(f"{m_spec},{t_spec}->{out}", m, t)


def _dft3(mats, t: torch.Tensor) -> torch.Tensor:
    for axis, m in enumerate(mats):
        t = _apply(m, t, axis)
    return t


def gain_one_reference(rho, gain_w, ax, ay, az, f_hat, inv, fwd, norm_l,
                       *, length, b_gamma, radial_group):
    """Q_gain_hat of one full spectrum f_hat (Nx, Ny, Nz): the node and group
    loop of the kernels, with complex (N, N) matrices ``inv``/``fwd`` per
    axis (shared by K1's plain version and the gain-only one, K2/K4)."""
    coef = math.pi / (2.0 * length)
    amp = 4.0 * math.pi * b_gamma
    rd = f_hat.real.dtype
    eps = float(torch.finfo(rd).eps)
    acc = torch.zeros_like(f_hat)
    n_nodes = rho.shape[0]
    for g0 in range(0, n_nodes, radial_group):
        sl = slice(g0, min(g0 + radial_group, n_nodes))
        # per-node inverse matrices with the phase folded in: V diag(a)
        m1 = [v[None] * a[sl, None, :] for v, a in zip(inv, (ax, ay, az))]
        m2 = [v[None] * a[sl, None, :].conj() for v, a in zip(inv, (ax, ay, az))]
        g1 = _dft3(m1, f_hat)
        g2 = _dft3(m2, f_hat)
        s = torch.zeros(f_hat.shape, dtype=rd, device=f_hat.device)
        for k in range(g1.shape[0]):
            s = s + gain_w[g0 + k] * (
                g1[k].real * g2[k].real - g1[k].imag * g2[k].imag
            )
        s_hat = _dft3(fwd, s.to(f_hat.dtype))
        arg = (coef * rho[g0]) * norm_l + eps
        beta1 = amp * torch.sin(arg) / arg
        acc = acc + beta1 * s_hat
    return acc


def _reference_one(rho, gain_w, ax, ay, az, f, beta2, inv, fwd, norm_l,
                   *, length, b_gamma, radial_group):
    f_hat = _dft3(fwd, f.to(ax.dtype))
    loss = _dft3(inv, beta2 * f_hat).real
    acc = gain_one_reference(rho, gain_w, ax, ay, az, f_hat, inv, fwd, norm_l,
                             length=length, b_gamma=b_gamma, radial_group=radial_group)
    return _dft3(inv, acc).real - loss * f


def fused_collide_reference(
    rho, gain_w, ax, ay, az, f, beta2, dft_inv, dft_fwd, norm_l,
    *, length: float, b_gamma: float, radial_group: int,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: per-axis einsums against the DFT
    matrices, the same order of axes, nodes and groups.  A batch is evaluated
    item by item, so a batched result equals the per-item results bitwise."""
    global REFERENCE_CALLS
    REFERENCE_CALLS += 1
    rd = f.dtype
    inv = [_cplx(m.to(rd)) for m in dft_inv]
    fwd = [_cplx(m.to(rd)) for m in dft_fwd]
    tabs = (rho.to(rd), gain_w.to(rd), ax, ay, az)
    kw = dict(length=length, b_gamma=b_gamma, radial_group=radial_group)
    b2, nl = beta2.to(rd), norm_l.to(rd)
    if f.dim() == 4:
        return torch.stack(
            [_reference_one(*tabs, fi, b2, inv, fwd, nl, **kw) for fi in f]
        )
    return _reference_one(*tabs, f, b2, inv, fwd, nl, **kw)


# --------------------------------------------------------------------------
# CUDA kernel wrapper
# --------------------------------------------------------------------------


def _chunk_nodes(n_nodes: int, group: int, n_batch: int, n3: int,
                csize: int, device) -> int:
    """Nodes per kernel chunk: whole radial groups whose two stream buffers
    (:func:`stream_bytes`) fit a third of the free device memory.  A CUDA
    graph keeps its capture's buffers in its pool, so two graphs of the same
    eval (a step's and the operator's own, both on this chunk) and the eager
    warm-up before the second capture have to fit together: two thirds at
    the peak, the rest for the states and the tables."""
    free, _total = torch.cuda.mem_get_info(device)
    _SETTLED_FREE[(n_batch, n3, csize)] = free
    cap = min(n_nodes, (free // 3) // stream_bytes(n_batch, n3, csize, 1))
    return max(group, (cap // group) * group)


def _fused_collide_cuda(
    rho, gain_w, ax, ay, az, f, beta2, dft_inv, dft_fwd, norm_l,
    *, length: float, b_gamma: float, radial_group: int, chunk: int | None = None,
) -> torch.Tensor:
    global LAUNCHES
    from .._build import load_library

    if f.dim() not in (3, 4):
        raise ValueError(f"fused_collide: f must be (Nx,Ny,Nz) or (E,Nx,Ny,Nz), got {tuple(f.shape)}")
    rd = f.dtype
    check_grid(f.shape[-3:], rd)
    dev = f.device
    nx, ny, nz = f.shape[-3:]
    fb = f.reshape(-1, nx, ny, nz).contiguous()
    n_batch = fb.shape[0]
    if n_batch > 65535:
        raise ValueError(
            f"fused_collide: batch of {n_batch} exceeds one launch "
            "(E <= 65535, gridDim.y); split the batch"
        )
    cd = torch.complex64 if rd == torch.float32 else torch.complex128
    n_nodes = rho.shape[0]
    n3 = nx * ny * nz

    def arg(t, shape, dtype):
        if tuple(t.shape) != tuple(shape) or t.device != dev:
            raise ValueError(
                f"fused_collide: expected {tuple(shape)} on {dev}, "
                f"got {tuple(t.shape)} on {t.device}"
            )
        return t.to(dtype).contiguous()

    ins = [
        fb,
        arg(beta2, (nx, ny, nz), rd),
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
    note_plan(n_batch, (nx, ny, nz), rd, n_nodes, chunk)
    # the two node-stream buffers first: the caching allocator then puts the
    # small ones in free small blocks, never a piece of a freed stream
    # buffer, which would make the next call's second stream buffer a new
    # segment (a third 12 GiB one on an RK4 step of 256 x 32^3 f64)
    t1 = torch.empty((2 * n_batch * chunk, n3), dtype=cd, device=dev)
    t2 = torch.empty_like(t1)
    fh = torch.empty((n_batch, n3), dtype=cd, device=dev)
    y = torch.empty((n_batch, 2, n3), dtype=cd, device=dev)
    q = torch.empty_like(fb)

    lib = load_library()
    entry = lib.bfft_fused_collide_f64 if rd == torch.float64 else lib.bfft_fused_collide_f32
    # obs on: the kernel marks a device span k1.chunk around each node chunk
    marks = obs.marks("k1.chunk", fb) or (None, None, 0, 0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = entry(
            *[t.data_ptr() for t in ins],
            fh.data_ptr(), y.data_ptr(), t1.data_ptr(), t2.data_ptr(), q.data_ptr(),
            n_batch, nx, ny, nz, n_nodes, radial_group, chunk,
            math.pi / (2.0 * length), 4.0 * math.pi * b_gamma,
            float(torch.finfo(rd).eps), *marks, stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused_collide: CUDA kernel failed with cudaError {rc}")
    LAUNCHES += 1
    return q.reshape(f.shape)
