"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device: a CUDA card must be present; prints its name and power limit;
2. build: compiles the port's CUDA kernels from ``boltzfft_torch/csrc``
   (the build seconds), and counts the tensor-core instructions (HMMA,
   HGMMA, DMMA) in the SASS: the ds engine's tile kernels (K8, K9, K10's
   two instances) must all have some, and K1's axis transforms (``line_dft_kernel``,
   ``plane_dft_kernel``; K2, K4 and K3's x leg too) and K3's y/z GEMM
   (``kron_gemm_kernel``) DMMA in double and HMMA (3xTF32) in float;
3. each kernel against its plain PyTorch version on the card (float64 within
   1e-12 of the plain result's max, float32 within 1e-5, 4e-5 below 32^3,
   see ``TOL``): K1 (``fused_collide``), K3 (``fused_gain_kron``), K2 and K4
   (``fused_gain_dft``; K2 at 16^3, 32^3, (32,16,48), 64^3, K4 at 16^3,
   32^3, 40^3, 64^3), K6 (``alpha_multiply``) and K5 (``gain_reduce``, at three
   node blocks that must agree bitwise) at the shapes the rfft + use_pallas
   route gives them at 32^3 and 64^3; every new kernel bitwise equal to
   itself run to run; K3's route of ``collide`` against the staged cuFFT
   c2c in float64 (1e-12 max|Q|);
4. the scheme measurement: the whole Q through K1 against the kron route
   (K3 plus its cuFFT finale) at 8^3, 12^3 and 16^3, Ns=12, on E = 1, 32, 256
   and 512 distributions, float32 and float64, medians of 20 trials (5 in
   each of four turns);
5. the homogeneous main paths, ``make_collision_operator`` or ``collide``
   at 32^3 and 64^3, Ns=12, on the BKW distribution at t = 6.5: K1
   (``impl="fused"``), rfft + use_pallas (K6, K5), fused + a ``gain_reduce``
   hook (K2), ``fused_scheme="transpose"`` (K4), and dft (32^3), each held
   to the reference's float64 error norms and to the staged float64 c2c
   (1e-12 max|Q|), float32 to L_inf <= 4.5e-5 at 32^3 and to 2e-5 max|Q|
   of float64 at 64^3; counts reset around each route;
6. the inhomogeneous main path at its CLIs' default size (16^3
   velocities, Ns=12, ``impl="fused"``: K1): Taylor-Green 2D on 16x16 cells
   (10 steps), Taylor-Green 3D on 8^3 cells (2 steps), Sod on 32 cells
   (5 steps), and TG-2D on K3 (``fused_scheme="kron"``, 3 steps), in float64
   and float32, each held to the CLIs' mass-drift and H-theorem gates, and
   one float64 TG-2D step against the same step on the staged c2c pipeline
   (1e-12 relative);
7. determinism (bitwise run to run and batched against per item, for K1,
   for the TG-2D step, and for the K1 and K3 collides of the TG-2D, TG-3D
   and Sod cell stacks), K1 and K3 against their plain versions on the
   TG-3D (512 cells) and Sod (32 cells) stacks, the default route at 8^3
   (``impl="fused"``, K3) on a 256-cell stack against the staged c2c, and
   dispatch (each main path launched its kernels and never a plain version);
8. ``maxwell_bkw --steps 10 --Nv 32 --Ns 12`` (RK4 relaxation through K1,
   float64) and the same relaxation through c2c (1e-12 relative);
9. ``health.selfcheck`` on the card for fused, rfft + use_pallas and dft,
   and with a corrupted ``Precomp`` (must fail);
10. ``fft_benchmark`` and ``loop_benchmark`` at 32^3, Ns=12, float64;
11. times (CUDA events, 2 warm-ups, 10 trials, a plain version 1 and 5;
    median and mean): K1 at 32^3
    and 64^3; K2, K4, K5, K6 at the main paths' shapes with their bounds,
    plain versions and K5's and K6's library yardsticks; ``collide`` through each route
    (K1, staged rfft and c2c, rfft + use_pallas, K2 + hook, K4, dft at
    32^3) at 32^3 and 64^3; K3 (first held to its plain
    version there), its plain version and K1 on the 256-cell TG-2D batch,
    and K3 on the 8^3 256-cell stack (the default kron route); K3's bound on
    the tensor cores beside the dense kron product's and the CUDA-core one,
    and its y/z stage's device time beside one complex ``torch.matmul`` at
    the stage's shape (cuBLAS, TF32 off);
    the TG-2D step; and a ``torch.profiler`` window over TG-2D steps (device
    time by kernel family and the card's idle share); K1's bound on the
    tensor cores beside its CUDA-core bound, and its stream stage's device
    time beside one ``torch.fft.ifftn`` over the same 2 x n_nodes grids;
    the homogeneous routes (K1, rfft + use_pallas, K2 + hook, K4) are timed
    in turns;
12. K8 on edge operands (every chunk and slice at 127 units, K = 64,
    merged and unmerged, real and complex output: the level sums at the
    edge of float32's exactness) bitwise equal to its plain version; the ds
    engine's kernels against their plain versions at the main path's
    shapes, 32^3 and 64^3, Ns=12 (real tables from
    ``make_ds_collision_operator``, f_hat of the BKW state): K7 merged and
    unmerged, K8 in every mode the default route launches (shared matrix
    real_in / complex / real_out, Hermitian forward z; per-node repeat +
    presliced + merged, merged, merged real_out), K9 at 32^3 (also against
    the K8 kernel chain), K12 with gb = 2 (32^3) and 1 (64^3); each bitwise
    equal to its plain version and to itself run to run;
13. the ds BKW digits through ``make_ds_collision_operator``'s card defaults
    (32^3: the reference L1/L2/Linf at rtol 1e-4; 64^3: Linf in
    [3.0680, 3.0692]e-12), each within 1e-12 max|Q| of the float64 staged
    cuFFT c2c of phase 5, with counts reset around the eval (K7, K8, K12 and
    K9 at 32^3, K10 at 64^3 launched; no plain call); ``g1_reversal`` and ``oz_cmax=4``
    at 64^3, and the staged K8 chain at 32^3 bitwise equal to K9's route;
14. ``health.selfcheck_ds`` on the card (16^3, ns=6, oz vs vpu < 1e-11);
15. ``maxwell_bkw --impl ds --Nv 32 --Ns 12``, ``--trials 3`` and ``--steps 4``;
16. times: the ds eval at 32^3 (5 trials) and 64^3 (3 trials) after 2
    warm-ups, a ``torch.profiler`` window over one eval of each (device time
    and launches by kernel, idle share), and K7, K8, K9, K12 at main-path
    shapes against their plain versions, their bounds (chunk-pair dots at the
    bf16 tensor-core peak plus the fold at the float32 CUDA-core peak, or
    bytes) and, for K8, a complex128 ``torch.bmm``/``matmul`` yardstick, for
    K9 a complex128 ``einsum`` of its three stages, and each kernel's device
    time per launch from ``torch.profiler`` (events around one call time the
    wrapper's host work where it is the longer);
17. the oz engine's other routes' kernels against their plain versions at
    their shapes, 32^3 and 64^3, Ns=12: K8's phased mode (the three stages of
    ``transform3_oz_phased`` on the first sub-batch of 2 nodes, tables from
    ``build_ds_precomp(node_mats=False)``, conj and not), K11 on the two
    streams (C = 2) as the routes lay them out (rolled) and in order,
    weighted and not, K10 on the main block's nodes at its plan's z block,
    at z blocks 1, 2 and 4 (where the plan fits) and node by node, all
    bitwise equal to it, and K10 + the half-z K8 call bitwise equal to the
    staged K8 chain;
18. the full g-streams (``make_ds_collision_operator(g_stream="full")``: K7,
    K8, K11), the phased route (``collide_ds`` on the ``node_mats=False``
    tables: K8 phased, K11) and ``gmain_fused="12"`` (K7, K10, K8, K12), each
    giving the ds digits, within 1e-12 max|Q| of the f64 c2c and of the
    default route, launching its kernels and no plain version; "12" bitwise
    equal to the staged route and, at 32^3, to K9's;
19. ``maxwell_bkw --impl ds --Nv 32 --Ns 12 --trials 3`` with
    ``--g-stream full`` and with ``--gmain-fused 12``;
20. times: each route's eval (1 warm-up, 5 trials at 32^3, 3 at 64^3) and a
    profile of one eval; K8 phased, K11 and K10 against their plain
    versions, bounds and complex128 ``einsum`` yardsticks, with
    their launches per eval; the 32^3 main block through K9, K10 + the half-z
    K8 call, and the staged K8 chain, on the same nodes: bitwise equal, then
    timed in 5 paired rounds, the order reversed every other round; the
    main-block route rule (``ds_operator._gmain_mode``): the whole ds eval
    through K9 (32^3), K10 and the staged chain in 6 paired rounds, the
    round-by-round differences, each route's profiled device time, and the
    rule's pick.

A ``[N total]`` line after phases 3-11, 16 and 20 gives the seconds since the
device check.  The last two lines are a JSON summary of the kernels and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import ast
import contextlib
import dataclasses
import io
import json
import statistics
import subprocess
import sys
import time
from functools import partial

import numpy as np
import torch

SHAPES_K1 = [  # (grid, ns, batch)
    ((16, 16, 16), 6, 1),
    ((32, 32, 32), 12, 1),
    ((32, 16, 48), 12, 1),
    ((16, 16, 16), 6, 2),
    ((64, 64, 64), 12, 1),
]
SHAPES_K3 = [  # (grid, ns, batch)
    ((16, 16, 16), 12, 1),
    ((16, 16, 16), 12, 3),
    ((8, 12, 16), 6, 1),
    ((16, 16, 48), 12, 1),  # the matrix streamed in 6 column tiles
    ((8, 8, 8), 12, 256),   # the default kron route on a cell stack (matrix resident)
]
SHAPES_K24 = [  # (scheme, grid, ns, batch)
    ("ct", (16, 16, 16), 12, 1),
    ("ct", (16, 16, 16), 12, 2),
    ("ct", (32, 32, 32), 12, 1),
    ("ct", (32, 16, 48), 12, 1),
    ("ct", (64, 64, 64), 12, 1),
    ("transpose", (16, 16, 16), 12, 1),
    ("transpose", (32, 32, 32), 12, 1),
    ("transpose", (40, 40, 40), 12, 1),  # the TPU's transpose regime (> 32)
    ("transpose", (64, 64, 64), 12, 1),
]
NODE_BLOCKS = (1, 8, 96)  # K5 staging sizes that must agree bitwise
SCHEME_GRIDS = (8, 12, 16)
SCHEME_BATCHES = (1, 32, 256, 512)  # a BKW eval, Sod, TG-2D and TG-3D stacks
# |kernel - plain| in units of max|Q| (K1) or max|Q_gain_hat| (K2-K4) or the
# plain result's max (K5, K6).  float32 Q at 16^3: the gain and loss terms
# are ~30x max|Q| there and cancel, so each float32 version lies 1.5-1.7e-5
# max|Q| from the float64 result and two of them can differ by the sum of
# that; from 32^3 on, 1e-5.
TOL = {"float64": 1e-12, "float32": 1e-5}
TOL_F32_16 = 4e-5
BKW_DIGITS = {  # reference f64 L1, L2, Linf at Ns=12 and the rtol they hold to
    32: ((1.5403e-03, 1.0119e-04, 4.2512e-05), 1e-4),
    64: ((8.9149e-11, 8.3092e-12, 3.0685e-12), 1e-3),
}
TRIALS = 10
# the plain versions' and the scheme measurement's trials: fewer, so that the
# whole script stays near 300 s of command time
PLAIN_TRIALS = 5
SCHEME_TRIALS = 5
# The CLIs' gates: relative mass drift, and the worst per-step H rise as a
# share of the total dissipation |H_end - H_0|.
MASS_TOL = 1e-2
H_TOL = 0.01
# Peaks of an H100 SXM at 700 W (NVIDIA's data sheet): CUDA-core FLOP/s in
# float32 and float64 (K5, K6; the earlier CUDA-core bounds), device memory
# bytes/s, and the tensor cores' dense rates that K1-K4's transforms run at:
# DMMA in float64, TF32 in float32, where 3xTF32 does 3 products for each
# one.
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
PEAK_BYTES = 3.35e12
PEAK_TC = {"float64": 67e12, "float32": 495e12}
TC_PASSES = {"float64": 1, "float32": 3}
TC_UNIT = {"float64": "DMMA f64 tensor cores, 67 TFLOP/s",
           "float32": "3xTF32 tensor cores, 3 x 495 TFLOP/s"}
# The homogeneous main paths: (label, CollisionConfig kwargs, hook, grids,
# the counts that must be > 0).  The hook is the single-device stand-in for
# the node-sharded operator's all-reduce.
ROUTES = [
    ("rfft + use_pallas (K6, K5)", dict(impl="rfft", use_pallas=True), False, (32, 64), ("k5", "k6")),
    ("fused + gain_reduce hook (K2)", dict(impl="fused", fused_scheme="ct"), True, (32, 64), ("k2",)),
    ("fused_scheme='transpose' (K4)", dict(impl="fused", fused_scheme="transpose"), False, (32, 64), ("k4",)),
    ("dft (no kernel)", dict(impl="dft"), False, (32,), ()),
]
KERNEL_SOURCES = {  # name -> (source, the TPU kernel it replaces)
    "fused_collide": ("boltzfft_torch/csrc/fused_collide.cu", "boltzfft/pallas_kernels.py:515"),
    "fused_gain_ct": ("boltzfft_torch/csrc/fused_collide.cu", "boltzfft/pallas_kernels.py:877"),
    "fused_gain_kron": ("boltzfft_torch/csrc/fused_gain_kron.cu", "boltzfft/pallas_kernels.py:221"),
    "fused_gain_transpose": ("boltzfft_torch/csrc/fused_collide.cu", "boltzfft/pallas_kernels.py:913"),
    "gain_reduce": ("boltzfft_torch/csrc/gain_reduce.cu", "boltzfft/pallas_kernels.py:54"),
    "alpha_multiply": ("boltzfft_torch/csrc/alpha_multiply.cu", "boltzfft/pallas_kernels.py:1141"),
    "preslice_rows": ("boltzfft_torch/csrc/oz_preslice.cu", "boltzfft/oz.py:535"),
    "oz_contract": ("boltzfft_torch/csrc/oz_contract.cu", "boltzfft/oz.py:606"),
    "gmain3_nodemat": ("boltzfft_torch/csrc/oz_gmain3.cu", "boltzfft/oz.py:1420"),
    "hadamard_wsum_half": ("boltzfft_torch/csrc/oz_hadamard_half.cu", "boltzfft/oz.py:1832"),
    "oz_contract_phased": ("boltzfft_torch/csrc/oz_contract.cu", "boltzfft/oz.py:1117"),
    "gmain12_nodemat": ("boltzfft_torch/csrc/oz_gmain12.cu", "boltzfft/oz.py:1536"),
    "hadamard_wsum": ("boltzfft_torch/csrc/oz_hadamard.cu", "boltzfft/oz.py:1728"),
}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def bkw(bt, cfg, dev):
    g = cfg.velocity_grid
    rsq = g.r_squared()
    f = torch.as_tensor(bt.bkw_f(rsq, 6.5), dtype=cfg.real_dtype, device=dev)
    return g, rsq, f


def k1_inputs(op, cfg, pre, f):
    ax, ay, az = op._alpha_factors(cfg, pre, pre.rho, pre.sigma)
    args = (pre.rho, pre.gain_w, ax, ay, az, f, pre.beta2,
            pre.dft_inv_axes(), pre.dft_fwd_axes(), pre.norm_l)
    kw = dict(length=cfg.domain_length, b_gamma=cfg.b_gamma, radial_group=cfg.ns_eff)
    return args, kw


def k3_inputs(op, cfg, pre, f):
    f_hat = torch.fft.fftn(f.to(cfg.complex_dtype), dim=(-3, -2, -1))
    args = (pre.rho, pre.gain_w, op._kron_tables(cfg, pre), f_hat, pre.norm_l)
    kw = dict(length=cfg.domain_length, b_gamma=cfg.b_gamma, radial_group=cfg.ns_eff)
    return args, kw


def k24_inputs(op, cfg, pre, f):
    """K2/K4's inputs: the full spectrum of f and the separable phases."""
    f_hat = torch.fft.fftn(f.to(cfg.complex_dtype), dim=(-3, -2, -1))
    ax, ay, az = op._alpha_factors(cfg, pre, pre.rho, pre.sigma)
    args = (pre.rho, pre.gain_w, ax, ay, az, f_hat,
            pre.dft_inv_axes(), pre.dft_fwd_axes(), pre.norm_l)
    kw = dict(length=cfg.domain_length, b_gamma=cfg.b_gamma, radial_group=cfg.ns_eff)
    return args, kw


def k56_inputs(op, k6, cfg, pre, f):
    """K6's and K5's inputs for the first node chunk of the rfft + use_pallas
    route, as ``operator._gain_chunk_pallas`` forms them; h is that chunk's
    real h_hat (K6's plain version, then the transforms)."""
    n = cfg.nv
    nh = n // 2 + 1
    b = pre.rho.shape[0]
    c = min(cfg.chunk(pre.device), b)
    while b % c:
        c -= 1
    rho, sigma, gw = pre.rho[:c], pre.sigma[:c], pre.gain_w[:c]
    fh = torch.fft.rfftn(f, dim=(-3, -2, -1))
    ax, ay, az = op._alpha_factors(cfg, pre, rho, sigma)
    k6_args = (ax, (ay[:, :, None] * az[:, None, :]).reshape(c, -1), fh.reshape(n, -1))
    a1f, a2f = k6.alpha_multiply_reference(*k6_args)
    g1 = torch.fft.irfftn(a1f.reshape(-1, n, n, nh), s=(n, n, n), dim=(-3, -2, -1))
    g2 = torch.fft.irfftn(a2f.reshape(-1, n, n, nh), s=(n, n, n), dim=(-3, -2, -1))
    h = torch.fft.rfftn(g1 * g2, dim=(-3, -2, -1)).reshape(c, -1)
    k5_args = (h, rho, gw, pre.norm_l.reshape(-1))
    k5_kw = dict(length=cfg.domain_length, b_gamma=cfg.b_gamma)
    return k6_args, k5_args, k5_kw


def k1_flops(shape, n_nodes, n_groups, batch=1):
    """K1's arithmetic: every transform is a dense DFT along one axis,
    n3 * N_axis complex multiply-adds per axis, 8 FLOPs each; per eval the
    forward of f, 2 streams per node, one forward per group and the 2 final
    inverses (``csrc/fused_collide.cu``)."""
    n3 = shape[0] * shape[1] * shape[2]
    return batch * 8.0 * n3 * sum(shape) * (2 * n_nodes + n_groups + 3)


def k3_flops(shape, n_nodes, n_groups, batch=1):
    """The least arithmetic of Q_gain_hat from f_hat, the bound of K2, K3 and
    K4: every transform as separable dense DFTs along each axis (as
    ``k1_flops`` counts them), 2 streams per node and one forward per group.
    K2 and K4 do exactly this."""
    n3 = shape[0] * shape[1] * shape[2]
    return batch * 8.0 * n3 * sum(shape) * (2 * n_nodes + n_groups)


def k3_kron_flops(shape, n_nodes, n_groups, batch=1):
    """What K3 does (``csrc/fused_gain_kron.cu``), 8 FLOPs per complex
    multiply-add: per node and stream the (Ny Nz)-deep y/z product and the
    Nx-deep x leg, per group the x and y/z forwards.  The elementwise stages
    (phases, group sums, beta1) add under 2% and are left out."""
    nx, nyz = shape[0], shape[1] * shape[2]
    macs = (2 * n_nodes * (nx * nyz * nyz + nyz * nx * nx)
            + n_groups * (nyz * nx * nx + nx * nyz * nyz))
    return batch * 8.0 * macs


def bound(flops, nbytes, dtype):
    """(bound_ms, bound_by): the larger of FLOPs over the CUDA-core peak and
    bytes over the memory rate (``tc_bound`` for the tensor-core kernels)."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def tc_bound(flops, nbytes, dtype):
    """(bound_ms, bound_by, the CUDA-core bound_ms) of K1, K2 or K4: the larger
    of the transforms' FLOPs on the tensor cores (``TC_PASSES`` products at
    ``PEAK_TC``) and bytes over the memory rate; the same work's bound on the
    CUDA cores (``bound``) beside it, for comparison with earlier rows."""
    t_ops = TC_PASSES[dtype] * flops / PEAK_TC[dtype]
    t_bytes = nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes",
            bound(flops, nbytes, dtype)[0])


def time_ms(fn, trials=TRIALS, warmup=2):
    """Per-call device times in ms (CUDA events around each call)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(trials):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return out


def k3_batch_parity(op, k3, cfg, pre, cells, label):
    """K3 against its plain version on a main-path cell stack at TOL; returns
    (max |kernel - plain|, the kernel's inputs)."""
    dtype = cfg.dtype
    args, kw = k3_inputs(op, cfg, pre, cells)
    q = k3.fused_gain_kron(*args, **kw)
    q_ref = k3.fused_gain_kron_reference(*args, **kw)
    err = float((q - q_ref).abs().max())
    d = err / float(q_ref.abs().max())
    ok = bool(torch.isfinite(torch.view_as_real(q)).all()) and d <= TOL[dtype]
    print(f"  K3 {dtype} {label} batch {tuple(cells.shape)}: max|dQg| {err:.3e} = {d:.3e}"
          f" max|Q_gain_hat| (tol {TOL[dtype]:g}) {'ok' if ok else 'FAIL'}")
    check(ok, f"K3 != plain version on the {label} batch ({dtype})")
    return err, (args, kw)


def k3_yz_stage(k3, args, kw, cfg, card):
    """K3's y/z stage: the device time of both GEMM launches of one call
    (``kron_gemm_kernel``, profiler, ms), one complex ``torch.matmul`` over
    the same rows, (2 E B + E G) Nx x (Ny Nz) times (Ny Nz, Ny Nz) (cuBLAS
    ZGEMM / CGEMM, TF32 off): the stage's library yardstick, which the port
    never calls; and the device time of the whole call (every kernel it
    launches; CUDA events around a call also time the wrapper's host work
    where that is the longer)."""
    f_hat, tables = args[3], args[2]
    e = f_hat.shape[0] if f_hat.dim() == 4 else 1
    nx, ny, nz = f_hat.shape[-3:]
    b = args[0].shape[0]
    rows = (2 * e * b + e * -(-b // kw["radial_group"])) * nx
    fam = profile_calls(lambda: k3.fused_gain_kron(*args, **kw), ("kron_gemm_kernel",), 3)
    stage = None if fam is None else fam["kron_gemm_kernel"][0] / 3e3
    device = None if fam is None else sum(v[0] for v in fam.values()) / 3e3
    x = torch.randn((rows, ny * nz), dtype=cfg.complex_dtype, device=f_hat.device)
    mm = statistics.median(time_ms(lambda: torch.matmul(x, tables.kinv), 5, 1))
    del x
    said = "not measured" if stage is None else f"{stage:.4f} ms of {device:.4f} ms on the card"
    print(f"[11 y/z stage] K3 {cfg.dtype} E {e} grid {(nx, ny, nz)}: the GEMMs {said}"
          f" (profiler, per call); torch.matmul ({rows}, {ny * nz}) x ({ny * nz}, {ny * nz})"
          f" {mm:.4f} ms (library yardstick) | {card}")
    return stage, mm, device


def k3_row(entry, name, dtype, shape, b, groups, e, launches_, plain_, err, ms, plain_ms, yz):
    """K3's kernels-line entry: its bound on the tensor cores (what the
    function needs, separable DFTs: ``tc_bound(k3_flops)``), printed beside
    the dense kron product's on the tensor cores and the CUDA-core bound."""
    csize = 8 if dtype == "float64" else 4
    nx, nyz = shape[0], shape[1] * shape[2]
    n3 = nx * nyz
    nbytes = (2 * e * n3 * 2 * csize  # f_hat in, Q_gain_hat out
              + (2 * nyz * nyz + b * (nx + nyz) + 2 * nx * nx) * 2 * csize  # tables
              + (n3 + 2 * b) * csize)  # |l|, rho, gain_w
    flops = k3_flops(shape, b, groups, batch=e)
    b_ms, b_by, b_cc = tc_bound(flops, nbytes, dtype)
    kron = k3_kron_flops(shape, b, groups, batch=e)
    kron_ms = tc_bound(kron, nbytes, dtype)[0]
    med = statistics.median(ms)
    entry(name, "fused_gain_kron", dtype, launches_, plain_, err, ms, plain_ms, b_ms, b_by,
          dev_ms=yz[2], bound_unit=TC_UNIT[dtype], yz_stage_ms=yz[0], yz_stage_matmul_ms=yz[1])
    print(f"[11 bound] K3 {dtype} {name}: {flops / 1e9:.2f} GFLOP separable, {nbytes / 1e6:.1f} MB"
          f" -> bound {b_ms:.4f} ms ({b_by}, {TC_UNIT[dtype]}; CUDA cores {b_cc:.4f} ms);"
          f" the dense kron product K3 does, {kron / 1e9:.1f} GFLOP, on the tensor cores"
          f" {kron_ms:.4f} ms; measured {med:.3f} ms = {med / b_ms:.1f}x the bound,"
          f" {med / kron_ms:.2f}x the dense product's")


def k1_batch_parity(op, k1, cfg, pre, cells, label):
    """K1 against its plain version on a main-path cell stack; returns the
    max |kernel - plain|."""
    dtype = cfg.dtype
    args, kw = k1_inputs(op, cfg, pre, cells)
    q = k1.fused_collide(*args, **kw)
    q_ref = k1.fused_collide_reference(*args, **kw)
    err = float((q - q_ref).abs().max())
    d = err / float(q_ref.abs().max())
    tol = TOL_F32_16 if dtype == "float32" else TOL[dtype]  # 16^3 cells
    ok = bool(torch.isfinite(q).all()) and d <= tol
    print(f"  K1 {dtype} {label} batch {tuple(cells.shape)}: max|dQ| {err:.3e} = {d:.3e}"
          f" max|Q| (tol {tol:g}) {'ok' if ok else 'FAIL'}")
    check(ok, f"K1 != plain version on the {label} batch ({dtype})")
    return err


def max_rel(a, b):
    return float((a - b).abs().max()) / float(b.abs().max())


def reset_counts(ks):
    for k in (ks.k1, ks.k3, ks.k5, ks.k6, ks.k7, ks.k8, ks.k9, ks.k10, ks.k11, ks.k12):
        k.LAUNCHES = k.REFERENCE_CALLS = 0
    ks.k8.PHASED_LAUNCHES = 0
    for s in ("ct", "transpose"):
        ks.k24.LAUNCHES[s] = ks.k24.REFERENCE_CALLS[s] = 0


def counts(ks):
    return dict(k1=ks.k1.LAUNCHES, k1_plain=ks.k1.REFERENCE_CALLS,
                k2=ks.k24.LAUNCHES["ct"], k2_plain=ks.k24.REFERENCE_CALLS["ct"],
                k3=ks.k3.LAUNCHES, k3_plain=ks.k3.REFERENCE_CALLS,
                k4=ks.k24.LAUNCHES["transpose"], k4_plain=ks.k24.REFERENCE_CALLS["transpose"],
                k5=ks.k5.LAUNCHES, k5_plain=ks.k5.REFERENCE_CALLS,
                k6=ks.k6.LAUNCHES, k6_plain=ks.k6.REFERENCE_CALLS,
                k7=ks.k7.LAUNCHES, k7_plain=ks.k7.REFERENCE_CALLS,
                k8=ks.k8.LAUNCHES, k8_plain=ks.k8.REFERENCE_CALLS,
                k8p=ks.k8.PHASED_LAUNCHES,
                k9=ks.k9.LAUNCHES, k9_plain=ks.k9.REFERENCE_CALLS,
                k10=ks.k10.LAUNCHES, k10_plain=ks.k10.REFERENCE_CALLS,
                k11=ks.k11.LAUNCHES, k11_plain=ks.k11.REFERENCE_CALLS,
                k12=ks.k12.LAUNCHES, k12_plain=ks.k12.REFERENCE_CALLS)


def plain_calls(c):
    return sum(v for k, v in c.items() if k.endswith("_plain"))


def run_cells(step, pre, f, steps, dv3, cell_vol):
    """``steps`` steps from f; returns (f, mass trace, H trace) with the
    initial values first, as the CLIs monitor them."""
    from boltzfft_torch import entropy

    mass, h = [torch.sum(f) * dv3 * cell_vol], [torch.sum(entropy(f, cell_volume=dv3)) * cell_vol]
    for _ in range(steps):
        f = step(f, pre)
        mass.append(torch.sum(f) * dv3 * cell_vol)
        h.append(torch.sum(entropy(f, cell_volume=dv3)) * cell_vol)
    return f, torch.stack(mass).cpu().tolist(), torch.stack(h).cpu().tolist()


def gates(name, f, mass, h):
    drift = abs(mass[-1] - mass[0]) / mass[0]
    rises = [b - a for a, b in zip(h, h[1:])]
    dissipated = h[0] - h[-1]
    worst = max(rises)
    ok = (bool(torch.isfinite(f).all()) and drift <= MASS_TOL and dissipated > 0.0
          and worst <= H_TOL * dissipated)
    print(f"  {name}: mass {mass[0]:.6f} -> {mass[-1]:.6f} (drift {drift:.2e}, tol {MASS_TOL:g});"
          f" H {h[0]:.6f} -> {h[-1]:.6f} (dissipated {dissipated:.3e}, worst step rise"
          f" {worst:.3e}, tol {H_TOL:g} x dissipated) {'ok' if ok else 'FAIL'}")
    check(ok, f"{name}: mass or H-theorem gate")


def run_driver(main, argv):
    """Run a CLI's ``main`` with its standard output captured; returns
    (exit code, lines)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, [line for line in buf.getvalue().splitlines() if line.strip()]


# ---- the ds engine (K7, K8, K9, K12) ------------------------------------
DS_DIGITS_32 = ((1.5403e-03, 1.0119e-04, 4.2512e-05), 1e-4)  # L1, L2, Linf, rtol
DS_LINF_64 = (3.0680e-12, 3.0692e-12)  # JAX ds-oz printed 3.0686e-12; f64 3.0685e-12
DS_GRIDS = (32, 64)
DS_TRIALS = {32: 5, 64: 3}
PEAK_BF16 = 989e12  # dense bf16 tensor-core FLOP/s of an H100 SXM at 700 W
# the ds kernels as the profiler names them (the default route's five first)
DS_FAMILIES = ("oz_contract_kernel", "gmain3_kernel", "hwh_kernel", "preslice_kernel",
               "gmain12_kernel", "hadamard_")
DS_KERNEL_NAMES = {  # kernels-line name -> the profiler's
    "preslice_rows": "preslice_kernel", "oz_contract": "oz_contract_kernel",
    "oz_contract_phased": "oz_contract_kernel", "gmain3_nodemat": "gmain3_kernel",
    "gmain12_nodemat": "gmain12_kernel", "hadamard_wsum": "hadamard_",
    "hadamard_wsum_half": "hwh_kernel",
}


def oz_pairs(cmax):
    """Chunk pairs (i, j) with i + j <= cmax, i < min(7, cmax + 1), j < 8."""
    return sum(1 for i in range(min(7, cmax + 1)) for j in range(8) if i + j <= cmax)


def oz_stage_work(rows, k, ell, mode, cmax=6):
    """(exact-dot MACs, fold FLOPs) of one oz contraction over ``rows`` rows:
    mode "cc" complex in and out, "ri" real in, "ro" real out, "m" merged
    complex, "mro" merged real out.  A folded level costs ~10 float32 FLOPs
    (two_sum, the low-word add, quick_two_sum) per list per output."""
    combos, lists = {"cc": (4, 4), "ri": (2, 2), "ro": (2, 2), "m": (4, 2), "mro": (2, 1)}[mode]
    return rows * ell * oz_pairs(cmax) * k * combos, rows * ell * (cmax + 1) * 10 * lists


def oz_bound(macs, fold_flops, nbytes):
    """(bound_ms, bound_by): the chunk dots at the bf16 tensor-core peak plus
    the fold at the float32 CUDA-core peak, against the bytes at 3.35 TB/s."""
    t_ops = 2.0 * macs / PEAK_BF16 + fold_flops / PEAK_FLOPS["float32"]
    t_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def same(a, b):
    """Bitwise equality of two trees of tensors."""
    if isinstance(a, tuple):
        return all(same(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


def max_diff(a, b):
    if isinstance(a, tuple):
        return max(max_diff(x, y) for x, y in zip(a, b))
    return float((a.double() - b.double()).abs().max())


def parity_check(max_err, label, key, fn, ref):
    """The kernel (twice) against its plain version on the same inputs:
    bitwise equal, and bitwise run to run; records max|kernel - plain| under
    ``key``.  Returns the kernel's result."""
    a, b = fn(), fn()
    r = ref()
    torch.cuda.synchronize()
    err, bit, rerun = max_diff(a, r), same(a, r), same(a, b)
    max_err[key] = max(max_err.get(key, 0.0), err)
    print(f"  {label}: max|kernel - plain| {err:.3e}; bitwise equal {bit}; run to run"
          f" bitwise {rerun} {'ok' if bit and rerun else 'FAIL'}")
    check(bit and rerun, f"{label}: kernel != plain version or not reproducible")
    return a


def profile_eval(fn, families):
    """One call under ``torch.profiler``: ({family: [device us, launches]}
    with the rest under "other", wall us)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    fam = {k: [0.0, 0] for k in (*families, "other")}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(e, "self_device_time_total", None)
        t = t if t is not None else e.self_cuda_time_total
        key = next((k for k in families if k in e.key), "other")
        fam[key][0] += t
        fam[key][1] += e.count
    return fam, wall_us


def profile_calls(fn, families, calls, tries=3):
    """``profile_eval`` over ``calls`` calls of ``fn`` after one warm-up.  The
    profiler can miss a window's kernels: up to ``tries`` windows until it
    sees a launch of ``families[0]``; None if it never does."""
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        fam, _ = profile_eval(lambda: [fn() for _ in range(calls)], families)
        if fam[families[0]][1] > 0:
            return fam
    print(f"  the profiler saw no {families[0]} launch in {tries} windows: not measured")
    return None


def device_ms(fn, family, calls=10):
    """The kernel's own device time per launch (ms), from ``torch.profiler``
    (``profile_calls``), or None: where the wrapper's host time exceeds the
    kernel's, CUDA events around a call time the host."""
    fam = profile_calls(fn, (family,), calls)
    return None if fam is None else fam[family][0] / fam[family][1] / 1e3


def print_profile(label, fam, wall_us, card, phase):
    busy = max(sum(v[0] for v in fam.values()), 1e-9)  # us; 0 if the profiler saw no device
    print(f"[{phase} profile] {label}: device {busy / 1e3:.3f} ms of {wall_us / 1e3:.3f} ms"
          f" wall; idle share {100 * (1 - busy / wall_us):.1f}% | {card}")
    print("  " + ", ".join(f"{k} {v[0] / 1e3:.3f} ms in {v[1]} launches ({100 * v[0] / busy:.1f}%)"
                           for k, v in fam.items()))


def ds_digits(bt, cfg, q, q_c2c):
    """(L1, L2, Linf) of a ds Q against the analytic BKW dQ/dt at t = 6.5, and
    its max distance from the float64 c2c Q in units of max|Q_c2c|."""
    from boltzfft_torch import ds

    g = cfg.velocity_grid
    q64 = ds.to_f64(q)
    check(q64.shape == cfg.grid_shape and np.isfinite(q64).all(), f"ds Q {q64.shape}")
    d = q64 - bt.bkw_dfdt(g.r_squared(), 6.5)
    dv = g.cell_volume
    qc = q_c2c.cpu().numpy()
    dc = np.abs(q64 - qc).max() / np.abs(qc).max()
    return dv * np.abs(d).sum(), np.sqrt(dv * (d * d).sum()), np.abs(d).max(), dc


def ds_phases(bt, dev, card, ks, q_c2c, entry, report):
    """Phases 12-16: the ds engine's kernels against their plain versions at
    the main path's shapes, the ds BKW digits through the card's default
    route, selfcheck_ds, the ds drivers, and times."""
    from boltzfft_torch import ds, health, oz
    from boltzfft_torch import ds_operator as dso
    from boltzfft_torch.cli import maxwell_bkw

    k7, k8, k9, k12 = ks.k7, ks.k8, ks.k9, ks.k12
    tm = ds.tree_map
    max_err, pres, cfgs, fs, collides = {}, {}, {}, {}, {}
    grids = small, big = DS_GRIDS

    # ---- 12. kernels against their plain versions, 32^3 and 64^3, Ns=12 --
    parity = partial(parity_check, max_err)
    # the tensor-core tile at the edge of exactness: every chunk and slice at
    # 127 units, K = 64, sx = sm = 7, cmax = 6 (a merged level sums 14.45 M
    # of float32's 2^24 units), the re list or the im list at its extreme
    print(f"[12 ds parity] K8 on edge operands, K = 64, 256 rows x L 64, C = 2 | {card}")
    for merged in (True, False):
        for real_out in (False, True):
            for im_list in (False, True):
                x, m, xp = k8.edge_operands(64, 64, 256, 2, merged, im_list=im_list, device=dev)
                kw = dict(cmax=6, repeat=True, x_pre=xp, merged=merged, real_out=real_out)
                parity(f"K8 edge merged={merged} real_out={real_out} extreme"
                       f" {'im' if im_list else 're'} list", ("k8", big),
                       lambda: k8.contract_last_oz_nodemat(x, m, **kw),
                       lambda: k8.contract_last_oz_nodemat_reference(x, m, **kw))
    inputs = {}
    for n in grids:
        cfg = bt.CollisionConfig(nv=n, ns=12, impl="c2c", dtype="float32")
        t0 = time.perf_counter()
        collides[n], pre = bt.make_ds_collision_operator(cfg, device=dev)
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        nbytes = sum(t.numel() * t.element_size() for t in _leaves(pre))
        print(f"[12 ds parity] {n}^3 Ns=12: make_ds_collision_operator (host float64 tables,"
              f" split, to the card) {setup:.2f} s, {nbytes / 1e9:.3f} GB on the card | {card}")
        cfgs[n], pres[n] = cfg, pre
        rsq = cfg.velocity_grid.r_squared()
        fs[n] = ds.from_f64(bt.bkw_f(rsq, 6.5), torch.float32, dev)
        f_hat = oz.transform3_oz(ds.cds_from_real(fs[n]), pre.vfwd_sl, cmax=6, real_in=True)
        kxy = torch.ones(n, device=dev)
        kxy[n // 2] = 0.0
        fmask = kxy[:, None, None] * kxy[None, :, None]
        fhs = ds._swap_last2(tm(lambda a: a[..., : n // 2] * fmask, f_hat))  # (Nx, Nz/2, Ny)
        for merged in (True, False):
            parity(f"K7 {n}^3 rows {n * n // 2} K {n} merged={merged}", ("k7", n),
                   lambda: k7.preslice_rows(fhs, cmax=6, merged=merged),
                   lambda: k7.preslice_rows_reference(fhs, cmax=6, merged=merged))
        x_pre = k7.preslice_rows(fhs, cmax=6, merged=True)
        shared = [("forward z, real_in", ds.cds_from_real(fs[n]), pre.vfwd_sl, dict(real_in=True)),
                  ("forward y, complex", ds._swap_last2(f_hat), pre.vfwd_sl, {}),
                  ("inverse, real_out", f_hat, pre.vinv_sl, dict(real_out=True))]
        if n <= 32:
            shared.append(("Hermitian forward z", ds.cds_from_real(fs[n]), pre.vfwd_zh_sl,
                           dict(real_in=True)))
        for label, x, m, kw in shared:
            parity(f"K8 {n}^3 shared matrix, {label}", ("k8", n),
                   lambda: k8.contract_last_oz_kernel(x, m, cmax=6, **kw),
                   lambda: k8.contract_last_oz_kernel_reference(x, m, cmax=6, **kw))
        # the main block's per-node tables: gb groups x ns nodes per stream (gb
        # = 2 at 32^3), or the first sub-batch of 2 nodes (64^3), both streams
        gb = dso.default_group_batch(cfg, cfg.n_gl, dev)
        take = (lambda t: tm(lambda a: a[:gb].reshape((-1,) + tuple(a.shape[2:])), t)) \
            if n <= 32 else (lambda t: tm(lambda a: a[0, :2], t))
        cat = lambda a, b: tm(lambda x, y: torch.cat((x, y)), a, b)
        m_y = cat(take(pre.pm1[1]), take(pre.pm2[1]))
        m_x = cat(take(pre.pm1[0]), take(pre.pm2[0]))
        m_zh = cat(take(pre.pmz_half1w), take(pre.pmz_half2))
        c = m_y.re.shape[0]
        t1 = parity(f"K8 {n}^3 y stage: per-node, repeat, presliced, merged; C={c}", ("k8", n),
                    lambda: k8.contract_last_oz_nodemat(fhs, m_y, cmax=6, repeat=True,
                                                        x_pre=x_pre, merged=True),
                    lambda: k8.contract_last_oz_nodemat_reference(fhs, m_y, cmax=6, repeat=True,
                                                                  x_pre=x_pre, merged=True))
        t1 = tm(lambda a: a.permute(0, 3, 2, 1), t1)
        t2 = parity(f"K8 {n}^3 x stage: per-node, merged; C={c}", ("k8", n),
                    lambda: k8.contract_last_oz_nodemat(t1, m_x, cmax=6, merged=True),
                    lambda: k8.contract_last_oz_nodemat_reference(t1, m_x, cmax=6, merged=True))
        t2 = tm(lambda a: a.permute(0, 3, 1, 2), t2)
        main = parity(f"K8 {n}^3 half-z stage: per-node, merged, real_out; C={c}", ("k8", n),
                      lambda: k8.contract_last_oz_nodemat(t2, m_zh, cmax=6, merged=True,
                                                          real_out=True),
                      lambda: k8.contract_last_oz_nodemat_reference(t2, m_zh, cmax=6, merged=True,
                                                                    real_out=True)).re
        if n <= 32:
            fused = parity(f"K9 {n}^3 C={c}", ("k9", n),
                           lambda: k9.gmain3_nodemat(x_pre, m_y, m_x, m_zh, cfg.grid_shape, cmax=6),
                           lambda: k9.gmain3_reference(x_pre, m_y, m_x, m_zh, cfg.grid_shape, cmax=6))
            chain = dso._g_main_half(fhs, x_pre, m_y, m_x, m_zh, 6, 7, None, merged=True,
                                     grid_shape=cfg.grid_shape, fused=False)
            print(f"  K9 {n}^3 against the K8 kernel chain: max|d| {max_diff(fused, chain):.3e};"
                  f" bitwise equal {same(fused, chain)}")
            check(same(fused, chain), f"K9 != the K8 chain at {n}^3")
        ck = dso._corr_ck(6, 7, None)
        corr1 = dso._nyq_corrections(cfg, pre, f_hat, ck, conj=False, coef=pre.nyq_coef_w)
        corr2 = dso._nyq_corrections(cfg, pre, f_hat, ck, conj=True)
        signs = tuple(torch.as_tensor((-1.0) ** np.arange(n), dtype=torch.float32, device=dev)
                      for _ in range(3))
        half = c // 2
        r1, r2 = tm(lambda a: a[:half], main), tm(lambda a: a[half:], main)
        c1, c2 = take(corr1), take(corr2)
        hargs = (r1, c1, r2, c2, None, cfg.grid_shape, signs)
        parity(f"K12 {n}^3 gb={gb} C={half} per stream", ("k12", n),
               lambda: k12.hadamard_wsum_half(*hargs, groups=gb),
               lambda: k12.hadamard_wsum_half_reference(*hargs, groups=gb))
        inputs[n] = dict(fhs=fhs, x_pre=x_pre, f_hat=f_hat, m_y=m_y, m_x=m_x, m_zh=m_zh,
                         t1=t1, t2=t2, hargs=hargs, gb=gb, c=c)

    # ---- 13. the ds BKW digits through the card's default route ---------
    ds_q, ds_counts = {}, {}
    for n in grids:
        reset_counts(ks)
        q = collides[n](fs[n], pres[n])
        torch.cuda.synchronize()
        c = counts(ks)
        ds_counts[n] = c
        needed = ("k7", "k8", "k12") + (("k9",) if n <= 32 else ("k10",))
        check(all(c[k] > 0 for k in needed) and plain_calls(c) == 0
              and all(c[k] == 0 for k in ("k1", "k2", "k3", "k4", "k5", "k6")),
              f"ds main path {n}^3: dispatch {c}")
        ds_q[n] = q
    for n in grids:
        g = cfgs[n].velocity_grid
        q64 = ds.to_f64(ds_q[n])
        check(q64.shape == (n, n, n) and np.isfinite(q64).all(), f"ds Q at {n}^3")
        d = q64 - bt.bkw_dfdt(g.r_squared(), 6.5)
        l1, l2, linf = g.cell_volume * np.abs(d).sum(), np.sqrt(g.cell_volume * (d * d).sum()), np.abs(d).max()
        qc = q_c2c[n].cpu().numpy()
        dc = np.abs(q64 - qc).max() / np.abs(qc).max()
        print(f"[13 ds digits] {n}^3 Ns=12, make_ds_collision_operator defaults on the card"
              f" (oz, half, merged, gmain {dso._gmain_mode(cfgs[n], pres[n], 6, 7, device=dev)!r},"
              f" herm {n <= 32}, gb {inputs[n]['gb']}): L1 {l1:.5e} L2 {l2:.5e} Linf {linf:.5e};"
              f" vs native f64 staged c2c (cuFFT) {dc:.3e} max|Q| (tol 1e-12); counts {ds_counts[n]}")
        check(dc <= 1e-12, f"ds {n}^3 vs f64 c2c {dc:.3e}")
        if n == small:
            ref, rtol = DS_DIGITS_32
            for got, want, lab in zip((l1, l2, linf), ref, ("L1", "L2", "Linf")):
                check(abs(got - want) <= rtol * want, f"ds 32^3 {lab} {got:.5e} vs {want:.4e}")
        else:
            check(DS_LINF_64[0] <= linf <= DS_LINF_64[1], f"ds 64^3 Linf {linf:.5e}")
    cfg, pre, f = cfgs[big], pres[big], fs[big]
    g = cfg.velocity_grid
    for label, kw, gate in (("g1_reversal=True", dict(g1_reversal=True), True),
                            ("oz_cmax=4", dict(oz_cmax=4), False)):
        q64 = ds.to_f64(dso.collide_ds(cfg, pre, f, contract="oz", g_stream="half", **kw))
        linf = np.abs(q64 - bt.bkw_dfdt(g.r_squared(), 6.5)).max()
        dc = np.abs(q64 - q_c2c[big].cpu().numpy()).max() / float(q_c2c[big].abs().max())
        print(f"  {big}^3 {label}: Linf {linf:.5e}; vs f64 c2c {dc:.3e} max|Q|"
              + (" (gates: Linf in [3.0680, 3.0692]e-12, 1e-12)" if gate else " (printed, no gate)"))
        if gate:
            check(dc <= 1e-12 and DS_LINF_64[0] <= linf <= DS_LINF_64[1], f"{big}^3 {label}")
    q_staged = dso.collide_ds(cfgs[small], pres[small], fs[small], contract="oz", gmain_fused=False)
    print(f"  {small}^3 gmain_fused=False (staged K8 chain) bitwise equal to the default (K9):"
          f" {same(q_staged, ds_q[small])}")
    check(same(q_staged, ds_q[small]), f"{small}^3 staged != K9 route")
    q_again = collides[small](fs[small], pres[small])
    check(same(q_again, ds_q[small]), f"{small}^3 ds eval not reproducible")

    # ---- 14. selfcheck_ds on the card -----------------------------------
    reset_counts(ks)
    r = health.selfcheck_ds(device=dev)
    c = counts(ks)
    print(f"[14 selfcheck_ds] 16^3 ns=6: ok {r['ok']}, rel_linf {r['rel_linf']:.4e} (tol"
          f" {r['rel_tol']}), {r['elapsed_s']:.1f} s, counts {c}")
    check(r["ok"] and c["k8"] > 0 and c["k12"] > 0 and plain_calls(c) == 0, f"selfcheck_ds {r} {c}")

    # ---- 15. the ds drivers ---------------------------------------------
    for extra in (["--trials", "3"], ["--steps", "4"]):
        argv = ["--impl", "ds", "--Nv", str(small), "--Ns", "12", "--device", "cuda", *extra]
        reset_counts(ks)
        rc, lines = run_driver(maxwell_bkw.main, argv)
        c = counts(ks)
        print(f"[15 ds drivers] maxwell_bkw {' '.join(argv)}: exit {rc}, counts {c} | {card}")
        for line in lines[-6:]:
            print(f"  | {line}")
        check(rc == 0 and c["k9"] > 0 and plain_calls(c) == 0, f"maxwell_bkw ds {extra}: {rc} {c}")

    # ---- 16. times --------------------------------------------------------
    for n in grids:
        cfg, pre, f = cfgs[n], pres[n], fs[n]
        ms = time_ms(lambda: collides[n](f, pre), trials=DS_TRIALS[n])
        report(f"ds eval (oz defaults) {n}^3 Ns=12", ms, phase=16)
        fam, wall_us = profile_eval(lambda: collides[n](f, pre), DS_FAMILIES[:5])
        print_profile(f"ds eval {n}^3", fam, wall_us, card, 16)
        inputs[n]["profile"] = fam

    def row(name, key, n, kname, fn, ref, b, lib=None, lib_label="complex128 matmul"):
        ms, pms = time_ms(fn), time_ms(ref, PLAIN_TRIALS, 1)
        lms = time_ms(lib) if lib is not None else None
        dms = device_ms(fn, DS_KERNEL_NAMES[kname])
        report(f"{name} kernel", ms, "call", 16)
        report(f"{name} plain", pms, "call", 16)
        if lms is not None:
            report(f"{name} library yardstick ({lib_label})", lms, "call", 16)
        dev_txt = "not measured" if dms is None else f"{dms:.4f} ms = {dms / b[0]:.1f}x the bound"
        print(f"[16 bound] {name}: {b[0]:.4f} ms ({b[1]}); kernel median"
              f" {statistics.median(ms) / b[0]:.1f}x the bound; device time per launch"
              f" (profiler) {dev_txt} | {card}")
        entry(name, kname, "float32", ds_counts[n][key], ds_counts[n][key + "_plain"],
              max_err[(key, n)], ms, pms, b[0], b[1], lms, dms)

    sx = 7
    for n in grids:
        v = inputs[n]
        nzh, c = n // 2, v["c"]
        rows = n * nzh
        b7 = oz_bound(0, rows * n * 2 * sx * 13, rows * n * 16 + rows * sx * 2 * n * 2)
        row(f"preslice_rows[{n}^3,Ns=12,merged,rows={rows},K={n}]", "k7", n, "preslice_rows",
            lambda: k7.preslice_rows(v["fhs"], cmax=6, merged=True),
            lambda: k7.preslice_rows_reference(v["fhs"], cmax=6, merged=True), b7)
        macs, fold = oz_stage_work(c * rows, n, n, "m")
        mat_bytes = c * 8 * n * n * 2 * 2
        b8 = oz_bound(macs, fold, rows * sx * 2 * n * 2 + mat_bytes + c * rows * n * 16)
        cr = torch.randn(c, rows, n, dtype=torch.complex128, device=dev)
        cm = torch.randn(c, n, n, dtype=torch.complex128, device=dev)
        row(f"oz_contract[{n}^3,Ns=12,y stage,per-node repeat presliced merged,C={c}]", "k8", n,
            "oz_contract",
            lambda: k8.contract_last_oz_nodemat(v["fhs"], v["m_y"], cmax=6, repeat=True,
                                                x_pre=v["x_pre"], merged=True),
            lambda: k8.contract_last_oz_nodemat_reference(v["fhs"], v["m_y"], cmax=6, repeat=True,
                                                          x_pre=v["x_pre"], merged=True),
            b8, lambda: torch.bmm(cr, cm))
        if n == small:
            xs = ds._swap_last2(v["f_hat"])
            macs, fold = oz_stage_work(n * n, n, n, "cc")
            b8s = oz_bound(macs, fold, n ** 3 * 16 + 8 * n * n * 2 * 2 + n ** 3 * 16)
            ca = torch.randn(n * n, n, dtype=torch.complex128, device=dev)
            cb = torch.randn(n, n, dtype=torch.complex128, device=dev)
            row(f"oz_contract[{n}^3,Ns=12,forward y,shared matrix,complex]", "k8", n, "oz_contract",
                lambda: k8.contract_last_oz_kernel(xs, pres[n].vfwd_sl, cmax=6),
                lambda: k8.contract_last_oz_kernel_reference(xs, pres[n].vfwd_sl, cmax=6),
                b8s, lambda: torch.matmul(ca, cb))
            work = [oz_stage_work(c * rows, n, n, "m"), oz_stage_work(c * rows, n, n, "m"),
                    oz_stage_work(c * n * n, nzh, n, "mro")]
            b9 = oz_bound(sum(w[0] for w in work), sum(w[1] for w in work),
                          rows * sx * 2 * n * 2 + c * 8 * 2 * 2 * (2 * n * n + nzh * n)
                          + c * n ** 3 * 8)
            # the library yardstick: the three stages as one complex128 einsum
            # (y, x, then the half-z stage's real part)
            g3 = [torch.randn(*sh, dtype=torch.complex128, device=dev)
                  for sh in ((n, nzh, n), (c, n, n), (c, n, n), (c, nzh, n))]
            row(f"gmain3_nodemat[{n}^3,Ns=12,C={c}]", "k9", n, "gmain3_nodemat",
                lambda: k9.gmain3_nodemat(v["x_pre"], v["m_y"], v["m_x"], v["m_zh"], cfgs[n].grid_shape,
                                          cmax=6),
                lambda: k9.gmain3_reference(v["x_pre"], v["m_y"], v["m_x"], v["m_zh"], cfgs[n].grid_shape,
                                            cmax=6), b9,
                lambda: torch.einsum("xzy,cyj,cxi,czk->cijk", *g3).real, "complex128 einsum")
        else:
            macs, fold = oz_stage_work(c * n * n, nzh, n, "mro")
            b8z = oz_bound(macs, fold, c * n * n * nzh * 16 + c * 8 * nzh * n * 2 * 2 + c * n ** 3 * 8)
            za = torch.randn(c, n * n, nzh, dtype=torch.complex128, device=dev)
            zb = torch.randn(c, nzh, n, dtype=torch.complex128, device=dev)
            row(f"oz_contract[{n}^3,Ns=12,half-z stage,per-node merged real_out,C={c}]", "k8", n,
                "oz_contract",
                lambda: k8.contract_last_oz_nodemat(v["t2"], v["m_zh"], cmax=6, merged=True,
                                                    real_out=True),
                lambda: k8.contract_last_oz_nodemat_reference(v["t2"], v["m_zh"], cmax=6,
                                                              merged=True, real_out=True),
                b8z, lambda: torch.bmm(za, zb))
        gb = v["gb"]
        half = c // 2
        b12 = oz_bound(0, half * n ** 3 * 138, half * n ** 3 * 16 + half * 8 * 3 * n * n * 4
                       + gb * n ** 3 * 8)
        row(f"hadamard_wsum_half[{n}^3,Ns=12,gb={gb},C={half} per stream]", "k12", n,
            "hadamard_wsum_half",
            lambda: k12.hadamard_wsum_half(*v["hargs"], groups=gb),
            lambda: k12.hadamard_wsum_half_reference(*v["hargs"], groups=gb), b12)
    return dict(cfgs=cfgs, pres=pres, fs=fs, ds_q=ds_q, inputs=inputs)


# ---- the ds engine's other routes (K8 phased, K10, K11) ---------------------
ROUTE_TRIALS = {32: 5, 64: 3}  # after 1 warm-up
RULE_ROUNDS = 6  # paired rounds of the main-block routes' evals (phase 20)
ROUTE_KERNELS = {  # the counts each route's eval must show (and no plain call)
    "full": ("k7", "k8", "k11"),
    "phased": ("k8", "k8p", "k11"),
    "12": ("k7", "k8", "k10", "k12"),
}
PHASE_FLOPS = 122  # float32 operations of phase * x per element: 4 ds products, 2 ds adds
HADAMARD_FLOPS = 160  # K11 per element and node: 4 + 2 ds products, 4 ds adds


def ds_route_phases(bt, dev, card, ks, q_c2c, entry, report, st):
    """Phases 17-20: the oz engine's full g-streams (K7, K8, K11), its phased
    full streams on tables without the per-node matrices (K8's phased mode,
    K11) and the fused y+x main block ``gmain_fused="12"`` (K10): the kernels
    against their plain versions at the routes' shapes, each route's digits
    and launches, the ds drivers on those routes, and times."""
    from boltzfft_torch import ds, oz
    from boltzfft_torch import ds_operator as dso
    from boltzfft_torch.cli import maxwell_bkw

    k8, k10, k11 = ks.k8, ks.k10, ks.k11
    tm = ds.tree_map
    cfgs, fs, ds_q, inputs = st["cfgs"], st["fs"], st["ds_q"], st["inputs"]
    grids = DS_GRIDS
    small = grids[0]
    max_err, pre0s, shapes = {}, {}, {}
    parity = partial(parity_check, max_err)
    sb = 2  # collide_ds's sub_batch: the nodes of one launch set of the full routes

    # ---- 17. K8 phased, K11 and K10 against their plain versions ---------
    for n in grids:
        cfg, v = cfgs[n], inputs[n]
        t0 = time.perf_counter()
        pre0s[n] = pre0 = dso.build_ds_precomp(cfg, node_mats=False, device=dev)
        torch.cuda.synchronize()
        print(f"[17 ds routes parity] {n}^3 Ns=12: build_ds_precomp(node_mats=False)"
              f" {time.perf_counter() - t0:.2f} s | {card}")
        # the first launch set of the phased route: radial group 0, nodes 0-1
        ph = tuple(tm(lambda a: a[0, :sb], p) for p in (pre0.ax, pre0.ay, pre0.az))
        gw = tm(lambda a: a[0, :sb], pre0.gain_w)
        m = pre0.vinv_sl
        g = {}
        for conj in (False, True):
            kw = dict(cmax=6, conj=conj)
            t = parity(f"K8 phased {n}^3 z stage, shared x (repeat {sb}), conj={conj}", ("k8p", n),
                       lambda: k8.contract_last_oz_kernel(v["f_hat"], m, phase=ph[2], repeat=sb, **kw),
                       lambda: k8.contract_last_oz_kernel_reference(v["f_hat"], m, phase=ph[2],
                                                                    repeat=sb, **kw))
            xy = ds._swap_last2(t)
            t = ds._swap_last2(parity(
                f"K8 phased {n}^3 y stage, per node (C={sb}), conj={conj}", ("k8p", n),
                lambda: k8.contract_last_oz_kernel(xy, m, phase=ph[1], **kw),
                lambda: k8.contract_last_oz_kernel_reference(xy, m, phase=ph[1], **kw)))
            xx = ds._roll_axis(t, -3, -1)
            g[conj] = ds._roll_axis(parity(
                f"K8 phased {n}^3 x stage, per node (C={sb}), conj={conj}", ("k8p", n),
                lambda: k8.contract_last_oz_kernel(xx, m, phase=ph[0], **kw),
                lambda: k8.contract_last_oz_kernel_reference(xx, m, phase=ph[0], **kw)), -1, -3)
            whole = oz.transform3_oz_phased(v["f_hat"], m, ph, conj=conj, cmax=6)
            check(same(whole, g[conj]), f"transform3_oz_phased != its stages at {n}^3")
        # K11 on the routes' rolled streams (weighted, as the routes call it),
        # unweighted, and on the same streams copied into order
        g_in_order = [tm(lambda a: a.contiguous(), g[b]) for b in (False, True)]
        for label, a1, a2, wk in (("rolled, weighted (the full routes' launch set)", g[False], g[True], gw),
                                  ("rolled, unweighted", g[False], g[True], None),
                                  ("contiguous, weighted", *g_in_order, gw),
                                  ("contiguous, unweighted", *g_in_order, None)):
            parity(f"K11 {n}^3 C={sb} {label}", ("k11", n),
                   lambda: k11.hadamard_wsum(a1, a2, wk),
                   lambda: k11.hadamard_wsum_reference(a1, a2, wk))
        c, grid = v["c"], cfg.grid_shape
        zb0 = k10.plan(n, n, n // 2, c).zb
        g12 = parity(f"K10 {n}^3 C={c} zh_block={zb0} (the plan's rule)", ("k10", n),
                     lambda: k10.gmain12_nodemat(v["x_pre"], v["m_y"], v["m_x"], grid, cmax=6),
                     lambda: k10.gmain12_reference(v["x_pre"], v["m_y"], v["m_x"], grid, cmax=6))
        for zb in (d for d in (1, 2, 4) if (n // 2) % d == 0 and d != zb0
                   and k10.plan(n, n, n // 2, c, zh_block=d).fits):
            other = k10.gmain12_nodemat(v["x_pre"], v["m_y"], v["m_x"], grid, cmax=6, zh_block=zb)
            torch.cuda.synchronize()
            print(f"  K10 {n}^3 zh_block={zb} ({k10.plan(n, n, n // 2, c, zh_block=zb)}) bitwise"
                  f" equal to zh_block={zb0}: {same(other, g12)}")
            check(same(other, g12), f"K10 {n}^3 not invariant in zh_block")
        # node by node equal to the batch; K10 + the half-z K8 call equal to
        # the staged K8 chain on the same nodes
        one = lambda m, j: tm(lambda a: a[j:j + 1], m)
        items = [k10.gmain12_nodemat(v["x_pre"], one(v["m_y"], j), one(v["m_x"], j), grid, cmax=6)
                 for j in (0, c - 1)]
        via = {f: dso._g_main_half(v["fhs"], v["x_pre"], v["m_y"], v["m_x"], v["m_zh"], 6, 7, None,
                                   merged=True, grid_shape=grid, fused=f) for f in ("12", False)}
        torch.cuda.synchronize()
        ok_items = all(same(it, tm(lambda a: a[j:j + 1], g12)) for it, j in zip(items, (0, c - 1)))
        print(f"  K10 {n}^3 per node bitwise equal to the batch: {ok_items}; K10 + K8 half-z"
              f" bitwise equal to the staged K8 chain: {same(via['12'], via[False])}")
        check(ok_items and same(via["12"], via[False]), f"K10 {n}^3: per node / chain differ")
        shapes[n] = dict(ph=ph, gw=gw, g=g, xy=xy, zb=zb0)

    # ---- 18. each route through its entry point, 32^3 and 64^3 -----------
    route_counts = {}
    for n in grids:
        cfg, f = cfgs[n], fs[n]
        t0 = time.perf_counter()
        routes = {
            "full": bt.make_ds_collision_operator(cfg, g_stream="full", device=dev),
            "phased": (lambda x, p, _cfg=cfg: dso.collide_ds(_cfg, p, x, contract="oz"), pre0s[n]),
            "12": bt.make_ds_collision_operator(cfg, gmain_fused="12", device=dev),
        }
        torch.cuda.synchronize()
        print(f"[18 ds routes] {n}^3 Ns=12: make_ds_collision_operator x2"
              f" {time.perf_counter() - t0:.2f} s | {card}")
        for name, (fn, pre) in routes.items():
            reset_counts(ks)
            q = fn(f, pre)
            torch.cuda.synchronize()
            c = counts(ks)
            route_counts[(name, n)] = c
            l1, l2, linf, dc = ds_digits(bt, cfg, q, q_c2c[n])
            qd = ds.to_f64(ds_q[n])
            dh = np.abs(ds.to_f64(q) - qd).max() / np.abs(qd).max()
            print(f"  route {name} {n}^3: L1 {l1:.5e} L2 {l2:.5e} Linf {linf:.5e}; vs f64 c2c"
                  f" {dc:.3e}, vs the default half route {dh:.3e} max|Q| (tol 1e-12); counts {c}")
            ok_counts = (all(c[k] > 0 for k in ROUTE_KERNELS[name]) and plain_calls(c) == 0
                         and all(c[k] == 0 for k in ("k1", "k2", "k3", "k4", "k5", "k6", "k9")))
            check(ok_counts, f"route {name} {n}^3: dispatch {c}")
            check(dc <= 1e-12 and dh <= 1e-12, f"route {name} {n}^3: {dc:.3e} {dh:.3e}")
            if n == small:
                ref, rtol = DS_DIGITS_32
                for got, want, lab in zip((l1, l2, linf), ref, ("L1", "L2", "Linf")):
                    check(abs(got - want) <= rtol * want, f"route {name} 32^3 {lab} {got:.5e}")
            else:
                check(DS_LINF_64[0] <= linf <= DS_LINF_64[1], f"route {name} 64^3 Linf {linf:.5e}")
            again = fn(f, pre)
            check(same(again, q), f"route {name} {n}^3 not reproducible")
            if name == "12":
                staged = dso.collide_ds(cfg, pre, f, contract="oz", gmain_fused=False)
                print(f"  route 12 {n}^3 bitwise equal to gmain_fused=False (staged K8):"
                      f" {same(q, staged)}" + (f"; to the default K9 route: {same(q, ds_q[n])}"
                                               if n == small else ""))
                check(same(q, staged) and (n != small or same(q, ds_q[n])),
                      f"route 12 {n}^3 != staged / K9")
            del q, again

        # ---- times of the route evals (and the default route beside them)
        for name, (fn, pre) in routes.items():
            ms = time_ms(lambda: fn(f, pre), trials=ROUTE_TRIALS[n], warmup=1)
            report(f"ds eval route {name} {n}^3 Ns=12", ms, phase=20)
            fam, wall_us = profile_eval(lambda: fn(f, pre), DS_FAMILIES)
            print_profile(f"ds eval route {name} {n}^3", fam, wall_us, card, 20)
        del routes

    # ---- 19. the ds driver on the new routes ------------------------------
    for extra, key in ((["--g-stream", "full"], "k11"), (["--gmain-fused", "12"], "k10")):
        argv = ["--impl", "ds", "--Nv", str(small), "--Ns", "12", "--device", "cuda",
                "--trials", "3", *extra]
        reset_counts(ks)
        rc, lines = run_driver(maxwell_bkw.main, argv)
        c = counts(ks)
        print(f"[19 ds drivers] maxwell_bkw {' '.join(argv)}: exit {rc}, counts {c} | {card}")
        for line in lines[-6:]:
            print(f"  | {line}")
        linf = [float(line.split()[-1]) for line in lines if line.startswith("Linf error:")]
        check(rc == 0 and c[key] > 0 and plain_calls(c) == 0 and len(linf) == 1
              and abs(linf[0] - DS_DIGITS_32[0][2]) <= DS_DIGITS_32[1] * DS_DIGITS_32[0][2],
              f"maxwell_bkw {extra}: {rc} {c} {linf}")

    # ---- 20. kernel times at the routes' shapes ----------------------------
    def row(name, kname, key, launches, fn, ref, b, lib=None, lib_label="complex128 einsum"):
        ms, pms = time_ms(fn), time_ms(ref, PLAIN_TRIALS, 1)
        lms = time_ms(lib) if lib is not None else None
        dms = device_ms(fn, DS_KERNEL_NAMES[kname])
        report(f"{name} kernel", ms, "call", 20)
        report(f"{name} plain", pms, "call", 20)
        if lms is not None:
            report(f"{name} library yardstick ({lib_label})", lms, "call", 20)
        dev_txt = "not measured" if dms is None else f"{dms:.4f} ms = {dms / b[0]:.1f}x the bound"
        print(f"[20 bound] {name}: {b[0]:.4f} ms ({b[1]}); kernel median"
              f" {statistics.median(ms) / b[0]:.1f}x the bound; device time per launch"
              f" (profiler) {dev_txt}; {launches} launches per eval | {card}")
        entry(name, kname, "float32", launches, 0, max_err[key], ms, pms, b[0], b[1], lms, dms)
        return ms

    sx = 7
    for n in grids:
        v, s = inputs[n], shapes[n]
        nzh, c, n3 = n // 2, v["c"], n ** 3
        # K8 phased, the y stage (per node): rows (C, Nx, Nz), K = L = N
        rows = sb * n * n
        macs, fold = oz_stage_work(rows, n, n, "cc")
        b8 = oz_bound(macs, fold + rows * n * PHASE_FLOPS,
                      rows * n * 16 + sb * n * 16 + 8 * n * n * 2 * 2 + rows * n * 16)
        cx = torch.randn(sb, n * n, n, dtype=torch.complex128, device=dev)
        cp = torch.randn(sb, n, dtype=torch.complex128, device=dev)
        cm = torch.randn(n, n, dtype=torch.complex128, device=dev)
        m = pre0s[n].vinv_sl
        row(f"oz_contract_phased[{n}^3,Ns=12,y stage,per node,C={sb}]", "oz_contract_phased",
            ("k8p", n), route_counts[("phased", n)]["k8p"],
            lambda: k8.contract_last_oz_kernel(s["xy"], m, cmax=6, phase=s["ph"][1]),
            lambda: k8.contract_last_oz_kernel_reference(s["xy"], m, cmax=6, phase=s["ph"][1]),
            b8, lambda: torch.einsum("ck,crk,kl->crl", cp, cx, cm))
        # K11 with C = 2
        b11 = oz_bound(0, sb * n3 * HADAMARD_FLOPS, 2 * sb * n3 * 16 + sb * 8 + n3 * 16)
        c1 = torch.randn((sb,) + (n,) * 3, dtype=torch.complex128, device=dev)
        c2 = torch.randn((sb,) + (n,) * 3, dtype=torch.complex128, device=dev)
        cw = torch.rand(sb, dtype=torch.float64, device=dev).to(torch.complex128)
        row(f"hadamard_wsum[{n}^3,Ns=12,C={sb}]", "hadamard_wsum", ("k11", n),
            route_counts[("full", n)]["k11"],
            lambda: k11.hadamard_wsum(s["g"][False], s["g"][True], s["gw"]),
            lambda: k11.hadamard_wsum_reference(s["g"][False], s["g"][True], s["gw"]),
            b11, lambda: torch.einsum("c,c...,c...->...", cw, c1, c2))
        # K10: stages 1 and 2 over C nodes
        work = [oz_stage_work(c * n * nzh, n, n, "m")] * 2
        b10 = oz_bound(sum(w[0] for w in work), sum(w[1] for w in work),
                       n * nzh * sx * 2 * n * 2 + c * 8 * 2 * 2 * 2 * n * n + c * n * n * nzh * 16)
        grid = cfgs[n].grid_shape
        e10 = [torch.randn(*sh, dtype=torch.complex128, device=dev)
               for sh in ((n, nzh, n), (c, n, n), (c, n, n))]
        ms10 = row(f"gmain12_nodemat[{n}^3,Ns=12,C={c},zh_block={s['zb']}]", "gmain12_nodemat",
                   ("k10", n), route_counts[("12", n)]["k10"],
                   lambda: k10.gmain12_nodemat(v["x_pre"], v["m_y"], v["m_x"], grid, cmax=6),
                   lambda: k10.gmain12_reference(v["x_pre"], v["m_y"], v["m_x"], grid, cmax=6),
                   b10, lambda: torch.einsum("xzy,cyj,cxi->cijz", *e10))
        if n == small:
            # K9 against K10 + the half-z K8 call and the staged K8 chain on
            # the same nodes (the main block of each route), paired: 5 rounds,
            # the order reversed every other round
            main = {fused: (lambda f_=fused: dso._g_main_half(
                v["fhs"], v["x_pre"], v["m_y"], v["m_x"], v["m_zh"], 6, 7, None, merged=True,
                grid_shape=grid, fused=f_)) for fused in ("3", "12", False)}
            label = {"3": "K9 (one cluster per node)", "12": "K10 + K8 half-z", False: "staged K8 x3"}
            outs = {f: main[f]() for f in main}
            torch.cuda.synchronize()
            check(same(outs["3"], outs[False]) and same(outs["12"], outs[False]),
                  f"main block {n}^3: K9 / K10 route != the staged K8 chain")
            print(f"[20 main block] {n}^3 C={c}: K9 and K10 + K8 bitwise equal to the staged"
                  f" K8 chain: True | {card}")
            paired = {f: [] for f in main}
            order = list(main)
            for rnd in range(5):
                for f in (order if rnd % 2 == 0 else order[::-1]):
                    paired[f] += time_ms(main[f])
            for f in order:
                report(f"main block {n}^3 C={c} through {label[f]}, 5 paired rounds",
                       paired[f], "call", 20)
            first = {"3": "gmain3_kernel", "12": "gmain12_kernel", False: "oz_contract_kernel"}
            for f in order:  # device time of each path's kernels, transposes included
                fams = (first[f],) + tuple(k for k in first.values() if k != first[f])
                fam = profile_calls(main[f], fams, 5)
                if fam is not None:
                    parts = ", ".join(f"{k} {v[0] / 5e3:.4f} ms" for k, v in fam.items() if v[1])
                    print(f"  {label[f]}: device {sum(v[0] for v in fam.values()) / 5e3:.4f} ms per"
                          f" main block (profiler, 5 calls): {parts} | {card}")
            print(f"[20 K10 vs K9] {n}^3 C={c}: K10 alone (stages y, x) median"
                  f" {statistics.median(ms10):.4f} ms | {card}")

    # ---- 20. the main-block route rule (ds_operator._gmain_mode): the whole
    # ds eval through K9 ("3", 32^3 only), K10 + the half-z K8 call ("12")
    # and the staged K8 chain (False), one eval of each a round, the order
    # reversed every other round; then each route's device time from one
    # profiled eval.  The routes give the same bits (phase 18).
    for n in grids:
        cfg, f, pre = cfgs[n], fs[n], st["pres"][n]
        modes = (["3"] if n == small else []) + ["12", False]
        evals = {m: (lambda m_=m: dso.collide_ds(cfg, pre, f, contract="oz", g_stream="half",
                                                 gmain_fused=m_)) for m in modes}
        for m in modes:
            evals[m]()
        wall = {m: [] for m in modes}
        for rnd in range(RULE_ROUNDS):
            for m in (modes if rnd % 2 == 0 else modes[::-1]):
                wall[m] += time_ms(evals[m], trials=1, warmup=0)
        for a, b in ((x, y) for i, x in enumerate(modes) for y in modes[i + 1:]):
            d = [x - y for x, y in zip(wall[a], wall[b])]
            print(f"[20 route rule] {n}^3 wall of {a!r} minus {b!r}, round by round: median"
                  f" {statistics.median(d):.3f} ms (min {min(d):.3f}, max {max(d):.3f}) | {card}")
        for m in modes:
            fam, wall_us = profile_eval(evals[m], DS_FAMILIES)
            busy = sum(v[0] for v in fam.values()) / 1e3
            kern = ", ".join(f"{k} {v[0] / 1e3:.3f} ms" for k, v in fam.items() if v[1] and k != "other")
            print(f"[20 route rule] {n}^3 gmain_fused={m!r}: wall median"
                  f" {statistics.median(wall[m]):.3f} ms (min {min(wall[m]):.3f}, max"
                  f" {max(wall[m]):.3f}) over {RULE_ROUNDS} paired rounds; profiled eval: device"
                  f" {busy:.3f} ms of {wall_us / 1e3:.3f} ms wall ({kern}) | {card}")
        print(f"[20 route rule] {n}^3: _gmain_mode picks"
              f" {dso._gmain_mode(cfg, pre, 6, 7, device=dev)!r} | {card}")


def _leaves(tree):
    out = []
    if tree is None:
        return out
    if isinstance(tree, tuple):
        for t in tree:
            out += _leaves(t)
        return out
    return [tree]


def main() -> int:
    # ---- 1. device -----------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; no card, no result")
    card = card_line()
    name = torch.cuda.get_device_name(0)
    dev = torch.device("cuda", 0)
    print(f"[1 device] {card} | torch {torch.__version__} cuda {torch.version.cuda}")
    t_start = time.perf_counter()

    def lap(phase):
        print(f"[{phase} total] {time.perf_counter() - t_start:.1f} s after the device check")

    from types import SimpleNamespace

    import boltzfft_torch as bt
    from boltzfft_torch import _build, health
    from boltzfft_torch import operator as op
    from boltzfft_torch import transport
    from boltzfft_torch.cli import fft_benchmark, loop_benchmark, maxwell_bkw
    from boltzfft_torch.cli.taylor_green_2d3v import taylor_green_f0
    from boltzfft_torch.cli.taylor_green_3d3v import taylor_green_f0_3d
    from boltzfft_torch.kernels import alpha_multiply as k6
    from boltzfft_torch.kernels import fused_collide as k1
    from boltzfft_torch.kernels import fused_gain as k3
    from boltzfft_torch.kernels import fused_gain_dft as k24
    from boltzfft_torch.kernels import gain_reduce as k5
    from boltzfft_torch.kernels import oz_contract as k8
    from boltzfft_torch.kernels import oz_gmain as k9
    from boltzfft_torch.kernels import oz_gmain12 as k10
    from boltzfft_torch.kernels import oz_hadamard as k12
    from boltzfft_torch.kernels import oz_hadamard_full as k11
    from boltzfft_torch.kernels import oz_preslice as k7

    ks = SimpleNamespace(k1=k1, k3=k3, k24=k24, k5=k5, k6=k6, k7=k7, k8=k8, k9=k9, k10=k10,
                         k11=k11, k12=k12)

    # ---- 2. build ------------------------------------------------------
    t0 = time.perf_counter()
    _build.load_library()
    print(f"[2 build] {_build.LIB_PATH} in {time.perf_counter() - t0:.1f} s")
    tc = None
    for line in _build.BUILD_LOG.read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())
        elif line.startswith("# build seconds"):
            print("  per compile, then link, then wall:", line[2:])
        elif line.startswith("# tensor-core instructions"):
            tc = line
    # the exact chunk dots on the tensor cores: HMMA/HGMMA in every oz tile
    # kernel; K1's transforms: DMMA in double, HMMA (TF32) in float
    print(f"[2 sass] {tc[2:] if tc else 'no cuobjdump count in build.log'}")
    counts_tc = ast.literal_eval(tc.split(": ", 1)[1]) if tc else {}
    none = {"HMMA": 0, "HGMMA": 0, "DMMA": 0}
    check(all(counts_tc.get(k, none)["HMMA"] + counts_tc.get(k, none)["HGMMA"] > 0
              for k in ("oz_contract_kernel", "gmain3_kernel", "gmain12_kernel")),
          f"tensor-core instructions missing from the oz kernels: {counts_tc}")
    for k in ("line_dft_kernel", "plane_dft_kernel", "kron_gemm_kernel"):
        dmma = counts_tc.get(f"{k}<double>", none)["DMMA"]
        hmma = counts_tc.get(f"{k}<float>", none)["HMMA"]
        print(f"[2 sass] {k}: DMMA {dmma} (double), HMMA {hmma} (float, 3xTF32)")
        check(dmma > 0 and hmma > 0, f"{k} is not on the tensor cores: {counts_tc}")

    # ---- 3. kernels against their plain versions on the card -----------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("[3 parity] torch.backends.cuda.matmul.allow_tf32 ="
          f" {torch.backends.cuda.matmul.allow_tf32},"
          f" torch.backends.cudnn.allow_tf32 = {torch.backends.cudnn.allow_tf32}")
    max_err = {}  # (kernel, dtype, n) -> max |kernel - plain| at the main-path shapes
    for dtype in ("float64", "float32"):
        for shape, ns, batch in SHAPES_K1:
            cfg = bt.CollisionConfig(nv=shape[0], nvy=shape[1], nvz=shape[2],
                                     ns=ns, impl="fused", fused_scheme="ct", dtype=dtype)
            pre = bt.build_precomp(cfg, dev)
            _, _, f = bkw(bt, cfg, dev)
            if batch == 2:
                f = torch.stack([f, 0.8 * f])
            args, kw = k1_inputs(op, cfg, pre, f)
            q = k1.fused_collide(*args, **kw)
            q_ref = k1.fused_collide_reference(*args, **kw)
            torch.cuda.synchronize()
            err = float((q - q_ref).abs().max())
            scale = float(q_ref.abs().max())
            tol = TOL_F32_16 if dtype == "float32" and max(shape) < 32 else TOL[dtype]
            ok = bool(torch.isfinite(q).all()) and err <= tol * scale
            print(f"  K1 {dtype} grid {shape} ns {ns} E {batch}: max|dQ| {err:.3e}"
                  f" = {err / scale:.3e} max|Q| (tol {tol:g}) {'ok' if ok else 'FAIL'}")
            check(ok, f"K1 != plain version at {dtype} {shape} ns={ns} E={batch}")
            if shape[0] == shape[1] == shape[2] and ns == 12 and batch == 1:
                max_err[("k1", dtype, shape[0])] = err
        for shape, ns, batch in SHAPES_K3:
            cfg = bt.CollisionConfig(nv=shape[0], nvy=shape[1], nvz=shape[2],
                                     ns=ns, impl="fused", fused_scheme="kron", dtype=dtype)
            pre = bt.build_precomp(cfg, dev)
            _, _, f = bkw(bt, cfg, dev)
            f = torch.stack([f * (1.0 - 0.1 * i) for i in range(batch)])
            args, kw = k3_inputs(op, cfg, pre, f)
            q = k3.fused_gain_kron(*args, **kw)
            q_ref = k3.fused_gain_kron_reference(*args, **kw)
            torch.cuda.synchronize()
            err = float((q - q_ref).abs().max())
            scale = float(q_ref.abs().max())
            ok = bool(torch.isfinite(torch.view_as_real(q)).all()) and err <= TOL[dtype] * scale
            print(f"  K3 {dtype} grid {shape} ns {ns} E {batch}: max|dQg| {err:.3e}"
                  f" = {err / scale:.3e} max|Q_gain_hat| (tol {TOL[dtype]:g}) {'ok' if ok else 'FAIL'}")
            check(ok, f"K3 != plain version at {dtype} {shape} ns={ns} E={batch}")
        for scheme, shape, ns, batch in SHAPES_K24:
            label = "K2" if scheme == "ct" else "K4"
            cfg = bt.CollisionConfig(nv=shape[0], nvy=shape[1], nvz=shape[2], ns=ns,
                                     impl="fused", fused_scheme=scheme, dtype=dtype)
            pre = bt.build_precomp(cfg, dev)
            _, _, f = bkw(bt, cfg, dev)
            if batch == 2:
                f = torch.stack([f, 0.8 * f])
            args, kw = k24_inputs(op, cfg, pre, f)
            q = k24.fused_gain_dft(*args, scheme=scheme, **kw)
            q2 = k24.fused_gain_dft(*args, scheme=scheme, **kw)
            q_ref = k24.fused_gain_dft_reference(*args, **kw)
            torch.cuda.synchronize()
            err = float((q - q_ref).abs().max())
            scale = float(q_ref.abs().max())
            tol = TOL_F32_16 if dtype == "float32" and max(shape) < 32 else TOL[dtype]
            ok = (bool(torch.isfinite(torch.view_as_real(q)).all()) and err <= tol * scale
                  and torch.equal(q, q2))
            print(f"  {label} {dtype} grid {shape} ns {ns} E {batch}: max|dQg| {err:.3e}"
                  f" = {err / scale:.3e} max|Q_gain_hat| (tol {tol:g}); run to run bitwise"
                  f" {torch.equal(q, q2)} {'ok' if ok else 'FAIL'}")
            check(ok, f"{label} != plain version at {dtype} {shape} ns={ns} E={batch}")
            if batch == 1 and shape[0] == shape[1] == shape[2] and shape[0] in (32, 64):
                max_err[(label.lower(), dtype, shape[0])] = err
        for n in (32, 64):
            cfg = bt.CollisionConfig(nv=n, ns=12, impl="rfft", use_pallas=True, dtype=dtype)
            pre = bt.build_precomp(cfg, dev)
            _, _, f = bkw(bt, cfg, dev)
            k6_args, k5_args, k5_kw = k56_inputs(op, k6, cfg, pre, f)
            a = k6.alpha_multiply(*k6_args)
            a2 = k6.alpha_multiply(*k6_args)
            a_ref = k6.alpha_multiply_reference(*k6_args)
            torch.cuda.synchronize()
            err = max(float((x - y).abs().max()) for x, y in zip(a, a_ref))
            scale = max(float(y.abs().max()) for y in a_ref)
            same = all(torch.equal(x, y) for x, y in zip(a, a_ref))
            rerun = all(torch.equal(x, y) for x, y in zip(a, a2))
            ok = err <= TOL[dtype] * scale and rerun
            print(f"  K6 {dtype} {n}^3 chunk {tuple(a[0].shape)}: max|d| {err:.3e} = {err / scale:.3e}"
                  f" of max (tol {TOL[dtype]:g}); bitwise equal to plain {same}; run to run"
                  f" bitwise {rerun} {'ok' if ok else 'FAIL'}")
            check(ok, f"K6 != plain version at {dtype} {n}^3")
            max_err[("k6", dtype, n)] = err
            outs = [k5.gain_reduce(*k5_args, node_block=nb, **k5_kw) for nb in NODE_BLOCKS]
            again = k5.gain_reduce(*k5_args, **k5_kw)
            ref = k5.gain_reduce_reference(*k5_args, **k5_kw)
            torch.cuda.synchronize()
            err = float((outs[1] - ref).abs().max())
            scale = float(ref.abs().max())
            nb_same = all(torch.equal(outs[0], o) for o in outs[1:])
            rerun = torch.equal(outs[1], again)
            ok = err <= TOL[dtype] * scale and nb_same and rerun
            print(f"  K5 {dtype} {n}^3 h {tuple(k5_args[0].shape)}: max|d| {err:.3e} = {err / scale:.3e}"
                  f" of max (tol {TOL[dtype]:g}); node_block {NODE_BLOCKS} bitwise equal {nb_same};"
                  f" run to run bitwise {rerun} {'ok' if ok else 'FAIL'}")
            check(ok, f"K5 != plain version or not node_block-invariant at {dtype} {n}^3")
            max_err[("k5", dtype, n)] = err
    # K3's route of collide: against the staged cuFFT c2c (float64), and its
    # float32 Q against its float64 Q at 16^3 (the cancellation rule)
    for shape, ns, _ in SHAPES_K3[:1] + SHAPES_K3[2:4]:
        kw = dict(nv=shape[0], nvy=shape[1], nvz=shape[2], ns=ns)
        cfg = bt.CollisionConfig(impl="fused", fused_scheme="kron", **kw)
        cfg_c = bt.CollisionConfig(impl="c2c", **kw)
        _, _, f = bkw(bt, cfg, dev)
        q = bt.collide(cfg, bt.build_precomp(cfg, dev), f)
        qc = bt.collide(cfg_c, bt.build_precomp(cfg_c, dev), f)
        d = max_rel(q, qc)
        print(f"  K3 route collide {shape} ns {ns} float64 vs staged c2c (cuFFT): {d:.3e} max|Q| (tol 1e-12)")
        check(d <= 1e-12, f"K3 route vs c2c at {shape}: {d:.3e}")
        if shape == (16, 16, 16):
            cfg32 = bt.CollisionConfig(impl="fused", fused_scheme="kron", dtype="float32", **kw)
            q32 = bt.collide(cfg32, bt.build_precomp(cfg32, dev), f.float())
            d32 = max_rel(q32.double(), q)
            print(f"  K3 route collide 16^3 float32 vs float64: {d32:.3e} max|Q| (tol {TOL_F32_16:g})")
            check(d32 <= TOL_F32_16, f"K3 route float32 at 16^3: {d32:.3e}")

    lap(3)

    # ---- 4. the scheme measurement: K1 against the kron route ----------
    print("[4 scheme] the whole Q, K1 (fused_scheme='ct') vs K3 + cuFFT finale"
          f" (fused_scheme='kron'), Ns=12, median of {4 * SCHEME_TRIALS} trials | {card}")
    scheme_ms = {}
    for dtype in ("float64", "float32"):
        for n in SCHEME_GRIDS:
            cfgs = {s: bt.CollisionConfig(nv=n, ns=12, impl="fused", fused_scheme=s, dtype=dtype)
                    for s in ("ct", "kron")}
            pres = {s: bt.build_precomp(c, dev) for s, c in cfgs.items()}
            _, _, f = bkw(bt, cfgs["ct"], dev)
            for e in SCHEME_BATCHES:
                cells = torch.stack([f * (1.0 - 0.5 * i / e) for i in range(e)])
                row = {}
                for s in ("ct", "kron", "kron", "ct"):  # in turns
                    ms = time_ms(lambda: bt.collide(cfgs[s], pres[s], cells), SCHEME_TRIALS, 1)
                    row.setdefault(s, []).extend(ms)
                med = {s: statistics.median(v) for s, v in row.items()}
                scheme_ms[(dtype, n, e)] = med
                win = min(med, key=med.get)
                print(f"  {dtype} {n}^3 E {e:3d}: K1 {med['ct']:.4f} ms, kron route"
                      f" {med['kron']:.4f} ms (medians of {len(row['ct'])}); faster: {win}"
                      f" ({max(med.values()) / min(med.values()):.2f}x)")
    print("  pick_scheme: " + ", ".join(f"{n}^3 -> {bt.pick_scheme(n, n, n)!r}"
                                        for n in SCHEME_GRIDS))
    lap(4)

    # ---- 5. homogeneous main paths -------------------------------------
    reset_counts(ks)
    launches = {}
    main_q = {}
    for dtype in ("float64", "float32"):
        for n in (32, 64):
            cfg = bt.CollisionConfig(nv=n, ns=12, impl="fused", dtype=dtype)
            collide, pre = bt.make_collision_operator(cfg, device="cuda")
            _, _, f = bkw(bt, cfg, dev)
            before = k1.LAUNCHES
            main_q[(dtype, n)] = collide(f, pre)
            torch.cuda.synchronize()
            launches[("k1", dtype, n)] = k1.LAUNCHES - before
    c4 = counts(ks)
    print(f"[5 homogeneous main path] K1: counts {c4}")

    q_c2c = {}
    for n in (32, 64):
        cfg = bt.CollisionConfig(nv=n, ns=12, impl="fused")
        g, rsq, _ = bkw(bt, cfg, dev)
        q_exact = bt.bkw_dfdt(rsq, 6.5)
        q64 = main_q[("float64", n)]
        q32 = main_q[("float32", n)]
        check(tuple(q64.shape) == (n, n, n) and bool(torch.isfinite(q64).all()),
              f"float64 Q at {n}^3 not finite of shape {(n, n, n)}")
        check(bool(torch.isfinite(q32).all()), f"float32 Q at {n}^3 not finite")
        e64 = bt.error_norms_device(q64, q_exact, g.dv)
        e32 = bt.error_norms_device(q32, q_exact, g.dv)
        ref, rtol = BKW_DIGITS[n]
        print(f"  {n}^3 float64: L1 {e64['L1']:.5e} L2 {e64['L2']:.5e} Linf {e64['Linf']:.5e}"
              f" (reference {ref[0]:.4e} {ref[1]:.4e} {ref[2]:.4e}, rtol {rtol:g})")
        for got, want, lab in zip((e64["L1"], e64["L2"], e64["Linf"]), ref, ("L1", "L2", "Linf")):
            check(abs(got - want) <= rtol * want, f"{n}^3 float64 {lab} {got:.5e} vs {want:.4e}")
        scale = float(q64.abs().max())
        d32 = float((q32.double() - q64).abs().max())
        print(f"  {n}^3 float32: Linf {e32['Linf']:.5e}; |Q32 - Q64| {d32 / scale:.3e} max|Q|")
        if n == 32:
            check(e32["Linf"] <= 4.5e-5, f"32^3 float32 Linf {e32['Linf']:.4e} > 4.5e-5")
        else:
            check(d32 <= 2e-5 * scale, f"64^3 |Q32 - Q64| {d32:.3e} > 2e-5 max|Q|")
        cfg_c = bt.CollisionConfig(nv=n, ns=12, impl="c2c")
        coll_c, pre_c = bt.make_collision_operator(cfg_c, device="cuda")
        _, _, f64 = bkw(bt, cfg_c, dev)
        qc = coll_c(f64, pre_c)
        q_c2c[n] = qc
        dc = float((q64 - qc).abs().max())
        print(f"  {n}^3 float64 fused vs staged c2c (cuFFT): {dc / scale:.3e} max|Q| (tol 1e-12)")
        check(dc <= 1e-12 * scale, f"{n}^3 fused vs c2c {dc / scale:.3e} max|Q|")
        del coll_c, pre_c

    route_counts = {}  # (route, dtype, n) -> counts of its main-path run
    for label, kw, hook, grids, needed in ROUTES:
        for dtype in ("float64", "float32"):
            for n in grids:
                reset_counts(ks)
                cfg = bt.CollisionConfig(nv=n, ns=12, dtype=dtype, **kw)
                if hook:
                    pre = bt.build_precomp(cfg, dev)
                    _, _, f = bkw(bt, cfg, dev)
                    q = bt.collide(cfg, pre, f, gain_reduce=lambda x: x)
                else:
                    collide, pre = bt.make_collision_operator(cfg, device="cuda")
                    _, _, f = bkw(bt, cfg, dev)
                    q = collide(f, pre)
                torch.cuda.synchronize()
                c = counts(ks)
                route_counts[(label, dtype, n)] = c
                check(all(c[k] > 0 for k in needed) and plain_calls(c) == 0,
                      f"{label} {dtype} {n}^3: dispatch {c}")
                main_q[(label, dtype, n)] = q
                del pre
            for n in grids:
                g, rsq, _ = bkw(bt, bt.CollisionConfig(nv=n, ns=12), dev)
                q_exact = bt.bkw_dfdt(rsq, 6.5)
                q = main_q[(label, dtype, n)]
                check(tuple(q.shape) == (n, n, n) and bool(torch.isfinite(q).all()),
                      f"{label} {dtype} Q at {n}^3 not finite of shape {(n, n, n)}")
                e = bt.error_norms_device(q, q_exact, g.dv)
                scale = float(q_c2c[n].abs().max())
                if dtype == "float64":
                    ref, rtol = BKW_DIGITS[n]
                    dc = float((q - q_c2c[n]).abs().max()) / scale
                    print(f"  {label} {n}^3 float64: L1 {e['L1']:.5e} L2 {e['L2']:.5e}"
                          f" Linf {e['Linf']:.5e} (rtol {rtol:g}); vs staged c2c {dc:.3e} max|Q|"
                          f" (tol 1e-12); counts {route_counts[(label, dtype, n)]}")
                    for got, want, lab in zip((e["L1"], e["L2"], e["Linf"]), ref, ("L1", "L2", "Linf")):
                        check(abs(got - want) <= rtol * want,
                              f"{label} {n}^3 float64 {lab} {got:.5e} vs {want:.4e}")
                    check(dc <= 1e-12, f"{label} {n}^3 vs c2c {dc:.3e} max|Q|")
                else:
                    d32 = float((q.double() - main_q[(label, "float64", n)]).abs().max()) / scale
                    print(f"  {label} {n}^3 float32: Linf {e['Linf']:.5e}; |Q32 - Q64| {d32:.3e}"
                          f" max|Q|; counts {route_counts[(label, dtype, n)]}")
                    if n == 32:
                        check(e["Linf"] <= 4.5e-5, f"{label} 32^3 float32 Linf {e['Linf']:.4e}")
                    else:
                        check(d32 <= 2e-5, f"{label} 64^3 |Q32 - Q64| {d32:.3e} max|Q|")
    for key in list(main_q):
        if len(key) == 3:
            del main_q[key]

    lap(5)

    # ---- 6. inhomogeneous main path (K1; K3 by name) -------------------
    # The CLIs' defaults: 16^3 velocities, Ns=12, CFL time step, MUSCL.
    tg = dict(u0=0.8, temperature=3.0, length=1.0)
    solvers = {}
    kron_steps = {}  # dtype -> the TG-2D step on K3 and its Precomp
    finals = {}  # (dtype, run) -> the run's last state
    c5 = {}
    for dtype in ("float64", "float32"):
        cfg = bt.CollisionConfig(nv=16, ns=12, impl="fused", dtype=dtype)
        cfg_k = dataclasses.replace(cfg, fused_scheme="kron")
        collide, pre = bt.make_collision_operator(cfg, device="cuda")
        collide_k, pre_k = bt.make_collision_operator(cfg_k, device="cuda")
        g = cfg.velocity_grid
        vmax = float(abs(g.v).max())
        d2, d3, dsod = 1.0 / 16, 1.0 / 8, 1.0 / 32
        step2 = transport.make_inhomogeneous_step_2d(
            cfg, collide, dx=d2, dy=d2, dt=transport.cfl_dt(vmax, d2), knudsen=0.2)
        step2k = transport.make_inhomogeneous_step_2d(
            cfg_k, collide_k, dx=d2, dy=d2, dt=transport.cfl_dt(vmax, d2), knudsen=0.2)
        step3 = transport.make_inhomogeneous_step_3d(
            cfg, collide, dx=d3, dy=d3, dz=d3, dt=transport.cfl_dt(vmax, d3), knudsen=0.2)
        step1 = transport.make_inhomogeneous_step(
            cfg, collide, dx=dsod, dt=transport.cfl_dt(vmax, dsod), knudsen=0.5)
        f2 = taylor_green_f0(cfg, 16, device=dev, **tg)
        f3 = taylor_green_f0_3d(cfg, 8, device=dev, **tg)
        f1 = transport.sod_initial_condition(cfg, 32, device=dev)
        dv3 = g.cell_volume
        solvers[dtype] = (cfg, collide, pre, step2, f2)
        kron_steps[dtype] = (step2k, pre_k)
        runs = [("TG-2D 16x16 cells, 10 steps", step2, pre, f2, 10, d2 * d2, "k1"),
                ("TG-3D 8^3 cells, 2 steps", step3, pre, f3, 2, d3 ** 3, "k1"),
                ("Sod 32 cells, 5 steps", step1, pre, f1, 5, dsod, "k1"),
                ("TG-2D 16x16 cells on K3, 3 steps", step2k, pre_k, f2, 3, d2 * d2, "k3")]
        for label, step, p, f0, steps, cell_vol, kern in runs:
            reset_counts(ks)
            f, mass, h = run_cells(step, p, f0, steps, dv3, cell_vol)
            c = counts(ks)
            c5[(dtype, label)] = c
            finals[(dtype, label.split(",")[0])] = f
            check(tuple(f.shape) == tuple(f0.shape), f"{label}: shape {tuple(f.shape)}")
            gates(f"{dtype} {label}", f, mass, h)
            print(f"    counts {c}")
            others = sum(v for k, v in c.items() if k != kern)
            check(c[kern] == 2 * steps and others == 0, f"{dtype} {label}: dispatch {c}")
    cfg, collide, pre, step2, f2 = solvers["float64"]
    cfg_c = bt.CollisionConfig(nv=16, ns=12, impl="c2c")
    coll_c, pre_c = bt.make_collision_operator(cfg_c, device="cuda")
    d2 = 1.0 / 16
    step_c = transport.make_inhomogeneous_step_2d(
        cfg_c, coll_c, dx=d2, dy=d2, dt=transport.cfl_dt(float(abs(cfg.velocity_grid.v).max()), d2),
        knudsen=0.2)
    a, b = step2(f2, pre), step_c(f2, pre_c)
    d = max_rel(a, b)
    print(f"  float64 TG-2D step, K1 route vs staged c2c (cuFFT): {d:.3e} relative (tol 1e-12)")
    check(d <= 1e-12, f"TG-2D step vs c2c {d:.3e}")
    del coll_c, pre_c, step_c

    lap(6)

    # ---- 7. determinism and dispatch -----------------------------------
    for dtype in ("float64", "float32"):
        cfg = bt.CollisionConfig(nv=32, ns=12, impl="fused", dtype=dtype)
        collide, pre = bt.make_collision_operator(cfg, device="cuda")
        _, _, f = bkw(bt, cfg, dev)
        a, b = collide(f, pre), collide(f, pre)
        fs = torch.stack([f, 0.8 * f])
        qs = collide(fs, pre)
        one = torch.stack([collide(fs[0], pre), collide(fs[1], pre)])
        torch.cuda.synchronize()
        check(torch.equal(a, b), f"{dtype}: two evals differ")
        check(torch.equal(qs, one), f"{dtype}: batched eval != per-item evals")
        print(f"[7 determinism] K1 {dtype} 32^3: run-to-run bitwise equal, batched == per-item bitwise")
        cfg, collide, pre, step2, f2 = solvers[dtype]
        cfg_k = dataclasses.replace(cfg, fused_scheme="kron")
        check(torch.equal(step2(f2, pre), step2(f2, pre)), f"{dtype}: two TG-2D steps differ")
        cells = f2.reshape(-1, *f2.shape[2:])
        for route, c in (("K1", cfg), ("K3", cfg_k)):
            qb = bt.collide(c, pre, cells)
            one = torch.stack([bt.collide(c, pre, x) for x in cells])
            check(torch.equal(qb, one), f"{dtype}: {route} 256-cell collide != per-cell collides")
        print(f"[7 determinism] {dtype}: two TG-2D steps (K1) bitwise equal; the K1 and K3"
              f" 256-cell collides == {len(cells)} per-cell collides bitwise")
        # the other main-path batches: TG-3D's 512 cells (98,304 stream
        # grids, past the 65,535 gridDim.y/z limit) and Sod's 32
        for run in ("TG-3D 8^3 cells", "Sod 32 cells"):
            cells = finals[(dtype, run)].reshape(-1, *f2.shape[2:])
            err = k1_batch_parity(op, k1, cfg, pre, cells, run)
            max_err[("k1cells", dtype)] = max(max_err.get(("k1cells", dtype), 0.0), err)
            err, _ = k3_batch_parity(op, k3, cfg, pre, cells, run)
            max_err[("k3", dtype)] = max(max_err.get(("k3", dtype), 0.0), err)
            for route, c in (("K1", cfg), ("K3", cfg_k)):
                qb = bt.collide(c, pre, cells)
                one = torch.stack([bt.collide(c, pre, x) for x in cells])
                check(torch.equal(qb, one), f"{dtype}: {route} {run} collide != per-cell collides")
            print(f"[7 determinism] {dtype}: {run}: the K1 and K3 {len(cells)}-cell collides =="
                  f" {len(cells)} per-cell collides bitwise")
    # the default route at 8^3 (pick_scheme: kron, K3) on a 256-cell stack
    k3_default = {}
    for dtype in ("float64", "float32"):
        cfg8 = bt.CollisionConfig(nv=8, ns=12, impl="fused", dtype=dtype)
        collide8, pre8 = bt.make_collision_operator(cfg8, device="cuda")
        _, _, f8 = bkw(bt, cfg8, dev)
        cells8 = torch.stack([f8 * (1.0 - 0.5 * i / 256) for i in range(256)])
        reset_counts(ks)
        q8 = collide8(cells8, pre8)
        torch.cuda.synchronize()
        c7 = counts(ks)
        check(op.fused_scheme(cfg8) == "kron" and c7["k3"] == 1 and c7["k1"] == 0
              and plain_calls(c7) == 0, f"{dtype} 8^3 default route: dispatch {c7}")
        k3_default[dtype] = (c7, cfg8, pre8, cells8)
        one = torch.stack([collide8(x, pre8) for x in cells8])
        check(torch.equal(q8, one), f"{dtype}: the 8^3 256-cell collide != per-cell collides")
        said = ""
        if dtype == "float64":
            cfg_c8 = bt.CollisionConfig(nv=8, ns=12, impl="c2c")
            d8 = max_rel(q8, bt.collide(cfg_c8, bt.build_precomp(cfg_c8, dev), cells8))
            check(d8 <= 1e-12, f"8^3 default route vs c2c {d8:.3e}")
            said = f"; vs staged c2c (cuFFT) {d8:.3e} max|Q| (tol 1e-12)"
        print(f"[7 determinism] {dtype}: the 8^3 default route (K3) on 256 cells == 256"
              f" per-cell collides bitwise{said}; counts {c7}")
    check(c4["k1"] > 0 and all(launches[k] > 0 for k in launches),
          f"homogeneous main path launched K1 {launches}")
    check(plain_calls(c4) == 0, f"homogeneous main path called a plain version {c4}")
    print(f"[7 dispatch] homogeneous K1 path {c4}; every route launched its kernels with 0"
          " plain calls; inhomogeneous paths: K1 (or K3 by name) launched 2 per step, nothing else")

    lap(7)

    # ---- 8. RK4 relaxation (maxwell_bkw --steps) -----------------------
    reset_counts(ks)
    argv = ["--Nv", "32", "--Ns", "12", "--impl", "fused", "--dtype", "float64",
            "--steps", "10", "--device", "cuda"]
    rc, lines = run_driver(maxwell_bkw.main, argv)
    c8 = counts(ks)
    print(f"[8 relaxation] maxwell_bkw {' '.join(argv)}: exit {rc}, counts {c8}")
    for line in lines[-7:]:
        print(f"  | {line}")
    check(rc == 0 and c8["k1"] == 40 and plain_calls(c8) == 0, f"maxwell_bkw --steps: rc {rc} {c8}")
    trajs = {}
    for impl in ("fused", "c2c"):
        cfg = bt.CollisionConfig(nv=32, ns=12, impl=impl)
        collide, pre = bt.make_collision_operator(cfg, device="cuda")
        g, rsq, _ = bkw(bt, cfg, dev)
        f0 = torch.as_tensor(bt.bkw_f(rsq, 5.5), dtype=cfg.real_dtype, device=dev)
        trajs[impl] = bt.make_relaxation(collide, pre, dt=0.125, n_steps=10, method="rk4",
                                         record=lambda x: bt.moments(x, g.v, g.dv))(f0)
    d = max_rel(trajs["fused"].f, trajs["c2c"].f)
    dm = max_rel(trajs["fused"].recorded.mass, trajs["c2c"].recorded.mass)
    print(f"  10 RK4 steps through K1 vs through c2c (cuFFT), float64: f {d:.3e}, mass trace"
          f" {dm:.3e} relative (tol 1e-12)")
    check(d <= 1e-12 and dm <= 1e-12, f"relaxation K1 vs c2c {d:.3e} {dm:.3e}")

    # ---- 9. health.selfcheck on the card --------------------------------
    for impl, kw, needed in (("fused", {}, "k1"), ("rfft", dict(use_pallas=True), "k5"),
                             ("dft", {}, None)):
        reset_counts(ks)
        r = health.selfcheck(impl=impl, cfg_kwargs=kw, device=dev)
        c = counts(ks)
        print(f"[9 selfcheck] impl={impl} {kw}: ok {r['ok']}, rel_linf {r['rel_linf']:.4e}"
              f" (tol {r['rel_tol']}), counts {c}")
        check(r["ok"] and plain_calls(c) == 0 and (needed is None or c[needed] > 0),
              f"selfcheck {impl} {kw}: {r} {c}")
    r = health.selfcheck(impl="fused", device=dev,
                         pre_transform=lambda p: dataclasses.replace(p, beta2=2.0 * p.beta2))
    print(f"[9 selfcheck] fused with beta2 doubled: ok {r['ok']}, rel_linf {r['rel_linf']:.4e}")
    check(not r["ok"], "selfcheck passed a corrupted Precomp")

    # ---- 10. the benchmark drivers -------------------------------------
    for mod, extra in ((fft_benchmark, []), (loop_benchmark, ["--tile-size", "4", "8", "16"])):
        argv = ["--Nv", "32", "--Ns", "12", "--dtype", "float64", "--device", "cuda", *extra]
        reset_counts(ks)
        rc, lines = run_driver(mod.main, argv)
        c = counts(ks)
        print(f"[10 drivers] {mod.__name__} {' '.join(argv)}: exit {rc} | {card}")
        for line in lines:
            print(f"  | {line}")
        check(rc == 0 and not any("FAILED" in line for line in lines), f"{mod.__name__} failed")
        if mod is loop_benchmark:
            check(c["k5"] > 0 and c["k5_plain"] == 0, f"loop_benchmark dispatch {c}")

    lap(10)

    # ---- 11. times -----------------------------------------------------
    times = {}
    kernels = []

    def report(label, ms, unit="eval", phase=11):
        rates = [1e3 / t for t in ms]
        print(f"[{phase} time] {label}: median {statistics.median(ms):.4f} mean {statistics.mean(ms):.4f}"
              f" ms/{unit} (mean {statistics.mean(rates):.4f} min {min(rates):.4f}"
              f" stdev {statistics.stdev(rates):.4f} {unit}s/s, {len(ms)} trials) | {card}")

    def entry(name, key, dtype, launches_, plain_, err, ms, plain_ms, b_ms, b_by, lib_ms=None,
              dev_ms=None, **extra):
        source, replaces = KERNEL_SOURCES[key]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches_, "plain_calls": plain_, "max_abs_err": err,
            "ms": statistics.median(ms), "ms_mean": statistics.mean(ms),
            "plain_ms": statistics.median(plain_ms), "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None if lib_ms is None else statistics.median(lib_ms),
            **({} if dev_ms is None else {"device_ms": dev_ms}), **extra,
        })

    # K1's stream stage (the node streams' y/z plane pass and the x pass
    # fused with the group sum) by the profiler, beside one torch.fft.ifftn
    # over the same 2 x n_nodes grids: the transforms' library time
    stream_stage = {}

    for n in (32, 64):
        for dtype in ("float32", "float64"):
            cfg = bt.CollisionConfig(nv=n, ns=12, impl="fused", dtype=dtype)
            pre = bt.build_precomp(cfg, dev)
            _, _, f = bkw(bt, cfg, dev)
            args, kw = k1_inputs(op, cfg, pre, f)
            for label, fn in (("kernel", k1.fused_collide), ("plain", k1.fused_collide_reference)):
                ms = time_ms(lambda: fn(*args, **kw), *((PLAIN_TRIALS, 1) if label == "plain" else ()))
                times[("k1", n, dtype, label)] = ms
                report(f"K1 {n}^3 Ns=12 {dtype} {label}", ms)
            elem = "double" if dtype == "float64" else "float"
            # the x pass in either matrix variant (the last template argument)
            fams = (f"plane_dft_kernel<{elem}, false>", f"line_dft_kernel<{elem}, false, 2, 1, ")
            fam = profile_calls(lambda: k1.fused_collide(*args, **kw), fams, 3)
            x = torch.randn((2 * cfg.n_nodes, n, n, n), dtype=cfg.complex_dtype, device=dev)
            ifft_ms = statistics.median(time_ms(lambda: torch.fft.ifftn(x, dim=(-3, -2, -1)), 5, 1))
            del x
            parts = None if fam is None else [fam[k][0] / 3e3 for k in fams]
            stage = None if parts is None else sum(parts)
            stream_stage[(n, dtype)] = (stage, ifft_ms)
            said = "not measured" if parts is None else (
                f"{stage:.4f} ms (y/z plane pass {parts[0]:.4f}, x pass with the group sum"
                f" {parts[1]:.4f})")
            print(f"[11 stream stage] K1 {n}^3 {dtype}: the node streams {said}, profiler,"
                  f" per eval; torch.fft.ifftn over the {2 * cfg.n_nodes} grids"
                  f" {ifft_ms:.4f} ms (library yardstick) | {card}")
            # K2 and K4 at the same shape, on this f's spectrum
            args, kw = k24_inputs(op, cfg, pre, f)
            for key, scheme in (("k2", "ct"), ("k4", "transpose")):
                for label, fn in (("kernel", lambda: k24.fused_gain_dft(*args, scheme=scheme, **kw)),
                                  ("plain", lambda: k24.fused_gain_dft_reference(*args, **kw))):
                    ms = time_ms(fn, *((PLAIN_TRIALS, 1) if label == "plain" else ()))
                    times[(key, n, dtype, label)] = ms
                    report(f"{key.upper()} {n}^3 Ns=12 {dtype} {label}", ms, "call")
            # K6 and K5 on the first node chunk of the rfft + use_pallas route
            cfg_p = bt.CollisionConfig(nv=n, ns=12, impl="rfft", use_pallas=True, dtype=dtype)
            pre_p = bt.build_precomp(cfg_p, dev)
            k6_args, k5_args, k5_kw = k56_inputs(op, k6, cfg_p, pre_p, f)
            w = k5.node_weights(*k5_args[1:], dtype=cfg.real_dtype, **k5_kw).to(cfg.complex_dtype)
            # K6's yardstick: one broadcasting multiply by the precomputed
            # alpha of both streams, (2, B, N, M2) x (N, M2)
            a6 = k6_args[0][:, :, None] * k6_args[1][:, None, :]
            alpha = torch.stack((a6, a6.conj()))
            for key, label, fn in (
                ("k6", "kernel", lambda: k6.alpha_multiply(*k6_args)),
                ("k6", "plain", lambda: k6.alpha_multiply_reference(*k6_args)),
                ("k6", "library", lambda: torch.mul(alpha, k6_args[2])),
                ("k5", "kernel", lambda: k5.gain_reduce(*k5_args, **k5_kw)),
                ("k5", "plain", lambda: k5.gain_reduce_reference(*k5_args, **k5_kw)),
                ("k5", "library", lambda: torch.einsum("bm,bm->m", w, k5_args[0])),
            ):
                ms = time_ms(fn, *((PLAIN_TRIALS, 1) if label == "plain" else ()))
                times[(key, n, dtype, label)] = ms
                tag = {"k5": "torch.einsum('bm,bm->m') on precomputed weights (library yardstick)",
                       "k6": "torch.mul by the precomputed alpha of both streams (library yardstick)"
                       }[key] if label == "library" else label
                report(f"{key.upper()} {n}^3 Ns=12 {dtype} chunk of {k6_args[0].shape[0]} nodes {tag}",
                       ms, "call")
            csize = 8 if dtype == "float64" else 4
            b, n3, m2 = pre.rho.shape[0], n ** 3, n * (n // 2 + 1)
            c6 = k6_args[0].shape[0]
            b_k6 = bound(24.0 * c6 * n * m2,
                         csize * 2 * (c6 * n + c6 * m2 + n * m2 + 2 * c6 * n * m2), dtype)
            m = n * m2
            b_k5 = bound(10.0 * c6 * m, csize * (2 * c6 * m + m + 2 * c6 + 2 * m), dtype)
            b_k24 = tc_bound(k3_flops((n, n, n), b, cfg.n_gl),
                          csize * (2 * n3 * 2 + n3 + 2 * b + 2 * 3 * b * n + 6 * 2 * n * n), dtype)
            print(f"[11 bound] {n}^3 {dtype}: K2/K4 {b_k24[0]:.4f} ms ({b_k24[1]}, {TC_UNIT[dtype]};"
                  f" CUDA cores {b_k24[2]:.4f}), K6 {b_k6[0]:.4f} ms ({b_k6[1]}), K5"
                  f" {b_k5[0]:.4f} ms ({b_k5[1]})")
            for key, kname, b_ms, route_label in (
                ("k2", "fused_gain_ct", b_k24, ROUTES[1][0]),
                ("k4", "fused_gain_transpose", b_k24, ROUTES[2][0]),
                ("k6", "alpha_multiply", b_k6, ROUTES[0][0]),
                ("k5", "gain_reduce", b_k5, ROUTES[0][0]),
            ):
                rc_ = route_counts[(route_label, dtype, n)]
                tc = {} if len(b_ms) == 2 else {"bound_unit": TC_UNIT[dtype]}
                entry(f"{kname}[{dtype},{n}^3,Ns=12]", kname, dtype, rc_[key], rc_[key + "_plain"],
                      max_err[(key, dtype, n)], times[(key, n, dtype, "kernel")],
                      times[(key, n, dtype, "plain")], b_ms[0], b_ms[1],
                      times.get((key, n, dtype, "library")), **tc)
    # the whole eval through each route, as a user calls it
    route_cfgs = [("K1 (fused)", dict(impl="fused"), False),
                  ("staged rfft", dict(impl="rfft"), False),
                  ("staged c2c", dict(impl="c2c"), False)] + [
        (label, kw, hook) for label, kw, hook, _, _ in ROUTES]
    # in turns: every route once forward and once backward, half the trials
    # each time
    for n in (32, 64):
        for dtype in ("float32", "float64"):
            runs = []
            for label, kw, hook in route_cfgs:
                if kw.get("impl") == "dft" and n == 64:
                    continue
                cfg = bt.CollisionConfig(nv=n, ns=12, dtype=dtype, **kw)
                pre = bt.build_precomp(cfg, dev)
                _, _, f = bkw(bt, cfg, dev)
                red = (lambda x: x) if hook else None
                runs.append((label, partial(bt.collide, cfg, pre, f, red)))
            route_ms = {label: [] for label, _ in runs}
            for order in (runs, runs[::-1]):
                for label, fn in order:
                    route_ms[label] += time_ms(fn, TRIALS // 2, 1)
            for label, _ in runs:
                report(f"route {label}, collide at {n}^3 Ns=12 {dtype} (in turns)", route_ms[label])
            del runs
    tg2d = {}
    for dtype in ("float32", "float64"):
        cfg, collide, pre, step2, f2 = solvers[dtype]
        cfg_k = dataclasses.replace(cfg, fused_scheme="kron")
        cells = f2.reshape(-1, *f2.shape[2:])
        err, (args, kw) = k3_batch_parity(op, k3, cfg_k, pre, cells, "TG-2D")
        max_err[("k3", dtype)] = max(max_err[("k3", dtype)], err)
        ms_k3 = time_ms(lambda: k3.fused_gain_kron(*args, **kw))
        ms_plain = time_ms(lambda: k3.fused_gain_kron_reference(*args, **kw), PLAIN_TRIALS, 1)
        yz = k3_yz_stage(k3, args, kw, cfg_k, card)
        args1, kw1 = k1_inputs(op, cfg, pre, cells)
        ms_k1 = time_ms(lambda: k1.fused_collide(*args1, **kw1))
        ms_step = time_ms(lambda: step2(f2, pre))
        step2k, pre_k = kron_steps[dtype]
        ms_step_k3 = time_ms(lambda: step2k(f2, pre_k))
        for label, ms, unit in (("K3 kernel", ms_k3, "call"), ("K3 plain", ms_plain, "call"),
                                ("K1 kernel (whole Q)", ms_k1, "call"), ("TG-2D step (K1)", ms_step, "step"),
                                ("TG-2D step (K3, fused_scheme='kron')", ms_step_k3, "step")):
            report(f"{label} on the TG-2D batch, 256 x 16^3 Ns=12 {dtype}", ms, unit)
        tg2d[dtype] = dict(k3=ms_k3, plain=ms_plain, k1=ms_k1, step=ms_step, yz=yz,
                           batch=cells.shape[0], nodes=pre.rho.shape[0],
                           groups=-(-pre.rho.shape[0] // cfg.ns_eff))
        t = tg2d[dtype]
        b1 = tc_bound(k1_flops((16, 16, 16), t["nodes"], t["groups"], batch=t["batch"]),
                      (8 if dtype == "float64" else 4) * 4096 * (2 * t["batch"] + 2), dtype)
        print(f"[11 bound] K1 {dtype} TG-2D batch: {b1[0]:.4f} ms ({b1[1]}, {TC_UNIT[dtype]});"
              f" on the CUDA cores {b1[2]:.4f} ms; kernel median {statistics.median(ms_k1):.4f} ms")

    # where a TG-2D step's device time goes (the K1 route)
    for dtype in ("float64", "float32"):
        cfg, collide, pre, step2, f2 = solvers[dtype]
        g = cfg.velocity_grid
        v = torch.as_tensor(g.vx, dtype=cfg.real_dtype, device=dev).reshape(1, 1, -1, 1, 1)
        ms_adv = time_ms(lambda: [transport._advect_muscl_axis(f2, v, 1.0 / 16, 0.01, ax)
                                  for ax in (0, 1, 0, 1)])
        step2(f2, pre)
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(3):
                step2(f2, pre)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        fam = {"K1 transforms (plane_dft_kernel, line_dft_kernel)": 0.0,
               "K1 init, assemble": 0.0,
               "cuFFT": 0.0, "elementwise (advection, RK2, casts, phases)": 0.0}
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            t = getattr(e, "self_device_time_total", None)
            t = t if t is not None else e.self_cuda_time_total
            nm = e.key.lower()
            if "dft_kernel" in nm:
                fam["K1 transforms (plane_dft_kernel, line_dft_kernel)"] += t
            elif any(s in nm for s in ("init_kernel", "assemble_kernel")):
                fam["K1 init, assemble"] += t
            elif "fft" in nm:
                fam["cuFFT"] += t
            else:
                fam["elementwise (advection, RK2, casts, phases)"] += t
        busy = sum(fam.values())
        parts = ", ".join(f"{k} {v / 3e3:.3f} ms ({100 * v / busy:.1f}%)" for k, v in fam.items())
        print(f"[11 profile] TG-2D step {dtype}, 3 steps: device {busy / 3e3:.3f} ms/step of"
              f" {wall_us / 3e3:.3f} ms/step wall; idle share {100 * (1 - busy / wall_us):.1f}% | {card}")
        print(f"  {parts}")
        print(f"  the 4 MUSCL half-steps alone (CUDA events): {statistics.mean(ms_adv):.4f} ms/step")

    for dtype in ("float64", "float32"):
        for n in (32, 64):
            cfg = bt.CollisionConfig(nv=n, ns=12, impl="fused", dtype=dtype)
            csize = 8 if dtype == "float64" else 4
            n3 = n ** 3
            b_ms, b_by, b_cc = tc_bound(k1_flops((n, n, n), cfg.n_nodes, cfg.n_gl),
                                        csize * n3 * 4, dtype)  # f, beta2, |l| in; Q out
            stage, ifft_ms = stream_stage[(n, dtype)]
            print(f"[11 bound] K1 {n}^3 {dtype}: {b_ms:.4f} ms ({b_by}, {TC_UNIT[dtype]});"
                  f" on the CUDA cores {b_cc:.4f} ms; kernel median"
                  f" {statistics.median(times[('k1', n, dtype, 'kernel')]):.4f} ms")
            entry(f"fused_collide[{dtype},{n}^3,Ns=12]", "fused_collide", dtype,
                  launches[("k1", dtype, n)], c4["k1_plain"], max_err[("k1", dtype, n)],
                  times[("k1", n, dtype, "kernel")], times[("k1", n, dtype, "plain")], b_ms, b_by,
                  bound_unit=TC_UNIT[dtype],
                  stream_stage_ms=stage, stream_stage_ifftn_ms=ifft_ms)
    # K3 on the TG-2D batch (fused_scheme="kron", its launches in the K3
    # TG-2D runs of phase 6) and on the 8^3 stack of the default route (its
    # launch in phase 7)
    for dtype in ("float64", "float32"):
        t = tg2d[dtype]
        kron_runs = [c for (dt, lab), c in c5.items() if dt == dtype and "K3" in lab]
        k3_row(entry, f"fused_gain_kron[{dtype},TG-2D {t['batch']}x16^3,Ns=12]", dtype,
               (16, 16, 16), t["nodes"], t["groups"], t["batch"],
               sum(c["k3"] for c in kron_runs), sum(c["k3_plain"] for c in kron_runs),
               max_err[("k3", dtype)], t["k3"], t["plain"], t["yz"])
        c7, cfg8, pre8, cells8 = k3_default[dtype]
        err, (args, kw) = k3_batch_parity(op, k3, cfg8, pre8, cells8, "8^3 default route")
        ms_k3 = time_ms(lambda: k3.fused_gain_kron(*args, **kw))
        ms_plain = time_ms(lambda: k3.fused_gain_kron_reference(*args, **kw), PLAIN_TRIALS, 1)
        for label, ms in (("K3 kernel", ms_k3), ("K3 plain", ms_plain)):
            report(f"{label} on the 8^3 stack, 256 x 8^3 Ns=12 {dtype}", ms, "call")
        b8 = pre8.rho.shape[0]
        k3_row(entry, f"fused_gain_kron[{dtype},8^3 256x8^3,Ns=12]", dtype, (8, 8, 8), b8,
               -(-b8 // cfg8.ns_eff), 256, c7["k3"], c7["k3_plain"], err, ms_k3, ms_plain,
               k3_yz_stage(k3, args, kw, cfg8, card))
    lap(11)
    st = ds_phases(bt, dev, card, ks, q_c2c, entry, report)
    lap(16)
    ds_route_phases(bt, dev, card, ks, q_c2c, entry, report, st)
    lap(20)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
