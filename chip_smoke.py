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
   32^3, 40^3, 64^3), K6 (``alpha_multiply``, bitwise, and at a ragged
   shape: B 6, N 8, M2 40) and K5 (``gain_reduce``, at
   node blocks 1, 8 and 64, each against its plain version at the same node
   block, its split and one-launch routes bitwise equal) at the shapes the
   rfft + use_pallas route gives them at 32^3 and 64^3; every new kernel
   bitwise equal to
   itself run to run; K3's route of ``collide`` against the staged cuFFT
   c2c in float64 (1e-12 max|Q|);
4. the scheme measurement: the whole Q through K1 against the kron route
   (K3 plus its cuFFT finale) at 8^3, 12^3 and 16^3, Ns=12, on E = 1, 32, 256
   and 512 distributions, float32 and float64, medians of 20 trials (5 in
   each of four turns);
5. the homogeneous main paths, ``make_collision_operator(cfg, jit=False)``
   (eager: each kernel's launches per eval) or ``collide`` at 32^3 and
   64^3, Ns=12, on the BKW distribution at t = 6.5: K1
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
   float64, each step replayed from one CUDA graph: K1 counted 8 times, the
   warm-up and the capture of a 4-eval step), the same relaxation graphed
   (``make_relaxation(jit=True)``) bitwise equal to the eager one, and
   through c2c (1e-12 relative);
9. ``health.selfcheck`` on the card for fused, rfft + use_pallas and dft,
   and with a corrupted ``Precomp`` (must fail);
10. ``fft_benchmark`` and ``loop_benchmark`` at 32^3, Ns=12, float64;
11. times (CUDA events, 2 warm-ups, 10 trials, a plain version 1 and 5;
    median and mean): K1 at 32^3
    and 64^3; K2, K4, K5, K6 at the main paths' shapes with their bounds,
    plain versions and K5's and K6's library yardsticks, K5's and K6's
    device time (profiler; both of K5's launches on its split route, whose
    scratch's bytes are printed beside the bound, which counts only the
    function's own);
    ``collide`` through each route
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
    unmerged, on the swapped half spectrum, on the half path's whole step
    from f_hat in one launch (``preslice_half``: the half-z slice, the x/y
    Nyquist mask and the swap read in place) and on the full streams'
    operand (f_hat in place), copying none, K8 in every mode the default
    route launches (shared matrix
    real_in / complex / real_out, Hermitian forward z; per-node repeat +
    presliced + merged, merged, merged real_out), K9 at 32^3 (also against
    the K8 kernel chain), K12 with gb = 2 (32^3) and 1 (64^3), with and
    without a running sum and a node weight, copying none of the eval's
    operands; each bitwise equal to its plain version and to itself run to
    run;
13. the ds BKW digits through ``make_ds_collision_operator``'s card defaults
    (``jit=True``: the eval replayed from a CUDA graph; 32^3: the reference
    L1/L2/Linf at rtol 1e-4; 64^3: Linf in [3.0680, 3.0692]e-12), each within
    1e-12 max|Q| of the float64 staged cuFFT c2c of phase 5, with counts
    reset around the first call (an eager warm-up and the capture: K7, K8,
    K12 and K9 at 32^3, K10 at 64^3 launched; no plain call), which count
    twice those of an eager eval with the operator's arguments, the
    launches of one eval that the kernels line reports, a hash of each
    Q's hi and lo bytes beside its digits, the replayed Q bitwise equal to
    the eager eval with the ds elementwise chains plain
    (``kernels.ds_elementwise.plain_chains``); ``g1_reversal`` and ``oz_cmax=4``
    at 64^3, and the staged K8 chain at 32^3 bitwise equal to K9's route;
14. ``health.selfcheck_ds`` on the card (16^3, ns=6, oz vs vpu < 1e-11);
15. ``maxwell_bkw --impl ds --Nv 32 --Ns 12``, ``--trials 3`` and ``--steps 4``;
16. times: the ds eval at 32^3 (5 trials) and 64^3 (3 trials) after 2
    warm-ups, a ``torch.profiler`` window over one eval of each (device time
    and launches by kernel, idle share), and K7, K8, K9, K12 at main-path
    shapes against their plain versions, their bounds (chunk-pair dots at the
    bf16 tensor-core peak plus the fold at the float32 CUDA-core peak, or
    bytes) and, for K8, a complex128 ``torch.bmm``/``matmul`` yardstick, for
    K9 a complex128 ``einsum`` of its three stages, for K12 one complex128
    ``einsum`` over the assembled streams (assembly excluded), and each kernel's device
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
    default route, launching its kernels and no plain version (the graphed
    "full" and "12" operators' first calls twice an eager eval's launches,
    which are the counts reported); "12" bitwise equal to the staged route
    and, at 32^3, to K9's; each route bitwise equal to its eval with the ds
    elementwise chains plain;
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
    rule's pick; the phased route's eager eval against the same eval with
    the ds elementwise chains plain, 4 paired rounds;
21. the ds eval replayed from one CUDA graph (``make_ds_collision_operator(
    jit=True)``, a fresh capture) against the eager ``collide_ds``: the
    default route at 32^3 and 64^3 (the hash of Q's hi and lo bytes equal to
    eager's and to the recorded ``DS_Q_HASHES``) and the full streams at
    32^3, bitwise; the capture's seconds and counts (twice an eager eval's:
    the warm-up and the capture; a replay moves none) and the operands the
    K7, K8 and K12 wrappers copied in an eager eval (none for K7 and K12), a
    second f leaving the first Q intact, the graph pool's memory against the
    eager peak, the same eval captured with the ds elementwise chains plain
    (bitwise equal), the graph's kernel nodes (its debug dump) and the
    host's time in one ``replay()``, paired wall times of the graph and the
    eager eval (10 rounds at 32^3, 6 at 64^3) and one profiled replay and
    eager eval;
22. every route of ``make_collision_operator(cfg)`` (``jit=True``: the eval
    replayed from one CUDA graph) against the eager ``collide`` on the same
    precomp, bitwise (capture, replay, a second f): rfft + use_pallas at
    32^3 and 64^3 in float64 and float32 (with the BKW digits through the
    replay in float64), K1 at 32^3 and 64^3 and on the TG-2D batch (256 x
    16^3), kron (K3) on 256 x 8^3, c2c at 32^3; counts, pool memory,
    paired walls and a profiled replay and eager eval, as in phase 21.

23. the multi-device slice on the one card: (a) a 1-rank NCCL mesh
    (``make_mesh()`` with no process group), ``make_sharded_collision_operator``
    on the fused (K1) and rfft + use_pallas (K6, K5) routes at 32^3 and 64^3
    in float64 and float32, and ``make_sharded_ds_collision_operator`` at
    32^3 on its card defaults, each bitwise equal to its unsharded
    operator, with the BKW (and ds) digits and paired walls; (b)
    ``ensemble_bkw --ensemble 256 --Nv 32 --Ns 12 --impl fused --steps 2``
    in float64 (BASELINE config 5's size), its H gate and mass line, its
    evals/s; (c) two gloo ranks sharing the card (NCCL takes one rank a
    card), spawned as ``chip_smoke.py --two-rank``: the node-sharded fused
    route (K2 on each rank, then the all_reduce) at 32^3 and 64^3 float64
    and the 2-shard ds operator at 32^3, each within 1e-12 max|Q| of its
    unsharded eval, with the digits, the ds operator bitwise equal on each
    rank to its eval with the ds elementwise chains plain (the cross-rank
    fold's ``ds.cadd`` too).
24. the tooling and examples slice: (a) ``save_precomp`` / ``load_precomp``
    at 32^3 and 64^3 float64 on rfft + use_pallas and K1, the loaded
    tables' replayed eval bitwise equal to the saved ones', with the BKW
    digits, the archive's bytes and the load seconds; (b) ``autotune`` on
    rfft + use_pallas at 32^3 and 64^3 in float64 and float32 and on c2c at
    32^3: each candidate's ms per eval, the winner, its K5/K6 launches per
    eval, its digits, and the memory given back; (c) ``autotune_ds`` at
    32^3 and 64^3 on the card defaults (each ``sub_batch``'s ms per replayed
    eval, the winner's ds digits); (d) ``trace`` around one replayed K1
    eval, its JSON holding K1's kernels as often as ``torch.profiler``
    counts them on a replay and its kernels' summed ms within 10% of the
    profiler's (the events more or fewer than its count, and the first
    call's window, printed); (e) the seven examples' ``main``
    at their defaults (``convergence_study --max-nv 64``, its 64^3 Linf
    3.0685e-12; ``precision_ladder --Nv 32``; ``adjoint_fit --impl fused``;
    ``mixing_2d3v`` and ``taylor_green_2d3v`` unsharded and on a 1-rank
    NCCL mesh, line for line equal), each with its gate and wall.

25. the whole-program slice: each unit the JAX package compiles whole,
    replayed from one CUDA graph a step, against its eager run (the
    operator eager too) and against the eager step around the graphed
    operator, bitwise on the final f and every trace entry, with the path's
    gates, launches (the first graphed run counts two eager steps', a
    replay none, the inner operators keep no graph), the step graph's nodes
    (its debug dump), paired walls, the
    pool against the eager peak and one profiled replay and eager step: the
    TG-2D / TG-3D / Sod drivers' bodies (``cli.step_body``) at the phase-6
    sizes, on K1 (TG-2D in float64 and float32) and on K3 at 8^3; RK4
    through ``make_relaxation`` at 32^3 (K1) and 64^3 (rfft + use_pallas)
    float64, 10 steps, and ds RK4 at 32^3 and 64^3, 4 steps; the ensemble
    (E = 256 x 32^3 float64, 2 steps); the decomposed TG-2D step built with
    ``jit=True`` on a 1-rank NCCL mesh; and the TG-2D, TG-3D and Sod drivers'
    printed lines, graphed against their body run eagerly.  The ds RK4 cells
    also capture the step graph with the ds elementwise chains plain:
    bitwise equal.
26. the ds engine's elementwise chains (``csrc/ds_elementwise.cu``, one
    launch a chain of ``boltzfft_torch/ds.py``): each kernel against its
    plain chain, bitwise, on the operands of its largest call in one eager
    default eval at 32^3 and 64^3, read in place (RK's axpy in one RK4
    step), and in float64 pairs at the same shapes; the chains the eval does
    not run on operands made from its cmul operands; each kernel's time
    (events), its plain chain's, its device time per launch (profiler, and
    replayed from a graph of 20 launches), its bound (bytes over 3.35 TB/s against its float operations over the
    float32 peak) and its launches per eval, per RK4 step and per RK4 step
    graph (phase 25's count).

The ds evals of phases 13, 15, 16 and 18 (but the phased route) go through
``make_ds_collision_operator``, so they replay CUDA graphs; phase 20's route
rule and ``selfcheck_ds`` call ``collide_ds`` eagerly.  A
``[N total]`` line after phases 3-11, 16 and 20-26 gives the seconds since
the device check. The plain versions of K7-K12 run with the ds chains plain.
The last two lines are a JSON summary of the kernels and ``{"ok": true,
"device": {...}}``.
"""

from __future__ import annotations

import ast
import collections
import contextlib
import dataclasses
import hashlib
import io
import json
import statistics
import subprocess
import sys
import tempfile
import time
from functools import partial
from pathlib import Path

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
NODE_BLOCKS = (1, 8, 64)  # K5's node blocks, each held to its plain version
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
# The ds elementwise chains (csrc/ds_elementwise.cu) stand for no Pallas kernel:
# each for the loop XLA fuses a chain of the JAX package into under jit, at
# the chain's JAX line (the ds operator, or the call site of a composition)
EW_SOURCE = "boltzfft_torch/csrc/ds_elementwise.cu"
EW_REPLACES = {
    "add": "boltzfft/ds.py:150", "sub": "boltzfft/ds.py:158", "mul": "boltzfft/ds.py:162",
    "mul_f": "boltzfft/ds.py:170", "cadd": "boltzfft/ds.py:200", "cmul": "boltzfft/ds.py:204",
    "cmul_both": "boltzfft/ds.py:215", "cmul_ds": "boltzfft/ds.py:233",
    "axpy": "boltzfft/timestepper.py:33", "caxpy": "boltzfft/ds_operator.py:1062",
    "sub_mul": "boltzfft/ds_operator.py:1154", "cadd_signed": "boltzfft/ds_operator.py:417",
    "add_signed": "boltzfft/ds_operator.py:625",
}
KERNEL_SOURCES.update({f"ds_{op}": (EW_SOURCE, line) for op, line in EW_REPLACES.items()})


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
    for s in ks.ew.OPS:
        ks.ew.LAUNCHES[s] = ks.ew.REFERENCE_CALLS[s] = 0


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
                k12=ks.k12.LAUNCHES, k12_plain=ks.k12.REFERENCE_CALLS,
                ew=sum(ks.ew.LAUNCHES.values()), ew_plain=sum(ks.ew.REFERENCE_CALLS.values()),
                **{f"ew_{s}": v for s, v in ks.ew.LAUNCHES.items()})


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


def run_driver(fn, *args, **kw):
    """Run ``fn(*args, **kw)`` (a CLI's ``main(argv)``, a tuner) with its
    standard output captured; returns (its result, lines)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return out, [line for line in buf.getvalue().splitlines() if line.strip()]


# ---- the ds engine (K7, K8, K9, K12) ------------------------------------
DS_DIGITS_32 = ((1.5403e-03, 1.0119e-04, 4.2512e-05), 1e-4)  # L1, L2, Linf, rtol
DS_LINF_64 = (3.0680e-12, 3.0692e-12)  # JAX ds-oz printed 3.0686e-12; f64 3.0685e-12
DS_GRIDS = (32, 64)
DS_TRIALS = {32: 5, 64: 3}
PEAK_BF16 = 989e12  # dense bf16 tensor-core FLOP/s of an H100 SXM at 700 W
# the ds kernels as the profiler names them (the default route's five first)
DS_FAMILIES = ("oz_contract_kernel", "gmain3_kernel", "hwh_kernel", "preslice_kernel",
               "gmain12_kernel", "hadamard_", "ds_elementwise_kernel")
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
    """Bitwise equality of two trees (tuples, lists, ds pairs, None) of tensors."""
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


def max_diff(a, b):
    if isinstance(a, tuple):
        return max(max_diff(x, y) for x, y in zip(a, b))
    return float((a.double() - b.double()).abs().max())


def plain(fn):
    """``fn`` with the ds engine's elementwise chains run plain on the card
    (``kernels.ds_elementwise.plain_chains``): a kernel's plain version is
    plain PyTorch throughout."""
    from boltzfft_torch.kernels import ds_elementwise as ew

    def run():
        with ew.plain_chains():
            return fn()

    return run


def parity_check(max_err, label, key, fn, ref):
    """The kernel (twice) against its plain version on the same inputs:
    bitwise equal, and bitwise run to run; records max|kernel - plain| under
    ``key``.  Returns the kernel's result."""
    a, b = fn(), fn()
    r = plain(ref)()
    torch.cuda.synchronize()
    err, bit, rerun = max_diff(a, r), same(a, r), same(a, b)
    max_err[key] = max(max_err.get(key, 0.0), err)
    print(f"  {label}: max|kernel - plain| {err:.3e}; bitwise equal {bit}; run to run"
          f" bitwise {rerun} {'ok' if bit and rerun else 'FAIL'}")
    check(bit and rerun, f"{label}: kernel != plain version or not reproducible")
    return a


def self_device_us(e) -> float:
    """A ``key_averages`` row's own device microseconds (older torch names
    the attribute ``self_cuda_time_total``)."""
    t = getattr(e, "self_device_time_total", None)
    return t if t is not None else e.self_cuda_time_total


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
        t = self_device_us(e)
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
          f" wall; idle share {100 * (1 - busy / wall_us):.1f}%;"
          f" {sum(v[1] for v in fam.values())} launches | {card}")
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
        fmask2 = kxy[:, None] * kxy[None, :]
        copies = k7.COPIES
        for merged in (True, False):
            parity(f"K7 {n}^3 rows {n * n // 2} K {n} merged={merged}", ("k7", n),
                   lambda: k7.preslice_rows(fhs, cmax=6, merged=merged),
                   lambda: k7.preslice_rows_reference(fhs, cmax=6, merged=merged))
            # the half path's whole step: f_hat read in place, masked, swapped
            parity(f"K7 {n}^3 half path, one launch from f_hat, merged={merged}", ("k7", n),
                   lambda: k7.preslice_half(f_hat, fmask2, cmax=6, merged=merged),
                   lambda: k7.preslice_half_reference(f_hat, fmask2, cmax=6, merged=merged))
        parity(f"K7 {n}^3 full streams' operand, f_hat in place, rows {n * n} K {n} merged",
               ("k7", n), lambda: k7.preslice_rows(f_hat, cmax=6, merged=True),
               lambda: k7.preslice_rows_reference(f_hat, cmax=6, merged=True))
        check(k7.COPIES == copies, f"K7 copied {k7.COPIES - copies} operands")
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
        # with and without the running sum (the eval's earlier sub-batches)
        # and a node weight
        rng = np.random.default_rng(n)
        acc = ds.from_f64(rng.standard_normal(((gb,) if gb > 1 else ()) + cfg.grid_shape),
                          torch.float32, dev)
        wk = ds.from_f64(rng.uniform(0.5, 1.5, half), torch.float32, dev)
        copies = k12.COPIES
        for w_, acc_ in ((None, None), (None, acc), (wk, None), (wk, acc)):
            args_ = hargs[:4] + (w_,) + hargs[5:]
            parity(f"K12 {n}^3 gb={gb} C={half} per stream, weight {w_ is not None},"
                   f" running sum {acc_ is not None}", ("k12", n),
                   lambda: k12.hadamard_wsum_half(*args_, groups=gb, acc=acc_),
                   lambda: k12.hadamard_wsum_half_reference(*args_, groups=gb, acc=acc_))
        check(k12.COPIES == copies, f"K12 copied {k12.COPIES - copies} operands of the ds eval's")
        inputs[n] = dict(fhs=fhs, x_pre=x_pre, f_hat=f_hat, fmask2=fmask2, m_y=m_y, m_x=m_x,
                         m_zh=m_zh, t1=t1, t2=t2, hargs=hargs, gb=gb, c=c)

    # ---- 13. the ds BKW digits through the card's default route ---------
    ds_q, ds_counts = {}, {}
    for n in grids:
        reset_counts(ks)
        q = collides[n](fs[n], pres[n])
        torch.cuda.synchronize()
        c = counts(ks)
        needed = ("k7", "k8", "k12", "ew") + (("k9",) if n <= 32 else ("k10",))
        check(all(c[k] > 0 for k in needed) and plain_calls(c) == 0
              and all(c[k] == 0 for k in ("k1", "k2", "k3", "k4", "k5", "k6")),
              f"ds main path {n}^3: dispatch {c}")
        # the first graphed call counts two evals (the warm-up and the
        # capture) and a replay none: the launches of one eval, which a
        # replay repeats, are an eager eval's with the operator's arguments
        reset_counts(ks)
        dso.collide_ds(cfgs[n], pres[n], fs[n], contract="oz")
        torch.cuda.synchronize()
        ds_counts[n] = counts(ks)
        check(all(c[k] == 2 * ds_counts[n][k] for k in c),
              f"ds main path {n}^3: first graphed call {c} != 2 x eager {ds_counts[n]}")
        # the replayed eval against the same eval with every ds chain plain
        q_plain = plain(lambda: dso.collide_ds(cfgs[n], pres[n], fs[n], contract="oz"))()
        print(f"[13 ds digits] {n}^3: the replayed eval (fused ds chains, {c['ew'] // 2} launches"
              f" an eval) bitwise equal to the eager eval with the chains plain"
              f" {same(q, q_plain)} | {card}")
        check(same(q, q_plain), f"ds main path {n}^3: fused ds chains != plain chains")
        ds_q[n] = q
    for n in grids:
        g = cfgs[n].velocity_grid
        q64 = ds.to_f64(ds_q[n])
        check(q64.shape == (n, n, n) and np.isfinite(q64).all(), f"ds Q at {n}^3")
        d = q64 - bt.bkw_dfdt(g.r_squared(), 6.5)
        l1, l2, linf = g.cell_volume * np.abs(d).sum(), np.sqrt(g.cell_volume * (d * d).sum()), np.abs(d).max()
        qc = q_c2c[n].cpu().numpy()
        dc = np.abs(q64 - qc).max() / np.abs(qc).max()
        bits = q_hash(ds_q[n])
        print(f"[13 ds digits] {n}^3 Ns=12, make_ds_collision_operator defaults on the card"
              f" (oz, half, merged, gmain {dso._gmain_mode(cfgs[n], pres[n], 6, 7, device=dev)!r},"
              f" herm {n <= 32}, gb {inputs[n]['gb']}): L1 {l1:.5e} L2 {l2:.5e} Linf {linf:.5e};"
              f" vs native f64 staged c2c (cuFFT) {dc:.3e} max|Q| (tol 1e-12); sha256 of the"
              f" hi, lo bytes {bits}; launches of one eval (an eager eval; the first graphed"
              f" call, a warm-up and the capture, counted twice these) {ds_counts[n]}")
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
        ms, pms = time_ms(fn), time_ms(plain(ref), PLAIN_TRIALS, 1)
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
        # the half-z spectrum of f_hat and the (Nx, Ny) mask read, the chunks written
        b7 = oz_bound(0, rows * n * 2 * sx * 13,
                      rows * n * 16 + n * n * 4 + rows * sx * 2 * n * 2)
        row(f"preslice_half[{n}^3,Ns=12,merged,rows={rows},K={n},one launch from f_hat]", "k7",
            n, "preslice_rows",
            lambda: k7.preslice_half(v["f_hat"], v["fmask2"], cmax=6, merged=True),
            lambda: k7.preslice_half_reference(v["f_hat"], v["fmask2"], cmax=6, merged=True),
            b7)
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
        # the yardstick: K11's, one complex128 einsum over the two streams
        # once assembled (the assembly from main block and planes excluded)
        g12 = [torch.randn((gb, half // gb) + cfgs[n].grid_shape, dtype=torch.complex128,
                           device=dev) for _ in range(2)]
        row(f"hadamard_wsum_half[{n}^3,Ns=12,gb={gb},C={half} per stream]", "k12", n,
            "hadamard_wsum_half",
            lambda: k12.hadamard_wsum_half(*v["hargs"], groups=gb),
            lambda: k12.hadamard_wsum_half_reference(*v["hargs"], groups=gb), b12,
            lambda: torch.einsum("gc...,gc...->g...", *g12).real,
            "complex128 einsum of the assembled streams, assembly excluded")
        del g12
    return dict(cfgs=cfgs, pres=pres, fs=fs, ds_q=ds_q, inputs=inputs, collides=collides)


# ---- the ds engine's other routes (K8 phased, K10, K11) ---------------------
ROUTE_TRIALS = {32: 5, 64: 3}  # after 1 warm-up
RULE_ROUNDS = 6  # paired rounds of the main-block routes' evals (phase 20)
PHASED_ROUNDS = 4  # paired rounds of the phased eager eval, ds chains fused / plain (phase 20)
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
    graphed_kw = {"full": dict(g_stream="full"), "12": dict(gmain_fused="12")}
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
            if name in graphed_kw:  # one eval's launches: an eager eval's (phase 13)
                reset_counts(ks)
                dso.collide_ds(cfg, pre, f, contract="oz", **graphed_kw[name])
                torch.cuda.synchronize()
                route_counts[(name, n)] = counts(ks)
                check(all(c[k] == 2 * route_counts[(name, n)][k] for k in c),
                      f"route {name} {n}^3: first graphed call {c} != 2 x eager")
            l1, l2, linf, dc = ds_digits(bt, cfg, q, q_c2c[n])
            qd = ds.to_f64(ds_q[n])
            dh = np.abs(ds.to_f64(q) - qd).max() / np.abs(qd).max()
            print(f"  route {name} {n}^3: L1 {l1:.5e} L2 {l2:.5e} Linf {linf:.5e}; vs f64 c2c"
                  f" {dc:.3e}, vs the default half route {dh:.3e} max|Q| (tol 1e-12); counts {c}"
                  + (f" (warm-up and capture), of one eval {route_counts[(name, n)]}"
                     if name in graphed_kw else ""))
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
            # the same eval with every ds chain plain (eager)
            q_plain = plain(lambda: dso.collide_ds(cfg, pre, f, contract="oz",
                                                   **graphed_kw.get(name, {})))()
            print(f"  route {name} {n}^3 bitwise equal to its eval with the ds chains plain:"
                  f" {same(q, q_plain)}")
            check(same(q, q_plain) and c["ew"] > 0, f"route {name} {n}^3: fused ds chains != plain")
            del q_plain
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
        # the phased route's eager eval with the ds chains fused and plain
        fn, pre = routes["phased"]
        runs = {"fused": lambda: fn(f, pre), "plain": plain(lambda: fn(f, pre))}
        wall = {k: [] for k in runs}
        for rnd in range(PHASED_ROUNDS):
            for k in (list(runs) if rnd % 2 == 0 else list(runs)[::-1]):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                runs[k]()
                torch.cuda.synchronize()
                wall[k].append((time.perf_counter() - t0) * 1e3)
        d = [a - b for a, b in zip(wall["fused"], wall["plain"])]
        print(f"[20 phased] {n}^3 Ns=12 eager phased eval, wall over {PHASED_ROUNDS} paired rounds:"
              + "; ".join(f" ds chains {k} median {statistics.median(v):.3f} ms (min"
                          f" {min(v):.3f}, max {max(v):.3f})" for k, v in wall.items())
              + f"; fused minus plain round by round: median {statistics.median(d):.3f} (min"
              f" {min(d):.3f}, max {max(d):.3f}) | {card}")
        fam, wall_us = profile_eval(runs["plain"], DS_FAMILIES)
        print_profile(f"ds eval route phased {n}^3, ds chains plain", fam, wall_us, card, 20)
        if n == small:
            st["full"] = routes["full"]
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
        ms, pms = time_ms(fn), time_ms(plain(ref), PLAIN_TRIALS, 1)
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


# ---- the ds eval replayed from one CUDA graph (phase 21) ---------------------
GRAPH_ROUNDS = {32: 10, 64: 6}  # paired eager / graph rounds, the order reversed every other
# the default eval's hashes as recorded before the eval was graphed (PERF.md)
DS_Q_HASHES = {32: "9fef39ee108330d3", 64: "e73b85d16bbf4c00"}


def q_hash(q):
    """sha256 (16 hex digits) of a ds Q's hi and lo bytes."""
    return hashlib.sha256(q.hi.cpu().numpy().tobytes()
                          + q.lo.cpu().numpy().tobytes()).hexdigest()[:16]


def ds_graph_phase(bt, dev, card, ks, st):
    """Phase 21: ``make_ds_collision_operator(jit=True)`` replays the eval
    from one CUDA graph; held bitwise against the eager eval (``collide_ds``,
    the same arguments) on the default route at 32^3 and 64^3 (and against
    the recorded hashes there) and on the full streams at 32^3.  A fresh capture
    through the user's operator (a new precomp object over the same tables):
    its seconds, the launches it counted (an eager warm-up and the capture)
    against an eager eval's, the memory its graph pool holds against the
    eager eval's peak; a replay moves no counter and a second f leaves the
    first Q intact; the same graph captured with the ds chains plain, bitwise;
    the graph's kernel nodes (its debug dump) and the host's time in one
    ``replay()``; paired wall times (host clock to a synchronise), and one
    profiled replay and eager eval (device time, idle share, launches)."""
    from boltzfft_torch import ds, obs
    from boltzfft_torch import ds_operator as dso

    cfgs, fs, pres = st["cfgs"], st["fs"], st["pres"]
    small, big = DS_GRIDS
    obs.enable()  # the graphs keep their nodes for the count
    cases = ((small, "default", st["collides"][small], {}),
             (big, "default", st["collides"][big], {}),
             (small, "full", st["full"][0], {"g_stream": "full"}))
    for n, route, graphed, kw in cases:
        cfg, f, pre = cfgs[n], fs[n], pres[n]
        eager = lambda: dso.collide_ds(cfg, pre, f, contract="oz", **kw)
        eager()
        torch.cuda.synchronize()
        reset_counts(ks)
        copies = [k.COPIES for k in (ks.k7, ks.k8, ks.k12)]
        torch.cuda.reset_peak_memory_stats()
        a0 = torch.cuda.memory_allocated()
        q_eager = eager()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - a0
        c_eager = counts(ks)
        copies = [k.COPIES - c for k, c in zip((ks.k7, ks.k8, ks.k12), copies)]
        pre_g = pre._replace()  # a new precomp object: the operator captures again
        torch.cuda.empty_cache()
        r0 = torch.cuda.memory_reserved()
        reset_counts(ks)
        t0 = time.perf_counter()
        q_graph = graphed(f, pre_g)
        torch.cuda.synchronize()
        cap_s = time.perf_counter() - t0
        c_cap = counts(ks)
        torch.cuda.empty_cache()
        pool = torch.cuda.memory_reserved() - r0
        reset_counts(ks)
        q_replay = graphed(f, pre_g)
        torch.cuda.synchronize()
        c_replay = counts(ks)
        h_e, h_g, h_r = q_hash(q_eager), q_hash(q_graph), q_hash(q_replay)
        want = DS_Q_HASHES[n] if route == "default" else h_e
        print(f"[21 ds graph] {n}^3 Ns=12 {route} route: make_ds_collision_operator(jit=True)"
              f" capture (warm-up + capture) {cap_s:.3f} s; sha256 of Q's hi, lo bytes: eager"
              f" {h_e}, capture {h_g}, replay {h_r}"
              + (f", recorded {want}" if route == "default" else "") + f" | {card}")
        print(f"  launches of an eager eval {c_eager}; of the first graphed call (warm-up and"
              f" capture) {c_cap}; of a replay {c_replay}; operands the K7, K8, K12 wrappers"
              f" copied in the eager eval {copies}")
        check(copies[0] == copies[2] == 0, f"ds graph {n}^3 {route}: K7/K12 copies {copies}")
        check(h_e == h_g == h_r == want and same(q_graph, q_eager) and same(q_replay, q_eager),
              f"ds graph {n}^3 {route}: Q differs from eager or from the recorded hash")
        check(all(v == 0 for v in c_replay.values()) and plain_calls(c_cap) == 0
              and all(c_cap[k] == 2 * c_eager[k] for k in c_eager), f"ds graph {n}^3 {route}: counts")
        keep = ds.DS(q_replay.hi.clone(), q_replay.lo.clone())
        f2 = ds.from_f64(bt.bkw_f(cfg.velocity_grid.r_squared(), 7.0), torch.float32, dev)
        q2 = graphed(f2, pre_g)
        q2_eager = dso.collide_ds(cfg, pre, f2, contract="oz", **kw)
        torch.cuda.synchronize()
        ok2 = same(q_replay, keep) and same(q2, q2_eager) and q2.hi.data_ptr() != q_replay.hi.data_ptr()
        print(f"  a second f (BKW t = 7.0): equal to eager {same(q2, q2_eager)}; the first Q kept"
              f" {same(q_replay, keep)}")
        check(ok2, f"ds graph {n}^3 {route}: a second replay overwrote or differs")
        del keep, q2, q2_eager
        print(f"  memory: the graph's pool {pool / 2**20:.1f} MiB reserved (memory_reserved"
              f" across the first graphed call, caches emptied); the eager eval's peak"
              f" {peak / 2**20:.1f} MiB allocated | {card}")
        # the same eval captured with every ds chain plain: the same bits
        before = dso.ds_collide_fn(cfg, True, device=dev, **kw)
        q_before = plain(lambda: before(f, pre_g))()
        torch.cuda.synchronize()
        print(f"  the graph captured with the ds chains plain: bitwise equal to eager"
              f" {same(q_before, q_eager)}")
        check(same(q_before, q_eager), f"ds graph {n}^3 {route}: plain chains' graph != eager")
        del before, q_before
        g = replayed_graph(graphed, pre_g)
        with tempfile.TemporaryDirectory() as tmp:
            nd = graph_nodes(g, Path(tmp, "eval.dot"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g.replay()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        kern = sum(v for k, v in nd.items() if k.startswith("kernel: "))
        print(f"[21 ds graph] {n}^3 {route}: {kern} kernel nodes (debug dump) by family"
              f" {{{', '.join(f'{k[8:]}: {v}' for k, v in nd.items() if k.startswith('kernel: '))}}},"
              f" all nodes by type {{{', '.join(f'{k}: {v}' for k, v in nd.items() if ':' not in k)}}};"
              f" the host's time in one replay() {host_ms:.3f} ms | {card}")
        runs = {"eager": eager, "graph": lambda: graphed(f, pre_g)}
        wall = {k: [] for k in runs}
        for rnd in range(GRAPH_ROUNDS[n]):
            for k in (list(runs) if rnd % 2 == 0 else list(runs)[::-1]):
                t0 = time.perf_counter()
                runs[k]()
                torch.cuda.synchronize()
                wall[k].append((time.perf_counter() - t0) * 1e3)
        d = [a - b for a, b in zip(wall["eager"], wall["graph"])]
        print(f"[21 ds graph] {n}^3 {route}: wall per eval over {GRAPH_ROUNDS[n]} paired rounds,"
              f" eager median {statistics.median(wall['eager']):.3f} ms (min"
              f" {min(wall['eager']):.3f}, max {max(wall['eager']):.3f}), graph median"
              f" {statistics.median(wall['graph']):.3f} ms (min {min(wall['graph']):.3f}, max"
              f" {max(wall['graph']):.3f}); eager minus graph round by round: median"
              f" {statistics.median(d):.3f} (min {min(d):.3f}, max {max(d):.3f}) | {card}")
        for label, fn, k in (("one replay", runs["graph"], "graph"), ("one eager eval", eager, "eager")):
            fam, wall_us = profile_eval(fn, DS_FAMILIES)
            print_profile(f"ds {route} {n}^3, {label}", fam, wall_us, card, 21)
            busy = sum(v[0] for v in fam.values()) / 1e3
            med = statistics.median(wall[k])
            print(f"  the profiler's device time against the unprofiled median wall: {busy:.3f} of"
                  f" {med:.3f} ms, idle share {100 * (1 - busy / med):.1f}% | {card}")
        del q_eager, q_graph, q_replay, runs, pre_g
        torch.cuda.empty_cache()
    obs.disable()


# ---- the ds engine's elementwise chains as fused kernels (phase 26) -------------
# float operations per output element of each chain (a ds add 11, a ds
# multiply 24: Dekker's two_prod 17, 4 for the cross terms, 3 to renormalise)
EW_FLOPS = {"add": 11, "sub": 11, "mul": 24, "mul_f": 22, "cadd": 22, "cmul": 118,
            "cmul_ds": 48, "cmul_both": 140, "axpy": 35, "caxpy": 70, "sub_mul": 35,
            "cadd_signed": 26, "add_signed": 13}


def graph_us(fn, launches=20, trials=5) -> float:
    """Microseconds per launch of ``fn`` replayed from one CUDA graph of
    ``launches`` calls, CUDA events around a replay (median of ``trials``):
    the kernel and the gap between two graph nodes, with no host work in
    between.  The profiler can miss kernels this short (``device_ms``)."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    out = []
    for _ in range(trials):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) * 1e3 / launches)
    del graph
    return statistics.median(out)


def own_elements(t) -> int:
    """Elements a tensor holds: its broadcast (stride 0) dims counted once."""
    return int(np.prod([n for n, st in zip(t.shape, t.stride()) if st != 0] or [1]))


def ds_elementwise_phase(bt, dev, card, ks, st, entry, ds_step):
    """Phase 26: each ds elementwise kernel (``csrc/ds_elementwise.cu``)
    against its plain chain, bitwise, on the operands of its largest call in
    one eager default eval at 32^3 and 64^3 (RK's axpy in one RK4 step),
    read in place, and in float64 pairs at the same shapes (chains the eval
    does not run: on operands made from the eval's cmul operands); each
    kernel's time, its plain chain's, its device time per launch
    (profiler, and replayed from a graph of 20 launches) and its bound;
    launches per eval and per RK4 step, and per RK4 step graph as phase 25
    counted them (``ds_step``)."""
    from boltzfft_torch import ds
    from boltzfft_torch import ds_operator as dso

    ew = ks.ew
    cfgs, fs, pres, collides = st["cfgs"], st["fs"], st["pres"], st["collides"]
    max_err = {}
    real = {op: getattr(ew, op) for op in ew.OPS}
    leaves = lambda tree: [x for x in _leaves(tree) if isinstance(x, torch.Tensor)]
    for n in DS_GRIDS:
        calls = {}  # chain -> (output elements, args) of its largest call

        def recorder(op):
            def run(*args):
                out = real[op](*args)
                size = leaves(out)[0].numel()
                if size > calls.get(op, (-1,))[0]:
                    calls[op] = (size, args)
                return out
            return run

        for op in ew.OPS:
            setattr(ew, op, recorder(op))
        try:
            reset_counts(ks)
            dso.collide_ds(cfgs[n], pres[n], fs[n], contract="oz")
            torch.cuda.synchronize()
            c_eval = counts(ks)
            reset_counts(ks)
            bt.rk4_step(lambda x: collides[n](x, pres[n]), fs[n], 0.25)  # the evals replay
            torch.cuda.synchronize()
            c_step = counts(ks)
        finally:
            for op in ew.OPS:
                setattr(ew, op, real[op])
        per_eval = {op: c_eval[f"ew_{op}"] for op in ew.OPS if c_eval[f"ew_{op}"]}
        print(f"[26 ds chains] {n}^3 Ns=12, the card's default eval: fused ds chain launches per"
              f" eval {per_eval} ({c_eval['ew']} in all, {c_eval['ew_plain']} plain); per RK4 step"
              f" 4 x those + axpy {c_step['ew_axpy']} | {card}")
        check(c_eval["ew_plain"] == 0 and c_step["ew_axpy"] == 7, f"ds chains {n}^3: counts")
        x, y = calls["cmul"][1]
        pat = calls["cadd_signed"][1][2]
        made = {"add": (x.re, y.re), "sub": (x.re, y.im), "mul": (x.re, y.im),
                "mul_f": (x.re, y.re.hi), "cadd": (x, y), "cmul_both": (x, y),
                "cmul_ds": (x, y.re), "axpy": (x.re, y.re, x.im), "caxpy": (x, y, x.re),
                "sub_mul": (x.im, y.re, x.re), "add_signed": (x.re, y.re, pat)}
        gen = torch.Generator(device=dev).manual_seed(n)

        def as_f64(args, signed):
            """The operands as float64 pairs, perturbed; a sign pattern kept."""
            def one(a):
                a = a.double()
                return a + a.abs() * 1e-9 * torch.randn(a.shape, generator=gen, device=dev,
                                                         dtype=torch.float64)
            return ds.tree_map(one, args[:-1]) + args[-1:] if signed else ds.tree_map(one, args)

        for op in ew.OPS:
            on_path = op in calls
            args = calls[op][1] if on_path else made[op]
            shape = tuple(leaves(getattr(ew, op)(*args))[0].shape)
            kernel = lambda a=args, o=op: getattr(ew, o)(*a)
            label = f"{op} {n}^3 {'eval' if on_path else 'made'} operands {shape}"
            parity_check(max_err, f"ds chain {label}, float32 pairs", (op, n), kernel, kernel)
            a64 = as_f64(args, op.endswith("_signed"))
            k64 = lambda a=a64, o=op: getattr(ew, o)(*a)
            parity_check(max_err, f"ds chain {label}, float64 pairs", (op, n, "f64"), k64, k64)
            if not on_path:
                continue
            ins = leaves(args)
            out_n = int(np.prod(shape))
            nbytes = sum(own_elements(t) * t.element_size() for t in ins) \
                + ew.OPS[op][2] * out_n * 4
            b = bound(EW_FLOPS[op] * out_n, nbytes, "float32")
            ms, pms = time_ms(kernel), time_ms(plain(kernel), PLAIN_TRIALS, 1)
            dms = device_ms(kernel, "ds_elementwise_kernel")
            gus = graph_us(kernel)
            launches = c_step["ew_axpy"] if op == "axpy" else c_eval[f"ew_{op}"]
            dev_txt = ("not measured" if dms is None else
                       f"{1e3 * dms:.2f} us = {dms / b[0]:.1f}x the bound")
            dev_txt += (f"; replayed from a graph of 20 launches {gus:.2f} us a launch"
                        f" = {gus / (1e3 * b[0]):.1f}x the bound")
            print(f"[26 time] ds_{op}[{n}^3,{shape}]: kernel median {statistics.median(ms):.4f} ms"
                  f" (events, the wrapper's host time included), plain chain median"
                  f" {statistics.median(pms):.4f} ms; device time per launch (profiler) {dev_txt};"
                  f" bound {1e3 * b[0]:.2f} us ({b[1]}: {nbytes / 1e6:.3f} MB,"
                  f" {EW_FLOPS[op] * out_n / 1e6:.2f} MFLOP); launches per"
                  f" {'RK4 step' if op == 'axpy' else 'eval'} {launches}, per RK4 step graph"
                  f" {ds_step[n][f'ew_{op}']} | {card}")
            entry(f"ds_{op}[{n}^3,{'x'.join(map(str, shape))}]", f"ds_{op}", "float32", launches,
                  0, max(max_err[(op, n)], max_err[(op, n, "f64")]), ms, pms, b[0], b[1], None,
                  dms, graph_us=gus, per_step_graph=ds_step[n][f"ew_{op}"])
        del calls, made, x, y, pat


# ---- every route of make_collision_operator replayed from one CUDA graph (phase 22) ----
# (label, CollisionConfig kwargs, grid, cells: None for one BKW f, else a
# stack; "tg" the TG-2D batch of 16 x 16 cells)
OPERATOR_GRAPH_CASES = [
    ("rfft + use_pallas", dict(impl="rfft", use_pallas=True, dtype="float64"), 32, None),
    ("rfft + use_pallas", dict(impl="rfft", use_pallas=True, dtype="float32"), 32, None),
    ("rfft + use_pallas", dict(impl="rfft", use_pallas=True, dtype="float64"), 64, None),
    ("rfft + use_pallas", dict(impl="rfft", use_pallas=True, dtype="float32"), 64, None),
    ("fused (K1)", dict(impl="fused", fused_scheme="ct"), 32, None),
    ("fused (K1)", dict(impl="fused", fused_scheme="ct"), 64, None),
    ("fused (K1), TG-2D batch", dict(impl="fused", fused_scheme="ct"), 16, "tg"),
    ("fused kron (K3)", dict(impl="fused", fused_scheme="kron"), 8, 256),
    ("c2c", dict(impl="c2c"), 32, None),
]
OPERATOR_FAMILIES = ("alpha_multiply_kernel", "gain_reduce_kernel", "dft_kernel",
                     "kron_gemm_kernel", "fft")


def operator_graph_phase(bt, dev, card, ks):
    """Phase 22: ``make_collision_operator(cfg)`` (``jit=True``) replays each
    route's eval from one CUDA graph; each held bitwise to the eager eval
    (``collide`` on the same precomp) on the capture, a replay and a second
    f, which leaves the first Q intact; the BKW digits through the replayed
    rfft + use_pallas route in float64; the capture's seconds and launches
    (twice an eager eval's: the warm-up and the capture; a replay none);
    the graph pool against the eager peak; paired wall times (host clock to
    a synchronise, alternated, medians of ``GRAPH_ROUNDS``), and one
    profiled replay and eager eval (device time, idle share, kernels).
    Each operator is dropped before the next case.  Returns each case's
    replay device ms (the profiler's), by case name."""
    from boltzfft_torch.cli.taylor_green_2d3v import taylor_green_f0

    replay_device = {}  # case name -> one replay's device ms (the profiler's)
    for label, kw, n, cells in OPERATOR_GRAPH_CASES:
        cfg = bt.CollisionConfig(nv=n, ns=12, **kw)
        graphed, pre = bt.make_collision_operator(cfg)
        _, rsq, f = bkw(bt, cfg, dev)
        if cells == "tg":
            f = taylor_green_f0(cfg, 16, device=dev, u0=0.8, temperature=3.0)
            f = f.reshape(-1, n, n, n)
        elif cells:
            f = torch.stack([f * (1.0 - 0.5 * i / cells) for i in range(cells)])
        name = f"{label} {n}^3 {cfg.dtype}" + ("" if f.dim() == 3 else f" E {f.shape[0]}")
        eager = lambda: bt.collide(cfg, pre, f)
        eager()  # settles the chunks and builds the tables on this precomp
        torch.cuda.synchronize()
        reset_counts(ks)
        torch.cuda.reset_peak_memory_stats()
        a0 = torch.cuda.memory_allocated()
        q_eager = eager()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - a0
        c_eager = counts(ks)
        torch.cuda.empty_cache()
        r0 = torch.cuda.memory_reserved()
        reset_counts(ks)
        t0 = time.perf_counter()
        q_graph = graphed(f, pre)
        torch.cuda.synchronize()
        cap_s = time.perf_counter() - t0
        c_cap = counts(ks)
        torch.cuda.empty_cache()
        pool = torch.cuda.memory_reserved() - r0
        reset_counts(ks)
        q_replay = graphed(f, pre)
        torch.cuda.synchronize()
        c_replay = counts(ks)
        ok = torch.equal(q_graph, q_eager) and torch.equal(q_replay, q_eager)
        print(f"[22 graph] {name}: make_collision_operator(cfg) (jit=True) capture (warm-up +"
              f" capture) {cap_s:.3f} s; capture and replay bitwise equal to eager {ok} | {card}")
        print(f"  launches of an eager eval {c_eager}; of the first graphed call {c_cap}; of a"
              f" replay {c_replay}")
        check(ok, f"graph {name}: Q differs from the eager eval")
        check(all(v == 0 for v in c_replay.values()) and plain_calls(c_cap) == 0
              and all(c_cap[k] == 2 * c_eager[k] for k in c_eager), f"graph {name}: counts")
        keep = q_replay.clone()
        f2 = 1.1 * f
        q2 = graphed(f2, pre)
        q2_eager = bt.collide(cfg, pre, f2)
        torch.cuda.synchronize()
        ok2 = torch.equal(q_replay, keep) and torch.equal(q2, q2_eager)
        print(f"  a second f (1.1 f): equal to eager {torch.equal(q2, q2_eager)}; the first Q"
              f" kept {torch.equal(q_replay, keep)}")
        check(ok2, f"graph {name}: a second replay overwrote or differs")
        del keep, q2, q2_eager, f2
        if label == "rfft + use_pallas" and cfg.dtype == "float64":
            e = bt.error_norms_device(q_replay, bt.bkw_dfdt(rsq, 6.5), cfg.velocity_grid.dv)
            ref, rtol = BKW_DIGITS[n]
            print(f"  BKW through the replay: L1 {e['L1']:.5e} L2 {e['L2']:.5e} Linf"
                  f" {e['Linf']:.5e} (reference {ref[0]:.4e} {ref[1]:.4e} {ref[2]:.4e}, rtol {rtol:g})")
            for got, want, lab in zip((e["L1"], e["L2"], e["Linf"]), ref, ("L1", "L2", "Linf")):
                check(abs(got - want) <= rtol * want, f"graph {name} {lab} {got:.5e} vs {want:.4e}")
        print(f"  memory: the graph's pool {pool / 2**20:.1f} MiB reserved (memory_reserved"
              f" across the first graphed call, caches emptied); the eager eval's peak"
              f" {peak / 2**20:.1f} MiB allocated | {card}")
        runs = {"eager": eager, "graph": lambda: graphed(f, pre)}
        wall = {k: [] for k in runs}
        rounds = GRAPH_ROUNDS.get(n, 10)
        for rnd in range(rounds):
            for k in (("eager", "graph") if rnd % 2 == 0 else ("graph", "eager")):
                t0 = time.perf_counter()
                runs[k]()
                torch.cuda.synchronize()
                wall[k].append((time.perf_counter() - t0) * 1e3)
        d = [a - b for a, b in zip(wall["eager"], wall["graph"])]
        print(f"[22 graph] {name}: wall per eval over {rounds} paired rounds, eager median"
              f" {statistics.median(wall['eager']):.4f} ms (min {min(wall['eager']):.4f}, max"
              f" {max(wall['eager']):.4f}), graph median {statistics.median(wall['graph']):.4f} ms"
              f" (min {min(wall['graph']):.4f}, max {max(wall['graph']):.4f}); eager minus graph"
              f" round by round: median {statistics.median(d):.4f} (min {min(d):.4f}, max"
              f" {max(d):.4f}) | {card}")
        for what, fn, k in (("one replay", runs["graph"], "graph"), ("one eager eval", eager, "eager")):
            fam, wall_us = profile_eval(fn, OPERATOR_FAMILIES)
            print_profile(f"{name}, {what}", fam, wall_us, card, 22)
            busy = sum(v[0] for v in fam.values()) / 1e3
            if k == "graph":
                replay_device[name] = busy
            med = statistics.median(wall[k])
            print(f"  the profiler's device time against the unprofiled median wall: {busy:.4f} of"
                  f" {med:.4f} ms, idle share {100 * (1 - busy / med):.1f}% | {card}")
        del q_eager, q_graph, q_replay, runs, graphed, pre, f, eager
        torch.cuda.empty_cache()
    return replay_device


# ---- the multi-device slice on one card (phase 23) -------------------------------
SHARDED_ROUNDS = 5  # paired rounds of the 1-rank mesh's walls against the unsharded operator's
ENSEMBLE_ARGV = ["--ensemble", "256", "--Nv", "32", "--Ns", "12", "--impl", "fused", "--steps",
                 "2", "--dtype", "float64"]  # BASELINE config 5's size, its steps cut to 2
TWO_RANK_TIMEOUT = 600


def paired_walls(runs, rounds=SHARDED_ROUNDS):
    """Host-clock walls of each run (to a synchronise), alternated round by
    round; the medians in ms."""
    wall = {k: [] for k in runs}
    for rnd in range(rounds):
        for k in (list(runs) if rnd % 2 == 0 else list(runs)[::-1]):
            t0 = time.perf_counter()
            runs[k]()
            torch.cuda.synchronize()
            wall[k].append((time.perf_counter() - t0) * 1e3)
    return {k: statistics.median(v) for k, v in wall.items()}


def bkw_gate(bt, cfg, q, rsq, name):
    """The BKW digits of a float64 Q at 32^3 / 64^3, checked; the line."""
    e = bt.error_norms_device(q, bt.bkw_dfdt(rsq, 6.5), cfg.velocity_grid.dv)
    ref, rtol = BKW_DIGITS[cfg.nv]
    for got, want, lab in zip((e["L1"], e["L2"], e["Linf"]), ref, ("L1", "L2", "Linf")):
        check(abs(got - want) <= rtol * want, f"{name} {lab} {got:.5e} vs {want:.4e}")
    return (f"BKW L1 {e['L1']:.5e} L2 {e['L2']:.5e} Linf {e['Linf']:.5e} (reference"
            f" {ref[0]:.4e} {ref[1]:.4e} {ref[2]:.4e}, rtol {rtol:g})")


def ds_gate(bt, cfg, q, q_c2c, name):
    """The ds digits at 32^3 and the 1e-12 agreement with the f64 c2c Q."""
    l1, l2, linf, dc = ds_digits(bt, cfg, q, q_c2c)
    ref, rtol = DS_DIGITS_32
    for got, want, lab in zip((l1, l2, linf), ref, ("L1", "L2", "Linf")):
        check(abs(got - want) <= rtol * want, f"{name} {lab} {got:.5e} vs {want:.4e}")
    check(dc <= 1e-12, f"{name} vs f64 c2c {dc:.3e}")
    return (f"ds digits L1 {l1:.5e} L2 {l2:.5e} Linf {linf:.5e} (reference {ref[0]:.4e}"
            f" {ref[1]:.4e} {ref[2]:.4e}, rtol {rtol:g}); vs f64 c2c {dc:.3e} max|Q|")


def two_rank_main(rank: int, store: str, out: str) -> int:
    """One of phase 23 (c)'s two ranks, sharing card 0 over gloo (NCCL takes
    one rank a card): the node-sharded fused route (K2 on each rank, then
    the all_reduce) at 32^3 and 64^3 f64 and the 2-shard ds operator at
    32^3 (the all_gather and the ds fold), eager (gloo cannot be captured).
    Rank 0 holds them to the unsharded evals; the result goes to a JSON
    file."""
    import torch.distributed as dist

    import boltzfft_torch as bt
    from boltzfft_torch import ds

    ks = kernel_modules()
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=2)
    mesh = bt.make_mesh([(bt.NODE_AXIS, 2)], device="cuda")
    res = {"rank": rank, "backend": dist.get_backend(), "fused": {}}
    try:
        bt.make_sharded_collision_operator(bt.CollisionConfig(nv=32, ns=12, impl="fused"), mesh)
        res["jit"] = "no error"
    except ValueError as err:
        res["jit"] = str(err)
    for n in (32, 64):
        cfg = bt.CollisionConfig(nv=n, ns=12, impl="fused")
        g, rsq, f = bkw(bt, cfg, dev)
        sharded, pre = bt.make_sharded_collision_operator(cfg, mesh, jit=False)
        pre = bt.place(pre, mesh)
        sharded(f, pre)
        torch.cuda.synchronize()
        reset_counts(ks)
        q = sharded(f, pre)
        torch.cuda.synchronize()
        row = {"counts": counts(ks), "nodes": pre.rho.shape[0],
               "hash": hashlib.sha256(q.cpu().numpy().tobytes()).hexdigest()[:16]}
        dist.barrier()
        row["ms"] = paired_walls({"sharded": lambda: sharded(f, pre)})["sharded"]
        if rank == 0:
            ref, ref_pre = bt.make_collision_operator(cfg, jit=False, device=dev)
            q_ref = ref(f, ref_pre)
            row["err"] = float((q - q_ref).abs().max() / q_ref.abs().max())
            row["bkw"] = bkw_gate(bt, cfg, q, rsq, f"2 ranks fused {n}^3")
            row["unsharded_ms"] = paired_walls({"k1": lambda: ref(f, ref_pre)})["k1"]
        res["fused"][n] = row
    cfg = bt.CollisionConfig(nv=32, ns=12, impl="c2c", dtype="float32")
    sharded, pre = bt.make_sharded_ds_collision_operator(cfg, mesh, jit=False)
    pre = bt.place_ds(pre, mesh)
    f = ds.from_f64(bt.bkw_f(cfg.velocity_grid.r_squared(), 6.5), torch.float32, dev)
    sharded(f, pre)
    torch.cuda.synchronize()
    reset_counts(ks)
    q = sharded(f, pre)
    torch.cuda.synchronize()
    row = {"counts": counts(ks), "groups": pre.gain_w.hi.shape[0], "hash": q_hash(q)}
    q_plain = plain(lambda: sharded(f, pre))()  # every ds chain plain, the fold's too
    row["plain_equal"] = same(q, q_plain)
    dist.barrier()
    row["ms"] = paired_walls({"sharded": lambda: sharded(f, pre)})["sharded"]
    if rank == 0:
        ref, ref_pre = bt.make_ds_collision_operator(cfg, jit=False, device=dev)
        q_ref = ref(f, ref_pre)
        a, b = ds.to_f64(q), ds.to_f64(q_ref)
        row["err"] = float(np.abs(a - b).max() / np.abs(b).max())
        row["digits"] = ds_gate(bt, cfg, q, c2c_q(bt, dev), "2 ranks ds 32^3")
        row["unsharded_ms"] = paired_walls({"ds": lambda: ref(f, ref_pre)})["ds"]
    res["ds"] = row
    Path(out, f"rank{rank}.json").write_text(json.dumps(res))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def c2c_q(bt, dev):
    """The float64 staged c2c Q of the 32^3 BKW state (the ds gates' oracle)."""
    cfg = bt.CollisionConfig(nv=32, ns=12, impl="c2c")
    c2c, pre = bt.make_collision_operator(cfg, jit=False, device=dev)
    return c2c(bkw(bt, cfg, dev)[2], pre)


def kernel_modules():
    """The kernel wrappers, by their counters' names."""
    from types import SimpleNamespace

    from boltzfft_torch.kernels import alpha_multiply as k6
    from boltzfft_torch.kernels import ds_elementwise as ew
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

    return SimpleNamespace(k1=k1, k3=k3, k24=k24, k5=k5, k6=k6, k7=k7, k8=k8, k9=k9, k10=k10,
                           k11=k11, k12=k12, ew=ew)


def sharded_phase(bt, dev, card, ks):
    """Phase 23, the multi-device slice on one card: (a) a 1-rank NCCL mesh
    at full width, each sharded operator bitwise equal to its unsharded
    one, with the BKW (and ds) digits; (b) the ensemble driver at BASELINE
    config 5's size; (c) two gloo ranks sharing the card, spawned here."""
    import torch.distributed as dist

    from boltzfft_torch import ds
    from boltzfft_torch.cli import ensemble_bkw

    # ---- (a) a 1-rank NCCL mesh: the sharded operators are the unsharded ones
    mesh = bt.make_mesh(device=dev)  # no process group yet: one of this process alone
    print(f"[23 mesh] make_mesh(): {dict(zip(mesh.mesh_dim_names, mesh.shape))}, backend"
          f" {dist.get_backend()}, world {dist.get_world_size()} | {card}")
    check(dist.get_backend() == "nccl" and dist.get_world_size() == 1, "a 1-rank NCCL group")
    routes = (("fused (K1)", dict(impl="fused"), ("k1",)),
              ("rfft + use_pallas", dict(impl="rfft", use_pallas=True), ("k6", "k5")))
    for label, kw, needed in routes:
        for n in (32, 64):
            for dtype in ("float64", "float32"):
                cfg = bt.CollisionConfig(nv=n, ns=12, dtype=dtype, **kw)
                g, rsq, f = bkw(bt, cfg, dev)
                ref, ref_pre = bt.make_collision_operator(cfg)
                sharded, pre = bt.make_sharded_collision_operator(cfg, mesh)
                pre = bt.place(pre, mesh)
                q_ref = ref(f, ref_pre)
                torch.cuda.synchronize()
                reset_counts(ks)
                q = sharded(f, pre)
                torch.cuda.synchronize()
                c = counts(ks)
                name = f"{label} {n}^3 {dtype}"
                ok = torch.equal(q, q_ref) and torch.equal(sharded(f, pre), q_ref)
                check(ok, f"1-rank mesh {name}: not bitwise equal to make_collision_operator")
                check(all(c[k] > 0 for k in needed) and plain_calls(c) == 0,
                      f"1-rank mesh {name}: launches {c}")
                ms = paired_walls({"sharded": lambda: sharded(f, pre), "unsharded": lambda: ref(f, ref_pre)})
                digits = bkw_gate(bt, cfg, q, rsq, f"1-rank mesh {name}") if dtype == "float64" else ""
                print(f"[23 mesh] {name}: make_sharded_collision_operator (jit=True, 1 node rank)"
                      f" bitwise equal to make_collision_operator {ok}; launches of the first"
                      f" call (warm-up + capture) {{{', '.join(f'{k}: {c[k]}' for k in needed)}}};"
                      f" wall medians of {SHARDED_ROUNDS} paired rounds: sharded"
                      f" {ms['sharded']:.4f} ms, unsharded {ms['unsharded']:.4f} ms | {card}")
                if digits:
                    print(f"  {digits}")
                del ref, ref_pre, sharded, pre, q, q_ref
                torch.cuda.empty_cache()
    cfg = bt.CollisionConfig(nv=32, ns=12, impl="c2c", dtype="float32")
    ref, ref_pre = bt.make_ds_collision_operator(cfg, device=dev)
    sharded, pre = bt.make_sharded_ds_collision_operator(cfg, mesh)
    pre = bt.place_ds(pre, mesh)
    f = ds.from_f64(bt.bkw_f(cfg.velocity_grid.r_squared(), 6.5), torch.float32, dev)
    q_ref = ref(f, ref_pre)
    torch.cuda.synchronize()
    reset_counts(ks)
    q = sharded(f, pre)
    torch.cuda.synchronize()
    c = counts(ks)
    ok = same(q, q_ref)
    check(ok, "1-rank mesh ds 32^3: not bitwise equal to make_ds_collision_operator")
    check(all(c[k] > 0 for k in ("k7", "k8", "k9", "k12")) and plain_calls(c) == 0,
          f"1-rank mesh ds 32^3: launches {c}")
    digits = ds_gate(bt, cfg, q, c2c_q(bt, dev), "1-rank mesh ds 32^3")
    ms = paired_walls({"sharded": lambda: sharded(f, pre), "unsharded": lambda: ref(f, ref_pre)})
    print(f"[23 mesh] ds 32^3 (card defaults): make_sharded_ds_collision_operator (jit=True,"
          f" 1 radial rank) bitwise equal to make_ds_collision_operator {ok}; launches of the"
          f" first call {{{', '.join(f'{k}: {c[k]}' for k in ('k7', 'k8', 'k9', 'k12'))}}};"
          f" wall medians of {SHARDED_ROUNDS} paired rounds: sharded {ms['sharded']:.4f} ms,"
          f" unsharded {ms['unsharded']:.4f} ms | {card}")
    print(f"  {digits}")
    del ref, ref_pre, sharded, pre, q, q_ref
    torch.cuda.empty_cache()

    # ---- (b) the ensemble driver at BASELINE config 5's size
    reset_counts(ks)
    rc, lines = run_driver(ensemble_bkw.main, ENSEMBLE_ARGV)
    c = counts(ks)
    out = "\n".join(lines)
    timed = ("first call", "collision evals")
    print("\n".join(f"  {ln}" + (f" | {card}" if ln.startswith(timed) else "") for ln in lines))
    check(rc == 0, "ensemble_bkw: the H gate failed")
    check(c["k1"] > 0 and plain_calls(c) == 0, f"ensemble_bkw: launches {c}")
    lo, hi = (float(v) for v in out.split("final mass range: [")[1].split("]")[0].split(","))
    m0 = float(np.sum(bt.bkw_f(bt.CollisionConfig(nv=32, ns=12).velocity_grid.r_squared(), 5.5))
               * bt.CollisionConfig(nv=32, ns=12).velocity_grid.dv ** 3)
    drift = max(abs(lo - m0), abs(hi - m0)) / m0
    check(np.isfinite(lo) and np.isfinite(hi) and drift <= MASS_TOL, f"ensemble_bkw mass {lo} {hi}")
    rate = out.split("evals/s aggregate")[0].split("->")[-1].strip()
    print(f"[23 ensemble] ensemble_bkw {' '.join(ENSEMBLE_ARGV)}: rc {rc} (H gate), final mass"
          f" range [{lo:.6f}, {hi:.6f}] against the BKW mass {m0:.6f} (rel {drift:.2e}, tol"
          f" {MASS_TOL:g}); {rate} collision evals/s (the steady run: 256 x 2 steps x 4 evals,"
          f" K1 on 256-member batches replayed from a CUDA graph); launches {{k1: {c['k1']}}} |"
          f" {card}")
    # where the ensemble eval's time goes: one replay of the driver's operator
    cfg = bt.CollisionConfig(nv=32, ns=12, impl="fused")
    coll, pre = bt.make_sharded_collision_operator(
        cfg, bt.make_mesh([(bt.ENSEMBLE_AXIS, 1)], device=dev), node_axis=None,
        ensemble_axis=bt.ENSEMBLE_AXIS)
    rsq = cfg.velocity_grid.r_squared()
    fe = torch.as_tensor(np.stack([bt.bkw_f(rsq, t) for t in 5.5 + 2.0 * np.arange(256) / 256]),
                         dtype=cfg.real_dtype, device=dev)
    coll(fe, pre)
    torch.cuda.synchronize()
    fam, wall_us = profile_eval(lambda: coll(fe, pre), OPERATOR_FAMILIES)
    print_profile("the ensemble eval, E = 256 x 32^3 f64, one replay", fam, wall_us, card, 23)
    del coll, pre, fe
    torch.cuda.empty_cache()

    # ---- (c) two gloo ranks sharing the card
    import subprocess
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, __file__, "--two-rank", str(r),
                                   str(Path(tmp, "store")), tmp],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(2)]
        logs = []
        try:
            for proc in procs:
                logs.append(proc.communicate(timeout=TWO_RANK_TIMEOUT)[0])
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        wall = time.perf_counter() - t0
        for r, (proc, log) in enumerate(zip(procs, logs)):
            if proc.returncode:
                print(f"--- rank {r} of 2 (rc {proc.returncode}):\n{log[-6000:]}")
        check(all(p.returncode == 0 for p in procs), "two gloo ranks on one card failed")
        res = [json.loads(Path(tmp, f"rank{r}.json").read_text()) for r in range(2)]
    r0, r1 = res
    print(f"[23 two ranks] 2 processes on card 0 over {r0['backend']} in {wall:.1f} s (start-up"
          f" included); jit=True with the gloo all_reduce: {r0['jit']!r} | {card}")
    check("pass jit=False" in r0["jit"], "jit=True over gloo on CUDA did not raise")
    for n in (32, 64):
        a, b = r0["fused"][str(n)], r1["fused"][str(n)]
        check(a["hash"] == b["hash"], f"two ranks fused {n}^3: the ranks' Q differ")
        check(a["err"] <= 1e-12, f"two ranks fused {n}^3: {a['err']:.3e} max|Q| from K1")
        check(all(x["counts"]["k2"] == 1 and plain_calls(x["counts"]) == 0 for x in (a, b)),
              f"two ranks fused {n}^3: launches {a['counts']} {b['counts']}")
        print(f"[23 two ranks] fused {n}^3 float64, node-sharded ({a['nodes']} nodes a rank):"
              f" K2 launches per rank per eval {a['counts']['k2']}, {b['counts']['k2']}; vs the"
              f" unsharded K1 eval {a['err']:.3e} max|Q| (tol 1e-12); eager walls (2 ranks"
              f" sharing one card, gloo through the host: no scaling measured) rank 0"
              f" {a['ms']:.3f} ms, rank 1 {b['ms']:.3f} ms, unsharded K1 {a['unsharded_ms']:.3f}"
              f" ms | {card}")
        print(f"  {a['bkw']}")
    a, b = r0["ds"], r1["ds"]
    needed = ("k7", "k8", "k9", "k12", "ew", "ew_cadd")
    check(a["hash"] == b["hash"], "two ranks ds: the ranks' Q differ")
    check(a["err"] <= 1e-12, f"two ranks ds: {a['err']:.3e} max|Q| from the unsharded eval")
    check(a["plain_equal"] and b["plain_equal"], "two ranks ds: fused ds chains != plain chains")
    check(all(all(x["counts"][k] > 0 for k in needed) and plain_calls(x["counts"]) == 0
              for x in (a, b)), f"two ranks ds: launches {a['counts']} {b['counts']}")
    print(f"[23 two ranks] ds 32^3 (card defaults), 2 radial shards ({a['groups']} groups):"
          f" launches per rank {{{', '.join(f'{k}: {a['counts'][k]}' for k in needed)}}};"
          f" vs the unsharded ds eval {a['err']:.3e} max|Q| (tol 1e-12); eager walls rank 0"
          f" {a['ms']:.3f} ms, rank 1 {b['ms']:.3f} ms, unsharded {a['unsharded_ms']:.3f} ms;"
          f" each rank's Q bitwise equal to its eval with the ds chains plain (the cross-rank"
          f" fold's ds.cadd too) {a['plain_equal']}, {b['plain_equal']} | {card}")
    print(f"  {a['digits']}")
    dist.destroy_process_group()


# ---- the tooling and examples slice (phase 24) ---------------------------------
K1_SYMBOLS = ("plane_dft_kernel", "line_dft_kernel")  # K1's transforms (fused_collide.cu)
F32_LINF_32 = 4.5e-5  # the float32 gate at 32^3 (PERF.md section 2)
F32_VS_F64_64 = 2e-5  # float32 at 64^3 within this of float64, in units of max|Q|
CONVERGENCE_LINF_64 = (3.0685e-12, 1e-3)  # the reference's 64^3 Linf and its rtol
TRACE_MS_RTOL = 0.10  # a traced replay's summed kernel ms against the profiler's on another


def k1_launches(counts) -> int:
    """K1's transform launches in a ``{kernel name: count}``."""
    return sum(v for k, v in counts.items() if any(s in k for s in K1_SYMBOLS))
MEM_SLACK = 64 << 20  # allocated bytes a tuner may leave behind
TOOLING_KERNELS = ("k1", "k5", "k6", "k7", "k8", "k9", "k10", "k12")


def ds_check(bt, cfg, q, q_c2c, name):
    """The ds digits of a ds Q at 32^3 / 64^3, checked; the line."""
    l1, l2, linf, dc = ds_digits(bt, cfg, q, q_c2c)
    check(dc <= 1e-12, f"{name}: vs f64 c2c {dc:.3e}")
    if cfg.nv == 32:
        ref, rtol = DS_DIGITS_32
        for got, want, lab in zip((l1, l2, linf), ref, ("L1", "L2", "Linf")):
            check(abs(got - want) <= rtol * want, f"{name} {lab} {got:.5e} vs {want:.4e}")
        gate = f"reference {ref[0]:.4e} {ref[1]:.4e} {ref[2]:.4e}, rtol {rtol:g}"
    else:
        check(DS_LINF_64[0] <= linf <= DS_LINF_64[1], f"{name} Linf {linf:.5e}")
        gate = f"Linf in [{DS_LINF_64[0]:.4e}, {DS_LINF_64[1]:.4e}]"
    return (f"ds digits L1 {l1:.5e} L2 {l2:.5e} Linf {linf:.5e} ({gate}); vs f64 c2c"
            f" {dc:.3e} max|Q| (tol 1e-12)")


def tooling_phase(bt, dev, card, ks, replay_device):
    """Phase 24, the tooling and examples slice: (a) ``save_precomp`` /
    ``load_precomp`` (a loaded precomp's replayed eval bitwise equal to the
    saved one's); (b) ``autotune`` on rfft + use_pallas (32^3, 64^3, f64 and
    f32) and c2c 32^3: each candidate's ms per eval, the winner, its K5/K6
    launches per eval, its digits, the memory given back; (c) ``autotune_ds``
    at 32^3 and 64^3 on the card defaults (the ``sub_batch`` re-measure):
    each candidate's ms, the winner's ds digits; (d) ``trace`` around
    replayed K1 evals, held to the profiler's kernel count and time; (e) the seven examples' ``main`` at their defaults,
    each with its gate and wall.  The counts are set to 0 at the phase's
    start and read at its end: every kernel of its path must have launched."""
    import tempfile

    from boltzfft_torch import ds, tune
    from boltzfft_torch.examples import (
        adjoint_fit,
        bkw_relaxation,
        convergence_study,
        mixing_2d3v,
        ozaki_contraction,
        precision_ladder,
        taylor_green_2d3v,
    )

    reset_counts(ks)
    with tempfile.TemporaryDirectory() as tmp:
        # ---- (a) the tables' archive on the card
        for n in (32, 64):
            for label, kw in (("rfft + use_pallas", dict(impl="rfft", use_pallas=True)),
                              ("fused (K1)", dict(impl="fused"))):
                cfg = bt.CollisionConfig(nv=n, ns=12, **kw)
                collide, pre = bt.make_collision_operator(cfg)
                _, rsq, f = bkw(bt, cfg, dev)
                q = collide(f, pre)
                path = Path(tmp, f"pre_{n}.npz")
                t0 = time.perf_counter()
                bt.save_precomp(path, cfg, pre)
                save_s = time.perf_counter() - t0
                t0 = time.perf_counter()
                cfg2, pre2 = bt.load_precomp(path)
                torch.cuda.synchronize()
                load_s = time.perf_counter() - t0
                q2, q3 = collide(f, pre2), collide(f, pre2)  # the capture on pre2, a replay
                torch.cuda.synchronize()
                ok = cfg2 == cfg and torch.equal(q2, q) and torch.equal(q3, q)
                check(ok, f"loaded precomp {label} {n}^3: its replayed eval differs")
                digits = bkw_gate(bt, cfg, q2, rsq, f"loaded precomp {label} {n}^3")
                print(f"[24 precomp] {label} {n}^3 float64: save_precomp"
                      f" {path.stat().st_size} bytes in {save_s:.3f} s; load_precomp(device='cuda')"
                      f" {load_s:.3f} s; the loaded tables' replayed eval bitwise equal to the"
                      f" saved ones' {ok} | {card}")
                print(f"  {digits}")
                del collide, pre, pre2, q, q2, q3, f
                torch.cuda.empty_cache()

        # ---- (b) autotune on the staged routes
        q64 = {}
        cases = [(n, dtype, dict(impl="rfft", use_pallas=True))
                 for n in (32, 64) for dtype in ("float64", "float32")]
        cases.append((32, "float64", dict(impl="c2c")))
        for n, dtype, kw in cases:
            cfg = bt.CollisionConfig(nv=n, ns=12, dtype=dtype, **kw)
            label = f"{'rfft + use_pallas' if cfg.use_pallas else cfg.impl} {n}^3 {dtype}"
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            m0 = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            tuned, lines = run_driver(bt.autotune, cfg, verbose=True)
            wall = time.perf_counter() - t0
            torch.cuda.synchronize()
            left = torch.cuda.memory_allocated() - m0
            print(f"[24 autotune] {label}: {len(lines)} candidates in {wall:.2f} s; winner"
                  f" node_chunk={tuned.node_chunk} (chunk {bt.operator.node_chunk_for(tuned, dev)} of"
                  f" {cfg.n_nodes} nodes); memory allocated after the call minus before"
                  f" {left / 2**20:.2f} MiB (tol {MEM_SLACK >> 20} MiB) | {card}")
            for ln in lines:
                ms = float(ln.split("->")[1].split()[0]) * 1e3 if "->" in ln else None
                print(f"  {ln}" + (f" = {ms:.4f} ms per eval | {card}" if ms else ""))
            check(tuned.node_chunk is not None and all("->" in ln for ln in lines),
                  f"autotune {label}: {lines}")
            check(left <= MEM_SLACK, f"autotune {label}: {left} bytes not given back")
            eager, pre = bt.make_collision_operator(tuned, jit=False)
            _, rsq, f = bkw(bt, tuned, dev)
            eager(f, pre)
            torch.cuda.synchronize()
            c0 = counts(ks)
            eager(f, pre)
            torch.cuda.synchronize()
            per = {k: v - c0[k] for k, v in counts(ks).items()}
            graphed, _ = bt.make_collision_operator(tuned)
            q = graphed(f, pre)
            if dtype == "float64":
                gate = bkw_gate(bt, tuned, q, rsq, f"tuned {label}")
                q64[n] = q
            elif n == 32:
                linf = bt.error_norms_device(q, bt.bkw_dfdt(rsq, 6.5), tuned.velocity_grid.dv)["Linf"]
                check(linf <= F32_LINF_32, f"tuned {label}: Linf {linf:.5e}")
                gate = f"Linf {linf:.5e} (gate {F32_LINF_32:g})"
            else:
                d = float((q.double() - q64[n]).abs().max() / q64[n].abs().max())
                check(d <= F32_VS_F64_64, f"tuned {label}: {d:.3e} max|Q| from float64")
                gate = f"{d:.3e} max|Q| from the tuned float64 Q (gate {F32_VS_F64_64:g})"
            print(f"  the winner: K5 {per['k5']} and K6 {per['k6']} launches per eval (an eager"
                  f" eval); replayed: {gate}")
            check(plain_calls(per) == 0
                  and (not cfg.use_pallas or (per["k5"] > 0 and per["k6"] > 0)),
                  f"tuned {label}: launches {per}")
            del eager, graphed, pre, f, q
            torch.cuda.empty_cache()
        del q64

        # ---- (c) autotune_ds on the card defaults: the sub_batch re-measure
        for n in (32, 64):
            cfg = bt.CollisionConfig(nv=n, ns=12)
            c2c, pre = bt.make_collision_operator(bt.CollisionConfig(nv=n, ns=12, impl="c2c"),
                                                  jit=False)
            q_c2c = c2c(bkw(bt, cfg, dev)[2], pre)
            del c2c, pre
            for probe in (1, 2):  # twice, the memo cleared: is the winner repeatable?
                tune._MEMO.clear()
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                m0 = torch.cuda.memory_allocated()
                t0 = time.perf_counter()
                sb, lines = run_driver(bt.autotune_ds, cfg, verbose=True)
                wall = time.perf_counter() - t0
                torch.cuda.synchronize()
                left = torch.cuda.memory_allocated() - m0
                print(f"[24 autotune_ds] {n}^3 Ns=12 (oz, card defaults; k=2, trials=2), probe"
                      f" {probe} of 2: {len(lines)} candidates in {wall:.2f} s; winner"
                      f" sub_batch={sb} (the default stays 2); memory allocated after minus"
                      f" before {left / 2**20:.2f} MiB | {card}")
                for ln in lines:
                    print(f"  {ln} = {float(ln.split('->')[1].split()[0]) * 1e3:.4f} ms per"
                          f" replayed eval (best of 2 chains of 2) | {card}")
                check(len(lines) == 5 and all("->" in ln for ln in lines),
                      f"autotune_ds {n}^3: {lines}")
                check(left <= MEM_SLACK, f"autotune_ds {n}^3: {left} bytes not given back")
            collide, pre = bt.make_ds_collision_operator(cfg, sub_batch=sb)
            f = ds.from_f64(bt.bkw_f(cfg.velocity_grid.r_squared(), 6.5), device=dev)
            q = collide(f, pre)
            print(f"  the winner's eval: {ds_check(bt, cfg, q, q_c2c, f'autotune_ds {n}^3')}")
            del collide, pre, f, q, q_c2c
            torch.cuda.empty_cache()

        # ---- (d) trace: the first call's window (the eager warm-up, the
        # capture and the first replay), then two windows of one replay
        # each, held to the profiler's K1 launches and time on a replay (the
        # profiler drops some of a replay's small kernels in some windows)
        cfg = bt.CollisionConfig(nv=32, ns=12, impl="fused")
        collide, pre = bt.make_collision_operator(cfg)
        _, rsq, f = bkw(bt, cfg, dev)

        def traced():
            torch.cuda.synchronize()
            with bt.trace(str(Path(tmp, "trace"))) as tr:
                out = collide(f, pre)
            events = json.loads(Path(tr.path).read_text())["traceEvents"]
            return out, tr.path, [e for e in events if e.get("cat") == "kernel"]

        q, _, first = traced()
        q2, path, kern = traced()
        q3, _, again = traced()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            collide(f, pre)
            torch.cuda.synchronize()
        prof_kern = [e for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and not e.key.startswith(("Memcpy", "Memset"))]
        want = collections.Counter({e.key: e.count for e in prof_kern})
        ms_prof = sum(self_device_us(e) for e in prof_kern) / 1e3
        k1 = sorted({e["name"].split("(")[0] for e in kern
                     if any(s in e["name"] for s in K1_SYMBOLS)})
        ref = replay_device.get("fused (K1) 32^3 float64")
        print(f"[24 trace] bt.trace around replayed K1 evals, 32^3 float64: {path.split('/')[-1]}"
              f" ({Path(path).stat().st_size} bytes); torch.profiler's key_averages on"
              f" another replay: {sum(want.values())} kernel launches ({k1_launches(want)} of K1),"
              f" {ms_prof:.4f} ms (phase 22's, copies included:"
              f" {'not measured' if ref is None else f'{ref:.4f} ms'}); K1's {k1} | {card}")
        short = lambda name: name.split("(")[0].split("<")[0].split()[-1]  # noqa: E731
        for label, events, times in (("first call (warm-up, capture, replay)", first, 2),
                                     ("one replay", kern, 1), ("another replay", again, 1)):
            got = collections.Counter(e["name"] for e in events)
            ref_n = collections.Counter({k: times * v for k, v in want.items()})
            extra, missing = got - ref_n, ref_n - got
            print(f"  window, {label}: {len(events)} kernel events ({k1_launches(got)} of K1),"
                  f" {sum(e.get('dur', 0.0) for e in events) / 1e3:.4f} ms summed; against"
                  f" {times}x the profiler's launches, {sum(extra.values())} more"
                  f" {dict(collections.Counter(short(k) for k in extra.elements()))} and"
                  f" {sum(missing.values())} fewer"
                  f" {dict(collections.Counter(short(k) for k in missing.elements()))} | {card}")
        check(kern and k1 and torch.equal(q2, q) and torch.equal(q3, q),
              "trace: no K1 kernel event, or Q differs")
        for events in (kern, again):
            got = collections.Counter(e["name"] for e in events)
            busy = sum(e.get("dur", 0.0) for e in events) / 1e3
            check(k1_launches(got) == k1_launches(want),
                  f"trace: {k1_launches(got)} K1 launches against the profiler's"
                  f" {k1_launches(want)}")
            check(abs(busy - ms_prof) <= TRACE_MS_RTOL * ms_prof,
                  f"trace: {busy:.4f} ms summed against the profiler's {ms_prof:.4f} ms")
        del collide, pre, f, q, q2, q3
        torch.cuda.empty_cache()

    # ---- (e) the seven examples at their defaults
    def example(mod, argv):
        t0 = time.perf_counter()
        rc, lines = run_driver(mod.main, argv)
        torch.cuda.synchronize()
        return rc, lines, time.perf_counter() - t0

    def show(name, lines, wall):
        print(f"[24 example] {name}: {wall:.2f} s wall | {card}")
        print("\n".join(f"  {ln}" for ln in lines))

    rc, lines, wall = example(convergence_study, ["--max-nv", "64"])
    show("convergence_study --max-nv 64", lines, wall)
    row = next(ln for ln in lines if ln.split()[0] == "64")
    linf, (want, rtol) = float(row.split()[3]), CONVERGENCE_LINF_64
    check(rc is None and abs(linf - want) <= rtol * want, f"convergence_study 64^3 Linf {linf}")
    rc, lines, wall = example(bkw_relaxation, [])
    show("bkw_relaxation (32^3, Ns=12, 12 RK4 steps)", lines, wall)
    err = float(lines[-1].split(":")[-1])
    mass = [float(ln.split()[1]) for ln in lines[2:-1]]
    check(rc is None and np.isfinite(err) and len(mass) == 12
          and max(abs(m - mass[0]) for m in mass) <= MASS_TOL * mass[0],
          f"bkw_relaxation: rc {rc}, Linf {err}, mass {mass}")
    rc, lines, wall = example(precision_ladder, ["--Nv", "32"])
    show("precision_ladder --Nv 32", lines, wall)
    rows = {ln[:16].strip(): ln.split() for ln in lines[2:]}
    check(rc == 0 and set(rows) == {"fused default", "fused highest", "rfft", "ds (compensated)"}
          and all(np.isfinite(float(r[-3])) for r in rows.values())
          and all(float(r[-2]) <= 1e-4 for k, r in rows.items() if k != "ds (compensated)"),
          f"precision_ladder: rc {rc} {rows}")
    c0 = counts(ks)
    rc, lines, wall = example(adjoint_fit, ["--impl", "fused"])
    k1_adjoint = counts(ks)["k1"] - c0["k1"]
    show(f"adjoint_fit --impl fused (K1 forwards: {k1_adjoint})", lines, wall)
    check(rc == 0 and k1_adjoint > 0, f"adjoint_fit --impl fused: rc {rc}, K1 {k1_adjoint}")
    rc, lines, wall = example(ozaki_contraction, [])
    show("ozaki_contraction", lines, wall)
    rel = float(lines[1].split(":")[1])
    check(rc is None and rel <= 1e-13, f"ozaki_contraction: rel err {rel}")
    for name, mod, local, sharded in (
            ("mixing_2d3v", mixing_2d3v, [], ["--shard"]),
            ("taylor_green_2d3v", taylor_green_2d3v, ["--local"], [])):
        rc0, l0, w0 = example(mod, local)
        rc1, l1, w1 = example(mod, sharded)
        drop = ("spatial decomposition", "unsharded solver")
        same_lines = [ln for ln in l0 if not ln.startswith(drop)] == [
            ln for ln in l1 if not ln.startswith(drop)]
        show(f"{name} {' '.join(local) or '(unsharded)'}", l0, w0)
        print(f"[24 example] {name} {' '.join(sharded) or '(a 1-rank NCCL mesh)'}: {w1:.2f} s"
              f" wall; {l1[0]}; every other line equal to the unsharded run's {same_lines} |"
              f" {card}")
        check(rc0 == 0 == rc1 and same_lines and l1[0].startswith("spatial decomposition: 1x1"),
              f"{name}: rc {rc0} / {rc1}, lines\n{l0}\n{l1}")
    c = counts(ks)
    print(f"[24 launches] the phase's path: {{{', '.join(f'{k}: {c[k]}' for k in TOOLING_KERNELS)}}};"
          f" plain calls {plain_calls(c)}")
    check(all(c[k] > 0 for k in TOOLING_KERNELS) and plain_calls(c) == 0,
          f"phase 24: launches {c}")


def _leaves(tree):
    out = []
    if tree is None:
        return out
    if isinstance(tree, tuple):
        for t in tree:
            out += _leaves(t)
        return out
    return [tree]


# ---- whole-program units replayed from CUDA graphs (phase 25) --------------------
STEP_ROUNDS = 3  # paired rounds of each cell's graphed run and its eager run around the graphed operator
RELAX_LINF = 1e-2  # a relaxation's Linf against the analytic BKW f(t_end), relative to max f
NODE_TYPES = ("KERNEL", "MEMCPY", "MEMSET", "HOST", "GRAPH", "EMPTY", "WAIT_EVENT",
              "EVENT_RECORD", "EXT_SEMAS_SIGNAL", "EXT_SEMAS_WAIT", "MEM_ALLOC", "MEM_FREE",
              "BATCH_MEM_OP", "CONDITIONAL")  # cudaGraphNodeType's order
STEP_FAMILIES = ("line_dft_kernel", "plane_dft_kernel", "kron_gemm_kernel", "alpha_multiply",
                 "gain_reduce", "oz_contract", "gmain", "hwh_kernel", "hadamard_", "preslice",
                 "ds_elementwise", "fft", "nccl", "obs_mark")


def graph_nodes(graph, path: Path) -> dict:
    """The nodes of a captured CUDA graph by type (KERNEL, MEMCPY, ...) and
    its kernel nodes by family (``STEP_FAMILIES``, the rest "other"), read
    from its debug dump (``CUDAGraph.debug_dump``, DOT).  The capture ran
    with ``obs`` on, so the graph kept its ``cudaGraph_t``.  {}
    where the dump names no node."""
    import re

    graph.debug_dump(str(path))
    text = path.read_text() if path.exists() else ""
    path.unlink(missing_ok=True)  # 0.1-26 MB a graph: counted, not kept
    out = collections.Counter()
    for label in re.split(r'"graph_\d+_node_\d+"\[style', text)[1:]:  # node lines, not edges
        label = label.split('"];')[0]
        kind = next((t for t in NODE_TYPES if re.search(rf"\b{t}\b", label)), "unlabelled")
        out[kind] += 1
        if kind == "KERNEL":
            out["kernel: " + next((f for f in STEP_FAMILIES if f in label), "other")] += 1
    return dict(out)


def replayed_graph(op, pre):
    """The CUDA graph an operator built with ``jit=True`` replays for
    ``pre`` (its last capture)."""
    from boltzfft_torch._graph import Replayed

    (rep,) = [c.cell_contents for c in op.__closure__ or ()
              if isinstance(c.cell_contents, Replayed)]
    return [e for e in rep._graphs.values() if e.pre is pre][-1].graph


def inner_graphs(op) -> int:
    """Graphs held by the Replayed units in an operator's closure."""
    from boltzfft_torch._graph import Replayed

    return sum(len(c.cell_contents._graphs) for c in (op.__closure__ or ())
               if isinstance(c.cell_contents, Replayed))


def tree_clone(tree):
    """A copy of a tree of tensors (named tuples kept)."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_clone(x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_clone(x) for x in tree)
    return tree.clone()


class StepCell(collections.namedtuple(
        "StepCell", "name steps unit pre graphed eager eager_op eager_step kernels families gate ops"
        " apart plain", defaults=(None, None))):
    """A phase-25 cell: ``unit`` the Replayed step; ``graphed()``,
    ``eager()`` (the operator eager too) and ``eager_op()`` (the step eager
    around the graphed operator, the path before the step was graphed)
    each -> (final f, per-step trace); ``eager_step(f)`` one eager step;
    ``gate(f, trace)`` prints and checks the path's own gates; ``ops`` the
    graphed operators the unit calls (they must keep no graph).  The fully
    eager run is timed once, before the step's graph.  ``apart``, where
    set, is the graphed operator of ``eager_op`` whose pool does not fit
    beside the step graph's (the ensemble): ``eager_op`` is timed in rounds
    of its own before the step graph is built, and that operator's graph
    freed.  ``plain``, where set (the ds cells), is the run of a second
    step graph, captured on its first run with the ds engine's elementwise
    chains plain: it must give the same bits."""


def relax_cell(bt, name, ops, pre, f0, dt, steps, record, kernels, families, gate):
    """A ``make_relaxation`` cell: ``ops`` = (the graphed operator of the
    unit, another graphed one for ``eager_op``, an eager one)."""
    op_g, op_o, op_e = ops
    mk = lambda op, jit, n=steps: bt.make_relaxation(op, pre, dt=dt, n_steps=n, method="rk4",
                                                     record=record, jit=jit)
    run_g, run_e, one = mk(op_g, True), mk(op_e, False), mk(op_e, False, 1)
    pair = lambda run: (lambda: tuple(run(f0)))
    return StepCell(name, steps, run_g.step, pre, pair(run_g), pair(run_e),
                    pair(mk(op_o, False)), lambda f: one(f), kernels, families, gate, (op_g,))


def eager_body(step, diagnostics, device=None):
    """``cli.step_body``'s body, run eagerly: ``(f, pre) -> (f', diagnostics(f'))``."""
    def body(f, pre):
        f = step(f, pre)
        return f, diagnostics(f)

    return body


def drop_graphs(op):
    """Free the graphs of the Replayed units in an operator's closure."""
    from boltzfft_torch._graph import Replayed

    for c in op.__closure__ or ():
        if isinstance(c.cell_contents, Replayed):
            c.cell_contents._graphs.clear()


def pool_segments(graph) -> str:
    """A graph's private memory pool, segment by segment, largest first:
    each segment's MiB and the MiB of the blocks it is split into (``*``
    marks a block in use: the graph's outputs)."""
    pid = tuple(graph.pool())
    segs = sorted((sg for sg in torch.cuda.memory_snapshot()
                   if tuple(sg.get("segment_pool_id", ())) == pid),
                  key=lambda sg: -sg["total_size"])
    mib = lambda n: f"{n / 2**20:.0f}"
    return (f"{len(segs)} segments: " + "; ".join(
        mib(sg["total_size"]) + " [" + " ".join(
            mib(b["size"]) + ("*" if b["state"] == "active_allocated" else "")
            for b in sg["blocks"][:8]) + (" ..." if len(sg["blocks"]) > 8 else "") + "]"
        for sg in segs[:5]) + (" ..." if len(segs) > 5 else ""))


def body_cell(name, dev, steps_, diag, pre, f0, steps, kernels, families, gate, ops):
    """A driver-body cell (``cli.step_body`` + ``cli.march``): ``steps_`` =
    (the step around the unit's graphed operator, around another graphed
    operator, around an eager one)."""
    from boltzfft_torch.cli import march, step_body

    body_g = step_body(steps_[0], diag, dev)
    body_o, body_e = (eager_body(s, diag) for s in steps_[1:])
    run = lambda body: (lambda: march(body, f0, pre, steps))
    return StepCell(name, steps, body_g, pre, run(body_g), run(body_e), run(body_o),
                    lambda f: body_e(f, pre), kernels, families, gate, ops)


def run_step_cell(cell, ks, card):
    """Phase 25's measurements of one cell (see ``step_graph_phase``)."""
    import gc

    n = cell.steps
    if not cell.apart:
        cell.eager_op()  # the operator captures its own graph, outside the counts
        torch.cuda.synchronize()
    reset_counts(ks)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    a0, r0 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    want = cell.eager()
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) * 1e3 / n
    peak = torch.cuda.max_memory_allocated() - a0
    peak_r = torch.cuda.max_memory_reserved() - r0
    c_eager = counts(ks)
    # one eager step profiled now: beside the step graph's pool it may not fit (the ensemble)
    prof_eager = profile_eval(lambda: cell.eager_step(want[0]), cell.families)
    torch.cuda.empty_cache()
    apart = {}
    if cell.apart:  # the eager step around the graphed operator, then its graph freed
        ok_o = same(cell.eager_op(), want)
        torch.cuda.synchronize()
        apart = {"eager, operator graphed (rounds of its own, before the step graph)": []}
        for _ in range(STEP_ROUNDS):
            t0 = time.perf_counter()
            cell.eager_op()
            torch.cuda.synchronize()
            apart[next(iter(apart))].append((time.perf_counter() - t0) * 1e3 / n)
        drop_graphs(cell.apart)
        gc.collect()
        torch.cuda.empty_cache()
    r0 = torch.cuda.memory_reserved()
    reset_counts(ks)
    t0 = time.perf_counter()
    first = cell.graphed()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    c_cap = counts(ks)
    inner = sum(inner_graphs(op) for op in cell.ops)
    torch.cuda.empty_cache()
    pool = torch.cuda.memory_reserved() - r0
    (entry,) = cell.unit._graphs.values()
    segments = pool_segments(entry.graph)
    keep = tree_clone(first)
    reset_counts(ks)
    again = cell.graphed()
    torch.cuda.synchronize()
    c_rep = counts(ks)
    ok = same(first, want) and same(again, want) and same(first, keep)
    if not cell.apart:
        ok_o = same(cell.eager_op(), want)
    per_step = {k: v // n for k, v in c_eager.items()}
    counts_ok = (all(v % n == 0 and c_cap[k] == 2 * per_step[k] for k, v in c_eager.items())
                 and all(c_cap[k] > 0 for k in cell.kernels) and plain_calls(c_cap) == 0
                 and all(v == 0 for v in c_rep.values()))
    print(f"[25 graph] {cell.name}: {n} steps, one CUDA graph a step; graphed run (twice) bitwise"
          f" equal to eager on the final f and every trace entry {ok}, the first run's results"
          f" kept across the second; eager around the graphed operator equal too {ok_o} | {card}")
    print(f"  launches of one eager step {{{', '.join(f'{k}: {per_step[k]}' for k in cell.kernels)}}};"
          f" of the first graphed run (warm-up + capture)"
          f" {{{', '.join(f'{k}: {c_cap[k]}' for k in cell.kernels)}}}; of a second run"
          f" {sum(c_rep.values())}; graphs kept by the inner operators {inner}")
    check(ok and ok_o, f"step graph {cell.name}: bits differ from the eager run")
    del want, again, keep
    check(counts_ok, f"step graph {cell.name}: counts eager {c_eager} capture {c_cap} replay {c_rep}")
    check(inner == 0, f"step graph {cell.name}: an inner operator captured a graph of its own")
    cell.gate(*first)
    with tempfile.TemporaryDirectory() as tmp:
        nodes = graph_nodes(entry.graph, Path(tmp, "step.dot"))
    kinds = {k: v for k, v in nodes.items() if not k.startswith("kernel: ")}
    fams = {k[8:]: v for k, v in nodes.items() if k.startswith("kernel: ")}
    print(f"  step graph nodes: {kinds or 'not measured'}; kernel nodes by family"
          f" {fams or 'not measured'} | {card}")
    t0 = time.perf_counter()
    entry.graph.replay()
    launch_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    runs = {"graph": cell.graphed}
    if not cell.apart:
        runs["eager, operator graphed"] = cell.eager_op
    if cell.plain:  # the step graph with the ds chains plain, captured now
        ok_p = same(plain(cell.plain)(), first)
        print(f"  the step graph captured with the ds chains plain: bitwise equal {ok_p}")
        check(ok_p, f"step graph {cell.name}: fused ds chains != plain chains")
    wall = {k: [] for k in runs}
    for rnd in range(STEP_ROUNDS):
        for k in (list(runs) if rnd % 2 == 0 else list(runs)[::-1]):
            t0 = time.perf_counter()
            runs[k]()
            torch.cuda.synchronize()
            wall[k].append((time.perf_counter() - t0) * 1e3 / n)
    wall.update(apart)
    med = {k: statistics.median(v) for k, v in wall.items()}
    print(f"[25 wall] {cell.name}: ms per step, medians of {STEP_ROUNDS} paired rounds of {n}"
          f" steps (min-max): " + "; ".join(
              f"{k} {med[k]:.4f} ({min(v):.4f}-{max(v):.4f})" for k, v in wall.items())
          + f"; eager (the operator too), one run {eager_ms:.4f}; first graphed run"
          f" {1e3 * first_s:.1f} ms (warm-up + capture + {n - 1} replays), so the capture about"
          f" {1e3 * first_s - (n - 1) * med['graph']:.1f} ms; the host's time in one"
          f" graph.replay() call {launch_ms:.3f} ms | {card}")
    print(f"  memory: the step graph's pool {pool / 2**20:.1f} MiB reserved (memory_reserved"
          f" across the first graphed run, caches emptied); the eager run's peak"
          f" {peak / 2**20:.1f} MiB allocated, {peak_r / 2**20:.1f} MiB reserved | {card}")
    print(f"  the step graph's pool, MiB: {segments} | {card}")
    med["eager"] = eager_ms
    f_last = first[0]
    profs = [("one replayed step", profile_eval(lambda: cell.unit(f_last, cell.pre), cell.families),
              "graph"), ("one eager step", prof_eager, "eager")]
    for what, prof, key in profs:
        fam, wall_us = prof
        print_profile(f"{cell.name}, {what}", fam, wall_us, card, 25)
        busy = sum(v[0] for v in fam.values()) / 1e3
        print(f"  device time against the unprofiled wall per step ({key}): {busy:.4f} of"
              f" {med[key]:.4f} ms, idle share {100 * (1 - busy / med[key]):.1f}% | {card}")
    return med, {k: v // 2 for k, v in c_cap.items()}


def step_graph_phase(bt, dev, card, ks):
    """Phase 25, the whole-program slice: each unit the JAX package compiles
    whole replayed from one CUDA graph a step, against its eager run (the
    operator eager too) and the eager step around the graphed operator,
    bitwise on the final f and every trace entry; the path's gates; launches
    (the first graphed run counts two eager steps', the warm-up and the
    capture; a replay none; the inner operators keep no graph); the step
    graph's nodes; paired walls; the pool against the eager peak; one
    profiled replay and eager step.  Cells: the TG-2D body on 16x16 cells x
    16^3 Ns=12 (K1, float64 and float32, 10 steps), on K3 at 8^3 (3 steps),
    TG-3D on 8^3 cells (2 steps), Sod on 32 cells (5 steps), RK4 through
    ``make_relaxation`` at 32^3 on K1 and 64^3 on rfft + use_pallas
    (float64, 10 steps, moments and H recorded), ds RK4 at 32^3 and 64^3 on
    the card defaults (4 steps), the ensemble (E = 256 x 32^3 f64, 2 steps),
    and the decomposed TG-2D step on a 1-rank NCCL mesh built with
    ``jit=True``; first, the TG-2D, TG-3D and Sod drivers' printed lines,
    graphed against their body run eagerly.  The ds cells' step graphs are
    also captured with the ds chains plain, bitwise.  Returns the ds RK4
    cells' launches per step graph (half the first graphed run's count:
    the warm-up and the capture), ``{grid: counts}``."""
    import gc

    import torch.distributed as dist

    from boltzfft_torch import _graph, cli, ds, obs, transport
    from boltzfft_torch.cli import march, sod_1d3v
    from boltzfft_torch.cli import taylor_green_2d3v as tg2
    from boltzfft_torch.cli import taylor_green_3d3v as tg3
    from boltzfft_torch.ds_operator import ds_collide_fn, make_ds_collision_operator

    obs.enable()  # the step graphs keep their nodes for the count
    tg = dict(u0=0.8, temperature=3.0)

    # ---- the drivers' printed lines: graphed (their default) against the
    # same driver with its body eager (cli.step_body swapped for eager_body)
    for mod, argv in ((tg2, ["--steps", "10", "--trials", "1"]),
                      (tg3, ["--cells", "8", "--steps", "2", "--trials", "1"]),
                      (sod_1d3v, ["--Nv", "16", "--nx", "32", "--steps", "5"])):
        lines = {}
        for jit in (True, False):
            real = cli.step_body
            cli.step_body = real if jit else eager_body
            try:
                rc, out = run_driver(mod.main, argv + ["--device", "cuda"])
            finally:
                cli.step_body = real
            check(rc == 0, f"{mod.__name__} {argv}: rc {rc}")
            lines[jit] = [ln for ln in out if " steps in " not in ln]
        same_lines = lines[True] == lines[False]
        print(f"[25 driver] {mod.__name__.split('.')[-1]} {' '.join(argv)}: graphed body's lines"
              f" equal to the eager body's (the timing line aside) {same_lines} | {card}")
        print("\n".join(f"  | {ln}" for ln in lines[True][-4:]))
        check(same_lines, f"{mod.__name__}: printed lines differ graphed / eager")

    def ops3(cfg):
        made = [bt.make_collision_operator(cfg, jit, device=dev) for jit in (True, True, False)]
        return [op for op, _ in made], made[0][1]  # one precomp for all three

    def spatial_gate(name, dv3, cell_vol, mass0, h0, col_m, col_h):
        def gate(f, trace):
            tr = torch.stack(trace).cpu().numpy()
            mass = [mass0] + ([float(v) for v in tr[:, col_m]] if col_m is not None
                              else [float(torch.sum(f) * dv3 * cell_vol)])
            gates(f"{name} (graphed)", f, mass, [h0] + [float(v) for v in tr[:, col_h]])
        return gate

    def tg2d(dtype, kron=False):
        kw = dict(nv=8, fused_scheme="kron") if kron else dict(nv=16)
        cfg = bt.CollisionConfig(ns=12, impl="fused", dtype=dtype, **kw)
        ops, pre = ops3(cfg)
        vmax = float(abs(cfg.velocity_grid.v).max())
        d = 1.0 / 16
        steps_ = [transport.make_inhomogeneous_step_2d(
            cfg, op, dx=d, dy=d, dt=transport.cfl_dt(vmax, d), knudsen=0.2) for op in ops]
        diag = tg2.diagnostics_fn(cfg, d, dev)
        f0 = tg2.taylor_green_f0(cfg, 16, device=dev, **tg)
        m0, _, h0 = (float(v) for v in diag(f0))
        name = (f"TG-2D 16x16 cells x {cfg.nv}^3 {dtype} "
                + ("(kron, K3)" if kron else "(K1)"))
        return body_cell(name, dev, steps_, diag, pre, f0, 3 if kron else 10,
                         ("k3",) if kron else ("k1",), OPERATOR_FAMILIES,
                         spatial_gate(name, cfg.velocity_grid.cell_volume, d * d, m0, h0, 0, 2),
                         ops[:1])

    def tg3d():
        cfg = bt.CollisionConfig(nv=16, ns=12, impl="fused")
        ops, pre = ops3(cfg)
        vmax = float(abs(cfg.velocity_grid.v).max())
        d = 1.0 / 8
        steps_ = [transport.make_inhomogeneous_step_3d(
            cfg, op, dx=d, dy=d, dz=d, dt=transport.cfl_dt(vmax, d), knudsen=0.2) for op in ops]
        diag = tg3.diagnostics_fn(cfg, d, dev)
        f0 = tg3.taylor_green_f0_3d(cfg, 8, device=dev, **tg)
        m0, _, h0 = (float(v) for v in diag(f0))
        name = "TG-3D 8^3 cells x 16^3 float64 (K1)"
        return body_cell(name, dev, steps_, diag, pre, f0, 2, ("k1",), OPERATOR_FAMILIES,
                         spatial_gate(name, cfg.velocity_grid.cell_volume, d ** 3, m0, h0, 0, 2),
                         ops[:1])

    def sod():
        cfg = bt.CollisionConfig(nv=16, ns=12, impl="fused")
        ops, pre = ops3(cfg)
        g = cfg.velocity_grid
        d = 1.0 / 32
        steps_ = [transport.make_inhomogeneous_step(
            cfg, op, dx=d, dt=transport.cfl_dt(float(abs(g.v).max()), d), knudsen=0.5)
            for op in ops]
        h_total = lambda f: torch.sum(bt.entropy(f, g.dv)) * d  # the driver's H
        f0 = transport.sod_initial_condition(cfg, 32, device=dev)
        name = "Sod 32 cells x 16^3 float64 (K1)"
        gate = spatial_gate(name, g.cell_volume, d, float(torch.sum(f0) * g.cell_volume * d),
                            float(h_total(f0)), None, 0)
        return body_cell(name, dev, steps_, lambda f: h_total(f).reshape(1), pre, f0, 5,
                         ("k1",), OPERATOR_FAMILIES, gate, ops[:1])

    def relax_gate(name, cfg, f0, t_end):
        g = cfg.velocity_grid

        def gate(f, rec):
            if rec is not None:  # mass and H, summed over an ensemble's members
                moms, h = rec
                mass = [float(torch.sum(bt.moments(f0, g.v, g.dv).mass))] + [
                    float(v) for v in moms.mass.reshape(moms.mass.shape[0], -1).sum(1)]
                hs = [float(torch.sum(bt.entropy(f0, g.dv)))] + [
                    float(v) for v in h.reshape(h.shape[0], -1).sum(1)]
                gates(f"{name} (graphed)", f, mass, hs)
            if t_end is None:
                return
            x = ds.to_f64(f) if isinstance(f, ds.DS) else f.double().cpu().numpy()
            exact = bt.bkw_f(g.r_squared(), t_end)
            linf = float(np.abs(x - exact).max() / np.abs(exact).max())
            print(f"  {name}: Linf against the analytic BKW f(t_end = {t_end}) {linf:.4e} of"
                  f" max f (tol {RELAX_LINF:g})")
            check(np.isfinite(linf) and linf <= RELAX_LINF, f"{name}: relaxation Linf {linf}")
        return gate

    def bkw_relax(n):
        kw = dict(impl="fused") if n == 32 else dict(impl="rfft", use_pallas=True)
        cfg = bt.CollisionConfig(nv=n, ns=12, **kw)
        ops, pre = ops3(cfg)
        g = cfg.velocity_grid
        f0 = torch.as_tensor(bt.bkw_f(g.r_squared(), 5.5), dtype=cfg.real_dtype, device=dev)
        record = lambda x: (bt.moments(x, g.v, g.dv), bt.entropy(x, g.dv))
        name = f"BKW RK4 {n}^3 Ns=12 float64 ({'K1' if n == 32 else 'rfft + use_pallas, K6 K5'})"
        return relax_cell(bt, name, ops, pre, f0, 0.125, 10, record,
                          ("k1",) if n == 32 else ("k5", "k6"), OPERATOR_FAMILIES,
                          relax_gate(name, cfg, f0, 5.5 + 10 * 0.125))

    def ds_relax(n):
        cfg = bt.CollisionConfig(nv=n, ns=12, impl="c2c", dtype="float32")
        op, pre = make_ds_collision_operator(cfg, device=dev)
        ops = [op] + [ds_collide_fn(cfg, jit, device=dev) for jit in (True, False)]
        f0 = ds.from_f64(bt.bkw_f(cfg.velocity_grid.r_squared(), 5.5), torch.float32, dev)
        name = f"ds RK4 {n}^3 Ns=12 (card defaults)"
        cell = relax_cell(bt, name, ops, pre, f0, 0.25, 4, None,
                          ("k7", "k8", "k9" if n == 32 else "k10", "k12", "ew_axpy"), DS_FAMILIES,
                          relax_gate(name, cfg, f0, 5.5 + 4 * 0.25))
        run_p = bt.make_relaxation(ds_collide_fn(cfg, True, device=dev), pre, dt=0.25, n_steps=4,
                                   method="rk4", jit=True)
        return cell._replace(plain=lambda: tuple(run_p(f0)))

    def ensemble():
        mesh = bt.make_mesh([(bt.ENSEMBLE_AXIS, 1)], device=dev)
        check(dist.get_backend() == "nccl", "phase 25: a 1-rank NCCL group")
        cfg = bt.CollisionConfig(nv=32, ns=12, impl="fused")
        # K1 on 256 members holds two 18 GiB buffers: a second graphed operator's pool
        # does not fit beside the step graph's, so its eager step is timed apart
        made = [bt.make_sharded_collision_operator(cfg, mesh, node_axis=None,
                                                   ensemble_axis=bt.ENSEMBLE_AXIS, jit=jit)
                for jit in (True, True, False)]
        g = cfg.velocity_grid
        f0 = torch.as_tensor(np.stack([bt.bkw_f(g.r_squared(), t)
                                       for t in 5.5 + 2.0 * np.arange(256) / 256]),
                             dtype=cfg.real_dtype, device=dev)
        record = lambda f: (bt.moments(f, g.v, g.dv), bt.entropy(f, g.dv))  # ensemble_bkw's
        name = "ensemble E = 256 x 32^3 float64, RK4 (K1)"
        ops = [op for op, _ in made]
        cell = relax_cell(bt, name, ops, made[0][1], f0, 0.1, 2, record, ("k1",),
                          OPERATOR_FAMILIES, relax_gate(name, cfg, f0, None))
        return cell._replace(apart=ops[1])

    def sharded_tg2d():
        mesh = bt.make_mesh([("cx", 1), ("cy", 1)], device=dev)
        cfg = bt.CollisionConfig(nv=16, ns=12, impl="fused")
        ops, pre = ops3(cfg)
        d = 1.0 / 16
        kw = dict(dx=d, dy=d, dt=transport.cfl_dt(float(abs(cfg.velocity_grid.v).max()), d),
                  knudsen=0.2, x_axis="cx", y_axis="cy")
        unit = transport.make_sharded_step_2d(cfg, ops[0], mesh, **kw)
        check(isinstance(unit, _graph.Replayed), "make_sharded_step_2d(jit=True) on NCCL: no graph")
        eager = [transport.make_sharded_step_2d(cfg, op, mesh, jit=False, **kw) for op in ops[1:]]
        diag = tg2.diagnostics_fn(cfg, d, dev)
        f0 = tg2.taylor_green_f0(cfg, 16, device=dev, **tg)
        m0, _, h0 = (float(v) for v in diag(f0))
        name = "sharded TG-2D step (jit=True), 1-rank NCCL mesh, 16x16 cells x 16^3 float64"
        cell = body_cell(name, dev, [unit, *eager], diag, pre, f0, 10, ("k1",), OPERATOR_FAMILIES,
                         spatial_gate(name, cfg.velocity_grid.cell_volume, d * d, m0, h0, 0, 2),
                         ops[:1])
        # the unit is the sharded step itself, the diagnostics run eagerly after it
        body = lambda f, p: (lambda x: (x, diag(x)))(unit(f, p))
        return cell._replace(unit=unit, graphed=lambda: march(body, f0, pre, 10))

    ds_step = {}  # the ds RK4 cells' launches per step graph, by grid
    for build in (partial(tg2d, "float64"), partial(tg2d, "float64", kron=True),
                  partial(tg2d, "float32"), tg3d, sod, partial(bkw_relax, 32),
                  partial(bkw_relax, 64), partial(ds_relax, 32), partial(ds_relax, 64),
                  ensemble, sharded_tg2d):
        cell = build()
        _, per_graph = run_step_cell(cell, ks, card)
        if getattr(build, "func", None) is ds_relax:
            ds_step[build.args[0]] = per_graph
        del cell  # its graphs and pools go before the next cell's
        gc.collect()
        torch.cuda.empty_cache()
    dist.destroy_process_group()
    obs.disable()
    return ds_step


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

    import boltzfft_torch as bt
    from boltzfft_torch import _build, health
    from boltzfft_torch import operator as op
    from boltzfft_torch import transport
    from boltzfft_torch.cli import fft_benchmark, loop_benchmark, maxwell_bkw
    from boltzfft_torch.cli.taylor_green_2d3v import taylor_green_f0
    from boltzfft_torch.cli.taylor_green_3d3v import taylor_green_f0_3d

    ks = kernel_modules()
    k1, k3, k24, k5, k6 = ks.k1, ks.k3, ks.k24, ks.k5, ks.k6

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
            ok = same and rerun
            print(f"  K6 {dtype} {n}^3 chunk {tuple(a[0].shape)}: max|d| {err:.3e} = {err / scale:.3e}"
                  f" of max (tol {TOL[dtype]:g}); bitwise equal to plain {same}; run to run"
                  f" bitwise {rerun} {'ok' if ok else 'FAIL'}")
            check(ok, f"K6 != plain version at {dtype} {n}^3")
            max_err[("k6", dtype, n)] = err
            if n == 32:  # a ragged shape: one partial tile of a 6-node chunk
                cd = cfg.complex_dtype
                rng = np.random.default_rng(6)
                rag = [torch.as_tensor(rng.standard_normal(s) + 1j * rng.standard_normal(s),
                                       dtype=cd, device=dev) for s in ((6, 8), (6, 40), (8, 40))]
                parity_check({}, f"K6 {dtype} ragged B 6, N 8, M2 40 ({k6.plan(6, 8, 40, cd.itemsize, True)})",
                             "k6", lambda: k6.alpha_multiply(*rag),
                             lambda: k6.alpha_multiply_reference(*rag))
            # K5 at each node block against its plain version at the same
            # node block, and its two routes (one launch; node blocks through
            # the scratch) against each other
            for nb in NODE_BLOCKS:
                p5 = k5.plan(k5_args[0].shape[0], k5_args[0].shape[1], nb, _build.sm_count(dev))
                out = k5.gain_reduce(*k5_args, node_block=nb, **k5_kw)
                again = k5.gain_reduce(*k5_args, node_block=nb, **k5_kw)
                routes = [k5._gain_reduce_cuda(*k5_args, node_block=nb, split=s, **k5_kw)
                          for s in (0, 1)]
                ref = k5.gain_reduce_reference(*k5_args, node_block=nb, **k5_kw)
                torch.cuda.synchronize()
                err = float((out - ref).abs().max())
                scale = float(ref.abs().max())
                split_same = all(torch.equal(out, r) for r in routes)
                rerun = torch.equal(out, again)
                ok = err <= TOL[dtype] * scale and split_same and rerun
                print(f"  K5 {dtype} {n}^3 h {tuple(k5_args[0].shape)} node_block {nb} ({p5}):"
                      f" max|d| {err:.3e} = {err / scale:.3e} of max (tol {TOL[dtype]:g});"
                      f" split and one-launch routes bitwise equal {split_same}; run to run"
                      f" bitwise {rerun} {'ok' if ok else 'FAIL'}")
                check(ok, f"K5 != plain version or its routes differ at {dtype} {n}^3 nb {nb}")
                max_err[("k5", dtype, n)] = max(max_err.get(("k5", dtype, n), 0.0), err)
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
            collide, pre = bt.make_collision_operator(cfg, jit=False, device="cuda")
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
        coll_c, pre_c = bt.make_collision_operator(cfg_c, jit=False, device="cuda")
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
                    collide, pre = bt.make_collision_operator(cfg, jit=False, device="cuda")
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
        collide, pre = bt.make_collision_operator(cfg, jit=False, device="cuda")
        collide_k, pre_k = bt.make_collision_operator(cfg_k, jit=False, device="cuda")
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
    coll_c, pre_c = bt.make_collision_operator(cfg_c, jit=False, device="cuda")
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
        collide, pre = bt.make_collision_operator(cfg, jit=False, device="cuda")
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
        collide8, pre8 = bt.make_collision_operator(cfg8, jit=False, device="cuda")
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
    # the driver's relaxation replays one RK4 step (4 evals) from a CUDA
    # graph: the warm-up and the capture count 8 launches, 9 replays nothing
    check(rc == 0 and c8["k1"] == 8 and plain_calls(c8) == 0, f"maxwell_bkw --steps: rc {rc} {c8}")
    trajs = {}
    for impl, jit in (("fused", True), ("fused eager", False), ("c2c", True)):
        cfg = bt.CollisionConfig(nv=32, ns=12, impl=impl.split()[0])
        collide, pre = bt.make_collision_operator(cfg, jit, device="cuda")
        g, rsq, _ = bkw(bt, cfg, dev)
        f0 = torch.as_tensor(bt.bkw_f(rsq, 5.5), dtype=cfg.real_dtype, device=dev)
        trajs[impl] = bt.make_relaxation(collide, pre, dt=0.125, n_steps=10, method="rk4",
                                         record=lambda x: bt.moments(x, g.v, g.dv), jit=jit)(f0)
        del collide, pre
    same8 = (torch.equal(trajs["fused"].f, trajs["fused eager"].f)
             and torch.equal(trajs["fused"].recorded.mass, trajs["fused eager"].recorded.mass))
    print(f"  10 RK4 steps through K1, the step's CUDA graph (jit=True) against eager"
          f" (jit=False, the operator too): f and mass trace bitwise equal {same8}")
    check(same8, "relaxation: the graphed RK4 step's bits differ from eager")
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
            # K5: h, |l|, rho and gw read, the output written (the bytes the
            # function needs); the split route's scratch is the design's
            # cost, printed beside the bound and not counted in it
            p5 = k5.plan(c6, m, 8, _build.sm_count(dev))
            b_k5 = bound(10.0 * c6 * m, csize * (2 * c6 * m + m + 2 * c6 + 2 * m), dtype)
            scratch = csize * 2 * 2 * p5.blocks * m if p5.split else 0
            print(f"[11 bound] K5 {n}^3 {dtype} split route's scratch (block sums written and"
                  f" read back, not in the bound): {scratch} B, {1e3 * scratch / PEAK_BYTES:.4f}"
                  f" ms at the memory rate | {card}")
            p6 = k6.plan(c6, n, m2, csize * 2, True)
            dev6 = device_ms(lambda: k6.alpha_multiply(*k6_args), "alpha_multiply_kernel")
            print(f"[11 device] K6 {n}^3 {dtype} ({p6}): {dev6 if dev6 is None else f'{dev6:.4f}'}"
                  f" ms per call (profiler) against its bound {b_k6[0]:.4f} ms | {card}")
            fam5 = profile_calls(lambda: k5.gain_reduce(*k5_args, **k5_kw),
                                 ("gain_reduce_kernel", "block_sum_kernel"), 10)
            dev5 = None if fam5 is None else sum(v[0] for k, v in fam5.items() if k != "other") / 1e4
            print(f"[11 device] K5 {n}^3 {dtype} ({p5}): {dev5 if dev5 is None else f'{dev5:.4f}'}"
                  f" ms per call (profiler, both launches where split) | {card}")
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
                dms = {"dev_ms": {"k5": dev5, "k6": dev6}[key]} if key in ("k5", "k6") else {}
                rc_ = route_counts[(route_label, dtype, n)]
                tc = {} if len(b_ms) == 2 else {"bound_unit": TC_UNIT[dtype]}
                entry(f"{kname}[{dtype},{n}^3,Ns=12]", kname, dtype, rc_[key], rc_[key + "_plain"],
                      max_err[(key, dtype, n)], times[(key, n, dtype, "kernel")],
                      times[(key, n, dtype, "plain")], b_ms[0], b_ms[1],
                      times.get((key, n, dtype, "library")), **tc, **dms)
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
            t = self_device_us(e)
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
    ds_graph_phase(bt, dev, card, ks, st)
    lap(21)
    replay_device = operator_graph_phase(bt, dev, card, ks)
    lap(22)
    sharded_phase(bt, dev, card, ks)
    lap(23)
    tooling_phase(bt, dev, card, ks, replay_device)
    lap(24)
    ds_step = step_graph_phase(bt, dev, card, ks)
    lap(25)
    ds_elementwise_phase(bt, dev, card, ks, st, entry, ds_step)
    lap(26)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--two-rank"]:  # a rank of phase 23 (c), spawned by the phase
        sys.exit(two_rank_main(int(sys.argv[2]), sys.argv[3], sys.argv[4]))
    sys.exit(main())
