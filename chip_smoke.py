"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device: a CUDA card must be present; prints its name and power limit;
2. build: compiles the port's CUDA kernels from ``boltzfft_torch/csrc``;
3. each kernel against its plain PyTorch version on the card: K1
   (``fused_collide``; float64 within 1e-12 max|Q|, float32 within 1e-5,
   4e-5 at 16^3, see ``TOL``) and K3 (``fused_gain_kron``; float64 within
   1e-12 max|Q_gain_hat|, float32 within 1e-5), and K3's route of ``collide``
   against the staged cuFFT c2c in float64 (1e-12 max|Q|);
4. the homogeneous main path, ``make_collision_operator(CollisionConfig(
   nv=32|64, ns=12, impl="fused"))`` on the BKW distribution at t = 6.5 (K1),
   against the reference's error norms and the port's staged float64 c2c;
5. the inhomogeneous main path at its CLIs' default size (16^3
   velocities, Ns=12, ``impl="fused"``: K3): Taylor-Green 2D on 16x16 cells
   (10 steps), Taylor-Green 3D on 8^3 cells (2 steps), Sod on 32 cells
   (5 steps), in float64 and float32, each held to the CLIs' mass-drift
   and H-theorem gates, and one float64 TG-2D step against the same step on
   the staged c2c pipeline (1e-12 relative);
6. determinism (bitwise run to run and batched against per item, for K1,
   for the TG-2D step, and for the collides of the TG-2D, TG-3D and Sod cell
   stacks), K3 against its plain version on the TG-3D (512 cells) and Sod
   (32 cells) stacks, and dispatch (each main path launched its kernel and
   never a plain version; K1 is not launched on K3's route);
7. times (CUDA events, 2 warm-ups, 10 trials): K1 and its plain version at
   32^3 and 64^3; K3 (first held to its plain version there), its plain
   version and K1 on the 256-cell TG-2D batch;
   the TG-2D step; and a ``torch.profiler`` window over TG-2D steps (device
   time by kernel family and the card's idle share).

The last two lines are a JSON summary of the kernels and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

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
    ((16, 16, 48), 12, 1),
]
# |kernel - plain| in units of max|Q| (K1) or max|Q_gain_hat| (K3).  float32
# Q at 16^3: the gain and loss terms are ~30x max|Q| there and cancel, so
# each float32 version lies 1.5-1.7e-5 max|Q| from the float64 result and two
# of them can differ by the sum of that; from 32^3 on, 1e-5.
TOL = {"float64": 1e-12, "float32": 1e-5}
TOL_F32_16 = 4e-5
BKW_DIGITS = {  # reference f64 L1, L2, Linf at Ns=12 and the rtol they hold to
    32: ((1.5403e-03, 1.0119e-04, 4.2512e-05), 1e-4),
    64: ((8.9149e-11, 8.3092e-12, 3.0685e-12), 1e-3),
}
TRIALS = 10
# The CLIs' gates: relative mass drift, and the worst per-step H rise as a
# share of the total dissipation |H_end - H_0|.
MASS_TOL = 1e-2
H_TOL = 0.01
# Peaks of an H100 SXM at 700 W (NVIDIA's data sheet): CUDA-core FLOP/s in
# float32 and float64 (the kernels use no tensor cores), device memory bytes/s.
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
PEAK_BYTES = 3.35e12


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


def k1_flops(shape, n_nodes, n_groups, batch=1):
    """K1's arithmetic: every transform is a dense DFT along one axis,
    n3 * N_axis complex multiply-adds per axis, 8 FLOPs each; per eval the
    forward of f, 2 streams per node, one forward per group and the 2 final
    inverses (``csrc/fused_collide.cu``)."""
    n3 = shape[0] * shape[1] * shape[2]
    return batch * 8.0 * n3 * sum(shape) * (2 * n_nodes + n_groups + 3)


def k3_flops(shape, n_nodes, n_groups, batch=1):
    """The least arithmetic of Q_gain_hat from f_hat, K3's bound: every
    transform as separable dense DFTs along each axis (as ``k1_flops``
    counts them), 2 streams per node and one forward per group."""
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
    bytes over the memory rate."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


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


def max_rel(a, b):
    return float((a - b).abs().max()) / float(b.abs().max())


def reset_counts(k1, k3):
    k1.LAUNCHES = k1.REFERENCE_CALLS = 0
    k3.LAUNCHES = k3.REFERENCE_CALLS = 0


def counts(k1, k3):
    return dict(k1=k1.LAUNCHES, k1_plain=k1.REFERENCE_CALLS,
                k3=k3.LAUNCHES, k3_plain=k3.REFERENCE_CALLS)


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


def main() -> int:
    # ---- 1. device -----------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; no card, no result")
    card = card_line()
    name = torch.cuda.get_device_name(0)
    dev = torch.device("cuda", 0)
    print(f"[1 device] {card} | torch {torch.__version__} cuda {torch.version.cuda}")

    import boltzfft_torch as bt
    from boltzfft_torch import _build
    from boltzfft_torch import operator as op
    from boltzfft_torch import transport
    from boltzfft_torch.cli.taylor_green_2d3v import taylor_green_f0
    from boltzfft_torch.cli.taylor_green_3d3v import taylor_green_f0_3d
    from boltzfft_torch.kernels import fused_collide as k1
    from boltzfft_torch.kernels import fused_gain as k3

    # ---- 2. build ------------------------------------------------------
    t0 = time.perf_counter()
    _build.load_library()
    print(f"[2 build] {_build.LIB_PATH} in {time.perf_counter() - t0:.1f} s")
    for line in _build.BUILD_LOG.read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())
        elif line.startswith("# build seconds"):
            print("  per compile, then link, then wall:", line[2:])

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
    # K3's route of collide: against the staged cuFFT c2c (float64), and its
    # float32 Q against its float64 Q at 16^3 (the cancellation rule)
    for shape, ns, _ in SHAPES_K3[:1] + SHAPES_K3[2:]:
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

    # ---- 4. homogeneous main path (K1) ---------------------------------
    reset_counts(k1, k3)
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
    c4 = counts(k1, k3)
    print(f"[4 homogeneous main path] counts {c4}")

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
        dc = float((q64 - qc).abs().max())
        print(f"  {n}^3 float64 fused vs staged c2c (cuFFT): {dc / scale:.3e} max|Q| (tol 1e-12)")
        check(dc <= 1e-12 * scale, f"{n}^3 fused vs c2c {dc / scale:.3e} max|Q|")
        del qc, coll_c, pre_c

    # ---- 5. inhomogeneous main path (K3) -------------------------------
    # The CLIs' defaults: 16^3 velocities, Ns=12, CFL time step, MUSCL.
    tg = dict(u0=0.8, temperature=3.0, length=1.0)
    solvers = {}
    finals = {}  # (dtype, run) -> the run's last state
    c5 = {}
    for dtype in ("float64", "float32"):
        cfg = bt.CollisionConfig(nv=16, ns=12, impl="fused", dtype=dtype)
        collide, pre = bt.make_collision_operator(cfg, device="cuda")
        g = cfg.velocity_grid
        vmax = float(abs(g.v).max())
        d2, d3, dsod = 1.0 / 16, 1.0 / 8, 1.0 / 32
        step2 = transport.make_inhomogeneous_step_2d(
            cfg, collide, dx=d2, dy=d2, dt=transport.cfl_dt(vmax, d2), knudsen=0.2)
        step3 = transport.make_inhomogeneous_step_3d(
            cfg, collide, dx=d3, dy=d3, dz=d3, dt=transport.cfl_dt(vmax, d3), knudsen=0.2)
        step1 = transport.make_inhomogeneous_step(
            cfg, collide, dx=dsod, dt=transport.cfl_dt(vmax, dsod), knudsen=0.5)
        f2 = taylor_green_f0(cfg, 16, device=dev, **tg)
        f3 = taylor_green_f0_3d(cfg, 8, device=dev, **tg)
        f1 = transport.sod_initial_condition(cfg, 32, device=dev)
        dv3 = g.cell_volume
        solvers[dtype] = (cfg, collide, pre, step2, f2)
        runs = [("TG-2D 16x16 cells, 10 steps", step2, f2, 10, d2 * d2),
                ("TG-3D 8^3 cells, 2 steps", step3, f3, 2, d3 ** 3),
                ("Sod 32 cells, 5 steps", step1, f1, 5, dsod)]
        for label, step, f0, steps, cell_vol in runs:
            reset_counts(k1, k3)
            f, mass, h = run_cells(step, pre, f0, steps, dv3, cell_vol)
            c = counts(k1, k3)
            c5[(dtype, label)] = c
            finals[(dtype, label.split(",")[0])] = f
            check(tuple(f.shape) == tuple(f0.shape), f"{label}: shape {tuple(f.shape)}")
            gates(f"{dtype} {label}", f, mass, h)
            print(f"    counts {c}")
            check(c["k3"] == 2 * steps and c["k3_plain"] == 0 and c["k1"] == 0
                  and c["k1_plain"] == 0, f"{dtype} {label}: dispatch {c}")
    cfg, collide, pre, step2, f2 = solvers["float64"]
    cfg_c = bt.CollisionConfig(nv=16, ns=12, impl="c2c")
    coll_c, pre_c = bt.make_collision_operator(cfg_c, device="cuda")
    d2 = 1.0 / 16
    step_c = transport.make_inhomogeneous_step_2d(
        cfg_c, coll_c, dx=d2, dy=d2, dt=transport.cfl_dt(float(abs(cfg.velocity_grid.v).max()), d2),
        knudsen=0.2)
    a, b = step2(f2, pre), step_c(f2, pre_c)
    d = max_rel(a, b)
    print(f"  float64 TG-2D step, K3 route vs staged c2c (cuFFT): {d:.3e} relative (tol 1e-12)")
    check(d <= 1e-12, f"TG-2D step vs c2c {d:.3e}")
    del coll_c, pre_c, step_c

    # ---- 6. determinism and dispatch -----------------------------------
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
        print(f"[6 determinism] K1 {dtype} 32^3: run-to-run bitwise equal, batched == per-item bitwise")
        cfg, collide, pre, step2, f2 = solvers[dtype]
        check(torch.equal(step2(f2, pre), step2(f2, pre)), f"{dtype}: two TG-2D steps differ")
        cells = f2.reshape(-1, *f2.shape[2:])
        qb = collide(cells, pre)
        one = torch.stack([collide(x, pre) for x in cells])
        check(torch.equal(qb, one), f"{dtype}: 256-cell collide != per-cell collides")
        print(f"[6 determinism] K3 {dtype}: two TG-2D steps bitwise equal;"
              f" 256-cell collide == {len(cells)} per-cell collides bitwise")
        # the other main-path batches: TG-3D's 512 cells (98,304 stream
        # grids, past the 65,535 gridDim.y/z limit) and Sod's 32
        for run in ("TG-3D 8^3 cells", "Sod 32 cells"):
            cells = finals[(dtype, run)].reshape(-1, *f2.shape[2:])
            err, _ = k3_batch_parity(op, k3, cfg, pre, cells, run)
            max_err[("k3", dtype)] = max(max_err.get(("k3", dtype), 0.0), err)
            qb = collide(cells, pre)
            one = torch.stack([collide(x, pre) for x in cells])
            check(torch.equal(qb, one), f"{dtype}: {run} collide != per-cell collides")
            print(f"[6 determinism] K3 {dtype}: {run}: {len(cells)}-cell collide =="
                  f" {len(cells)} per-cell collides bitwise")
    check(c4["k1"] > 0 and all(launches[k] > 0 for k in launches),
          f"homogeneous main path launched K1 {launches}")
    check(c4["k1_plain"] == 0 and c4["k3_plain"] == 0,
          f"homogeneous main path called a plain version {c4}")
    print(f"[6 dispatch] homogeneous path {c4}; inhomogeneous paths: K3 launched 2 per step,"
          " K1 and both plain versions 0 times")

    # ---- 7. times ------------------------------------------------------
    times = {}
    kernels = []

    def report(label, ms, unit="eval"):
        rates = [1e3 / t for t in ms]
        print(f"[7 time] {label}: mean {statistics.mean(ms):.4f} ms/{unit}"
              f" (mean {statistics.mean(rates):.4f} min {min(rates):.4f}"
              f" stdev {statistics.stdev(rates):.4f} {unit}s/s, {TRIALS} trials) | {card}")

    for n in (32, 64):
        for dtype in ("float32", "float64"):
            cfg = bt.CollisionConfig(nv=n, ns=12, impl="fused", dtype=dtype)
            pre = bt.build_precomp(cfg, dev)
            _, _, f = bkw(bt, cfg, dev)
            args, kw = k1_inputs(op, cfg, pre, f)
            for label, fn in (("kernel", k1.fused_collide), ("plain", k1.fused_collide_reference)):
                ms = time_ms(lambda: fn(*args, **kw))
                times[("k1", n, dtype, label)] = ms
                report(f"K1 {n}^3 Ns=12 {dtype} {label}", ms)
    tg2d = {}
    for dtype in ("float32", "float64"):
        cfg, collide, pre, step2, f2 = solvers[dtype]
        cells = f2.reshape(-1, *f2.shape[2:])
        err, (args, kw) = k3_batch_parity(op, k3, cfg, pre, cells, "TG-2D")
        max_err[("k3", dtype)] = max(max_err[("k3", dtype)], err)
        ms_k3 = time_ms(lambda: k3.fused_gain_kron(*args, **kw))
        ms_plain = time_ms(lambda: k3.fused_gain_kron_reference(*args, **kw))
        cfg1 = bt.CollisionConfig(nv=16, ns=12, impl="fused", fused_scheme="ct", dtype=dtype)
        args1, kw1 = k1_inputs(op, cfg1, bt.build_precomp(cfg1, dev), cells)
        ms_k1 = time_ms(lambda: k1.fused_collide(*args1, **kw1))
        ms_step = time_ms(lambda: step2(f2, pre))
        for label, ms, unit in (("K3 kernel", ms_k3, "call"), ("K3 plain", ms_plain, "call"),
                                ("K1 kernel (whole Q)", ms_k1, "call"), ("TG-2D step", ms_step, "step")):
            report(f"{label} on the TG-2D batch, 256 x 16^3 Ns=12 {dtype}", ms, unit)
        tg2d[dtype] = dict(k3=ms_k3, plain=ms_plain, k1=ms_k1, step=ms_step,
                           batch=cells.shape[0], nodes=pre.rho.shape[0],
                           groups=-(-pre.rho.shape[0] // cfg.ns_eff))

    # where a TG-2D step's device time goes
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
        fam = {"K3 y/z GEMM (kron_gemm)": 0.0, "K3 x leg, group sum, beta1": 0.0,
               "cuFFT": 0.0, "elementwise (advection, RK2, casts)": 0.0}
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            t = getattr(e, "self_device_time_total", None)
            t = t if t is not None else e.self_cuda_time_total
            nm = e.key.lower()
            if "kron_gemm" in nm:
                fam["K3 y/z GEMM (kron_gemm)"] += t
            elif any(s in nm for s in ("axis_dft", "group_sum", "beta1_acc")) or "memset" in nm:
                fam["K3 x leg, group sum, beta1"] += t
            elif "fft" in nm:
                fam["cuFFT"] += t
            else:
                fam["elementwise (advection, RK2, casts)"] += t
        busy = sum(fam.values())
        parts = ", ".join(f"{k} {v / 3e3:.3f} ms ({100 * v / busy:.1f}%)" for k, v in fam.items())
        print(f"[7 profile] TG-2D step {dtype}, 3 steps: device {busy / 3e3:.3f} ms/step of"
              f" {wall_us / 3e3:.3f} ms/step wall; idle share {100 * (1 - busy / wall_us):.1f}% | {card}")
        print(f"  {parts}")
        print(f"  the 4 MUSCL half-steps alone (CUDA events): {statistics.mean(ms_adv):.4f} ms/step")

    for dtype in ("float64", "float32"):
        for n in (32, 64):
            cfg = bt.CollisionConfig(nv=n, ns=12, impl="fused", dtype=dtype)
            csize = 8 if dtype == "float64" else 4
            n3 = n ** 3
            b_ms, b_by = bound(k1_flops((n, n, n), cfg.n_nodes, cfg.n_gl),
                               csize * n3 * 4, dtype)  # f, beta2, |l| in; Q out
            kernels.append({
                "name": f"fused_collide[{dtype},{n}^3,Ns=12]",
                "route": "cuda",
                "source": "boltzfft_torch/csrc/fused_collide.cu",
                "replaces": "boltzfft/pallas_kernels.py:515",
                "launches": launches[("k1", dtype, n)],
                "max_abs_err": max_err[("k1", dtype, n)],
                "ms": statistics.mean(times[("k1", n, dtype, "kernel")]),
                "plain_ms": statistics.mean(times[("k1", n, dtype, "plain")]),
                "bound_ms": b_ms,
                "bound_by": b_by,
                "library_ms": None,
            })
    for dtype in ("float64", "float32"):
        t = tg2d[dtype]
        csize = 8 if dtype == "float64" else 4
        n3, nyz, e, b, groups = 4096, 256, t["batch"], t["nodes"], t["groups"]
        nbytes = (2 * e * n3 * 2 * csize  # f_hat in, Q_gain_hat out
                  + (2 * nyz * nyz + b * (16 + nyz) + 2 * 16 * 16) * 2 * csize
                  + (n3 + 2 * b) * csize)
        flops = k3_flops((16, 16, 16), b, groups, batch=e)
        b_ms, b_by = bound(flops, nbytes, dtype)
        kernels.append({
            "name": f"fused_gain_kron[{dtype},TG-2D {e}x16^3,Ns=12]",
            "route": "cuda",
            "source": "boltzfft_torch/csrc/fused_gain_kron.cu",
            "replaces": "boltzfft/pallas_kernels.py:221",
            "launches": sum(c["k3"] for (dt, _), c in c5.items() if dt == dtype),
            "max_abs_err": max_err[("k3", dtype)],
            "ms": statistics.mean(t["k3"]),
            "plain_ms": statistics.mean(t["plain"]),
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None,
        })
        kron = k3_kron_flops((16, 16, 16), b, groups, batch=e)
        ms = statistics.mean(t["k3"])
        print(f"[7 bound] K3 {dtype} TG-2D batch: {flops / 1e9:.2f} GFLOP separable,"
              f" {nbytes / 1e6:.1f} MB -> bound {b_ms:.4f} ms ({b_by}); measured {ms:.3f} ms"
              f" = {ms / b_ms:.1f}x the bound; K3's dense kron y/z product does"
              f" {kron / 1e9:.1f} GFLOP, {kron / (ms * 1e-3) / PEAK_FLOPS[dtype]:.1%}"
              " of the CUDA-core peak")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
