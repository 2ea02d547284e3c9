"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device: a CUDA card must be present; prints its name and power limit;
2. build: compiles the port's CUDA kernels from ``boltzfft_torch/csrc``;
3. kernel against its plain PyTorch version on the card (float64 within
   1e-12 max|Q|; float32 within 1e-5 max|Q|, 4e-5 at 16^3, see ``TOL``);
4. the main path, ``make_collision_operator(CollisionConfig(nv=32|64, ns=12,
   impl="fused"))`` on the BKW distribution at t = 6.5, against the
   reference's error norms and the port's staged float64 c2c pipeline;
5. determinism (bitwise run to run and batched against per item) and
   dispatch (the main path launched the kernel and never its plain version);
6. times of the kernel and of its plain version (CUDA events).

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

SHAPES_PHASE3 = [  # (grid, ns, batch)
    ((16, 16, 16), 6, 1),
    ((32, 32, 32), 12, 1),
    ((32, 16, 48), 12, 1),
    ((16, 16, 16), 6, 2),
    ((64, 64, 64), 12, 1),
]
# |kernel - plain| in units of max|Q|.  float32 at 16^3: the gain and loss
# terms are ~30x max|Q| there and cancel, so each float32 version lies
# 1.5-1.7e-5 max|Q| from the float64 result and two of them can differ by the
# sum of that; from 32^3 on, 1e-5.
TOL = {"float64": 1e-12, "float32": 1e-5}
TOL_F32_16 = 4e-5
BKW_DIGITS = {  # reference f64 L1, L2, Linf at Ns=12 and the rtol they hold to
    32: ((1.5403e-03, 1.0119e-04, 4.2512e-05), 1e-4),
    64: ((8.9149e-11, 8.3092e-12, 3.0685e-12), 1e-3),
}
TRIALS = 10


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def k1_inputs(bt, op, cfg, pre, f):
    ax, ay, az = op._alpha_factors(cfg, pre, pre.rho, pre.sigma)
    args = (pre.rho, pre.gain_w, ax, ay, az, f, pre.beta2,
            pre.dft_inv_axes(), pre.dft_fwd_axes(), pre.norm_l)
    kw = dict(length=cfg.domain_length, b_gamma=cfg.b_gamma, radial_group=cfg.ns_eff)
    return args, kw


def bkw(bt, cfg, dev):
    g = cfg.velocity_grid
    rsq = g.r_squared()
    f = torch.as_tensor(bt.bkw_f(rsq, 6.5), dtype=cfg.real_dtype, device=dev)
    return g, rsq, f


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
    from boltzfft_torch.kernels import fused_collide as k1

    # ---- 2. build ------------------------------------------------------
    t0 = time.perf_counter()
    _build.load_library()
    print(f"[2 build] {_build.LIB_PATH} in {time.perf_counter() - t0:.1f} s")
    for line in _build.BUILD_LOG.read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())

    # ---- 3. kernel against its plain version on the card ---------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("[3 parity] torch.backends.cuda.matmul.allow_tf32 ="
          f" {torch.backends.cuda.matmul.allow_tf32},"
          f" torch.backends.cudnn.allow_tf32 = {torch.backends.cudnn.allow_tf32}")
    max_err = {}  # (dtype, n) -> max |kernel - plain| at the main-path shapes
    for dtype in ("float64", "float32"):
        for shape, ns, batch in SHAPES_PHASE3:
            cfg = bt.CollisionConfig(nv=shape[0], nvy=shape[1], nvz=shape[2],
                                     ns=ns, impl="fused", dtype=dtype)
            pre = bt.build_precomp(cfg, dev)
            _, _, f = bkw(bt, cfg, dev)
            if batch == 2:
                f = torch.stack([f, 0.8 * f])
            args, kw = k1_inputs(bt, op, cfg, pre, f)
            q = k1.fused_collide(*args, **kw)
            q_ref = k1.fused_collide_reference(*args, **kw)
            torch.cuda.synchronize()
            err = float((q - q_ref).abs().max())
            scale = float(q_ref.abs().max())
            tol = TOL_F32_16 if dtype == "float32" and max(shape) < 32 else TOL[dtype]
            ok = bool(torch.isfinite(q).all()) and err <= tol * scale
            print(f"  {dtype} grid {shape} ns {ns} E {batch}: max|dQ| {err:.3e}"
                  f" = {err / scale:.3e} max|Q| (tol {tol:g}) {'ok' if ok else 'FAIL'}")
            check(ok, f"kernel != plain version at {dtype} {shape} ns={ns} E={batch}")
            if shape[0] == shape[1] == shape[2] and ns == 12 and batch == 1:
                max_err[(dtype, shape[0])] = err

    # ---- 4. main path --------------------------------------------------
    k1.LAUNCHES = 0
    k1.REFERENCE_CALLS = 0
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
            launches[(dtype, n)] = k1.LAUNCHES - before
    n_launch, n_ref = k1.LAUNCHES, k1.REFERENCE_CALLS
    print(f"[4 main path] kernel launches {n_launch}, plain-version calls {n_ref}")

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

    # ---- 5. determinism and dispatch -----------------------------------
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
        print(f"[5 determinism] {dtype} 32^3: run-to-run bitwise equal, batched == per-item bitwise")
    check(n_launch > 0 and all(v > 0 for v in launches.values()),
          f"main path launched the kernel {launches}")
    check(n_ref == 0, f"main path called the plain version {n_ref} times")
    print(f"[5 dispatch] LAUNCHES grew to {n_launch}; REFERENCE_CALLS stayed {n_ref}")

    # ---- 6. times ------------------------------------------------------
    times = {}
    for n in (32, 64):
        for dtype in ("float32", "float64"):
            cfg = bt.CollisionConfig(nv=n, ns=12, impl="fused", dtype=dtype)
            pre = bt.build_precomp(cfg, dev)
            _, _, f = bkw(bt, cfg, dev)
            args, kw = k1_inputs(bt, op, cfg, pre, f)
            for label, fn in (("kernel", k1.fused_collide), ("plain", k1.fused_collide_reference)):
                ms = time_ms(lambda: fn(*args, **kw))
                rates = [1e3 / t for t in ms]
                times[(n, dtype, label)] = ms
                print(f"[6 time] {n}^3 Ns=12 {dtype} {label:6s}: mean {statistics.mean(rates):.4f}"
                      f" min {min(rates):.4f} stdev {statistics.stdev(rates):.4f} evals/s"
                      f" ({statistics.mean(ms):.4f} ms/eval, {TRIALS} trials) | {card}")

    kernels = []
    for dtype in ("float64", "float32"):
        for n in (32, 64):
            kernels.append({
                "name": f"fused_collide[{dtype},{n}^3,Ns=12]",
                "route": "cuda",
                "source": "boltzfft_torch/csrc/fused_collide.cu",
                "replaces": "boltzfft/pallas_kernels.py:515",
                "launches": launches[(dtype, n)],
                "max_abs_err": max_err[(dtype, n)],
                "ms": statistics.mean(times[(n, dtype, "kernel")]),
                "plain_ms": statistics.mean(times[(n, dtype, "plain")]),
            })
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
