"""Time the ds kernels K7 (the half path's preslice step), K10
(``gmain12_nodemat``), K11 (``hadamard_wsum``) and K12
(``hadamard_wsum_half``), the default ds eval, and (on its own flag) K5
(``gain_reduce``) of a checkout of ``boltzfft_torch`` on the card, at the
shapes of their routes (32^3 and 64^3, Ns=12, BKW t = 6.5): K10 on the "12"
route's nodes (C = 24 at 32^3, 4 at 64^3) at each z block that fits, K11
on two nodes of the full routes' rolled streams, K12 on the default
route's call (gb = 2 and 12 nodes a stream at 32^3, gb = 1 and 2 nodes at
64^3: the eval's real planes, random main blocks), K7's step as the
checkout's ``collide_ds`` runs it (f_hat's half-z spectrum, masked and
swapped, cut into merged chunks: its launches, events and device time), the
whole default ds eval through ``make_ds_collision_operator`` (replayed from a
CUDA graph where the checkout honours ``jit=True``) and through
``collide_ds`` (eager), each with its wall time, the profiler's device time,
launches and idle share, a hash of its hi and lo bytes, K5 on the rfft +
use_pallas route's node
chunk in float64 and float32, and (``k6``) K6 on that route's first node
chunk in float64 and float32 (events, device time, a hash of its output),
its two inverse transforms as two ``irfftn`` calls and as one over the
stacked 2B grids, and the route's whole eval, eager (``collide``) and
through ``make_collision_operator`` (replayed from a CUDA graph where the
checkout's factory takes ``jit``): wall, device time, idle share,
launches and a hash of Q.  Prints one JSON line per measurement: CUDA
events around one call (median of ``--trials``, the wrapper's host time
included) and the kernel's device time per call from ``torch.profiler``
over 10 calls.

    python3 tools/ds_kernels_ab.py [--root DIR] [--label NAME] [--grids 32 64]
        [--parts k7 k10 k11 k12 eval k5 k6]

``--root`` names the directory that holds the ``boltzfft_torch`` package to
time (default: this checkout), so that two versions can be timed in turns
in one run on one card: parent, change, change, parent.  ``--parts``
chooses what to time (default: ``k7 k10 k11 k12 eval``; K5 only when
named; K6 likewise).
"""

import argparse
import hashlib
import inspect
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


EVAL_TRIALS = 5  # whole ds evals timed after 2 warm-ups


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="this")
    ap.add_argument("--grids", type=int, nargs="+", default=[32, 64])
    ap.add_argument("--trials", type=int, default=20)
    ap.add_argument("--parts", nargs="+", default=["k7", "k10", "k11", "k12", "eval"],
                    choices=["k7", "k10", "k11", "k12", "eval", "k5", "k6"])
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    import numpy as np
    import torch

    import boltzfft_torch as bt
    from boltzfft_torch import ds
    from boltzfft_torch import ds_operator as dso
    from boltzfft_torch import operator as op
    from boltzfft_torch import oz
    from boltzfft_torch.kernels import alpha_multiply as k6
    from boltzfft_torch.kernels import gain_reduce as k5
    from boltzfft_torch.kernels import oz_gmain12 as k10
    from boltzfft_torch.kernels import oz_hadamard as k12
    from boltzfft_torch.kernels import oz_hadamard_full as k11
    from boltzfft_torch.kernels import oz_preslice as k7

    if not torch.cuda.is_available():
        raise SystemExit("ds_kernels_ab: no card")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    tm = ds.tree_map

    def events_ms(fn):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(args.trials):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            out.append(a.elapsed_time(b))
        return statistics.median(out)

    def profile(fn, calls):
        """(device us, launches) by kernel name over ``calls`` calls, and the
        wall us of the window."""
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e6
        by = {}
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                t = getattr(e, "self_device_time_total", None) or e.self_cuda_time_total
                v = by.setdefault(e.key, [0.0, 0])
                v[0] += t
                v[1] += e.count
        return by, wall

    def device_ms(fn, family, calls=10, per="launch"):
        """The device ms per launch (or per call, ``per="call"``) of the
        kernels whose names hold ``family``; None if the profiler saw none."""
        for _ in range(3):
            by, _ = profile(fn, calls)
            hits = [v for k, v in by.items() if family in k]
            if hits:
                t = sum(v[0] for v in hits)
                return t / (sum(v[1] for v in hits) if per == "launch" else calls) / 1e3
        return None

    def bits(q):
        return hashlib.sha256(q.hi.cpu().numpy().tobytes()
                              + q.lo.cpu().numpy().tobytes()).hexdigest()[:16]

    for n in args.grids:
        cfg = bt.CollisionConfig(nv=n, ns=12, impl="c2c", dtype="float32")
        pre = dso.build_ds_precomp(cfg, device=dev)
        f = ds.from_f64(bt.bkw_f(cfg.velocity_grid.r_squared(), 6.5), torch.float32, dev)
        f_hat = oz.transform3_oz(ds.cds_from_real(f), pre.vfwd_sl, cmax=6, real_in=True)
        kxy = torch.ones(n, device=dev)
        kxy[n // 2] = 0.0
        fmask = kxy[:, None, None] * kxy[None, :, None]
        fhs = ds._swap_last2(tm(lambda a: a[..., : n // 2] * fmask, f_hat))
        x_pre = k7.preslice_rows(fhs, cmax=6, merged=True)
        if "k7" in args.parts:
            if hasattr(k7, "preslice_half"):
                step = lambda: k7.preslice_half(f_hat, fmask[:, :, 0], cmax=6, merged=True)
            else:  # the step as the parent's collide_ds ran it
                def step():
                    keep = dso._f32(np.arange(n) != n // 2, dev)
                    m3 = keep[:, None, None] * keep[None, :, None]
                    x = ds._swap_last2(tm(lambda a: a[..., : n // 2] * m3, f_hat))
                    return k7.preslice_rows(x, cmax=6, merged=True)
            by, _ = profile(step, 1)
            print(json.dumps(dict(label=args.label, kernel="K7 step", n=n,
                                  bits=hashlib.sha256(step().full.cpu().view(torch.int16).numpy()
                                                      .tobytes()).hexdigest()[:16],
                                  launches=sum(v[1] for v in by.values()),
                                  events_ms=events_ms(step),
                                  device_ms=device_ms(step, "", per="call"),
                                  k7_device_ms=device_ms(step, "preslice_kernel"),
                                  card=card)), flush=True)
        gb = 2 if n <= 32 else 1
        take = (lambda t: tm(lambda a: a[:gb].reshape((-1,) + tuple(a.shape[2:])), t)) \
            if n <= 32 else (lambda t: tm(lambda a: a[0, :2], t))
        cat = lambda a, b: tm(lambda x, y: torch.cat((x, y)), a, b)
        m_y = cat(take(pre.pm1[1]), take(pre.pm2[1]))
        m_x = cat(take(pre.pm1[0]), take(pre.pm2[0]))
        c = m_y.re.shape[0]
        grid = cfg.grid_shape
        ref = k10.gmain12_nodemat(x_pre, m_y, m_x, grid, cmax=6, zh_block=1)
        for zb in [None, 1, 2, 4] if "k10" in args.parts else []:
            if zb is not None and (n // 2) % zb:
                continue
            fn = lambda: k10.gmain12_nodemat(x_pre, m_y, m_x, grid, cmax=6, zh_block=zb)
            try:
                out = fn()
            except (ValueError, RuntimeError) as exc:
                print(json.dumps(dict(label=args.label, kernel="K10", n=n, c=c, zb=zb,
                                      error=str(exc)[:120])), flush=True)
                continue
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(ds_leaves(out), ds_leaves(ref)))
            print(json.dumps(dict(label=args.label, kernel="K10", n=n, c=c, zb=zb, same=same,
                                  events_ms=events_ms(fn), device_ms=device_ms(fn, "gmain12_kernel"),
                                  card=card)), flush=True)
        rng = np.random.default_rng(5)
        z = lambda: rng.standard_normal((2, n, n, n)) + 1j * rng.standard_normal((2, n, n, n))
        g1, g2 = (ds._roll_axis(ds.cds_from_f64(z(), torch.float32, dev), -1, -3) for _ in range(2))
        w = ds.from_f64(rng.uniform(0.5, 1.5, 2), torch.float32, dev)
        for layout, (a1, a2) in (("rolled", (g1, g2)),
                                 ("contiguous", tuple(tm(lambda t: t.contiguous(), g) for g in (g1, g2)))):
            if "k11" not in args.parts:
                break
            fn = lambda: k11.hadamard_wsum(a1, a2, w)
            print(json.dumps(dict(label=args.label, kernel="K11", n=n, c=2, layout=layout,
                                  events_ms=events_ms(fn),
                                  device_ms=device_ms(fn, "hadamard_"), card=card)), flush=True)
        if "k12" in args.parts:
            # the default route's call: the eval's planes (py, pz transposed),
            # random main blocks, w = None
            ck = dso._corr_ck(6, 7, None)
            corr = [dso._nyq_corrections(cfg, pre, f_hat, ck, conj=cj) for cj in (False, True)]
            half = c // 2
            r1, r2 = (ds.from_f64(rng.standard_normal((half,) + grid), torch.float32, dev)
                      for _ in range(2))
            signs = tuple(torch.as_tensor((-1.0) ** np.arange(n), dtype=torch.float32,
                                          device=dev) for _ in range(3))
            hargs = (r1, take(corr[0]), r2, take(corr[1]), None, grid, signs)
            fn = lambda: k12.hadamard_wsum_half(*hargs, groups=gb)
            out = fn()
            print(json.dumps(dict(label=args.label, kernel="K12", n=n, gb=gb, c=half,
                                  bits=bits(out), events_ms=events_ms(fn),
                                  device_ms=device_ms(fn, "hwh_kernel"), card=card)), flush=True)
        if "eval" in args.parts:
            collide, pre_e = bt.make_ds_collision_operator(cfg, device=dev)
            evals = (("ds eval", lambda: collide(f, pre_e)),
                     ("ds eval eager", lambda: dso.collide_ds(cfg, pre_e, f, contract="oz")))
            for name, ev in evals:
                for _ in range(2):
                    q = ev()
                torch.cuda.synchronize()
                walls = []
                for _ in range(EVAL_TRIALS):
                    t0 = time.perf_counter()
                    ev()
                    torch.cuda.synchronize()
                    walls.append((time.perf_counter() - t0) * 1e3)
                by, wall = profile(ev, 1)
                busy = sum(v[0] for v in by.values())
                k12_dev = sum(v[0] for k, v in by.items() if "hwh_kernel" in k)
                k12_n = sum(v[1] for k, v in by.items() if "hwh_kernel" in k)
                print(json.dumps(dict(label=args.label, kernel=name, n=n, bits=bits(q),
                                      wall_ms=statistics.median(walls), walls_ms=walls,
                                      profiled_wall_ms=wall / 1e3, device_ms=busy / 1e3,
                                      idle_share=1 - busy / wall,
                                      launches=sum(v[1] for v in by.values()),
                                      k12_device_ms=k12_dev / 1e3, k12_launches=k12_n,
                                      card=card)), flush=True)
            del collide, pre_e, evals
        del pre
        torch.cuda.empty_cache()
        if "k5" in args.parts:
            for dtype in ("float64", "float32"):
                cfg5 = bt.CollisionConfig(nv=n, ns=12, impl="rfft", use_pallas=True, dtype=dtype)
                pre5 = bt.build_precomp(cfg5, dev)
                b = pre5.rho.shape[0]
                h = torch.randn((b, n * n * (n // 2 + 1)), dtype=cfg5.complex_dtype, device=dev)
                kw = dict(length=cfg5.domain_length, b_gamma=cfg5.b_gamma)
                fn = lambda: k5.gain_reduce(h, pre5.rho, pre5.gain_w, pre5.norm_l.reshape(-1), **kw)
                print(json.dumps(dict(label=args.label, kernel="K5", n=n, dtype=dtype, b=b,
                                      m=h.shape[1], events_ms=events_ms(fn),
                                      device_ms=device_ms(fn, "_kernel", per="call"),
                                      card=card)), flush=True)
                del h, pre5
                torch.cuda.empty_cache()
        if "k6" in args.parts:
            for dtype in ("float64", "float32"):
                k6_part(args, bt, op, k6, n, dtype, dev, card, events_ms, device_ms, profile)
    return 0


def k6_part(args, bt, op, k6, n, dtype, dev, card, events_ms, device_ms, profile):
    """K6 on the rfft + use_pallas route's first node chunk, the chunk's two
    inverse transforms (two calls, one over 2B grids) and the route's whole
    eval, eager and graphed where the factory takes ``jit``."""
    import torch

    def digest(*ts):
        return hashlib.sha256(b"".join(t.cpu().numpy().tobytes() for t in ts)).hexdigest()[:16]

    cfg = bt.CollisionConfig(nv=n, ns=12, impl="rfft", use_pallas=True, dtype=dtype)
    pre = bt.build_precomp(cfg, dev)
    f = torch.as_tensor(bt.bkw_f(cfg.velocity_grid.r_squared(), 6.5), dtype=cfg.real_dtype,
                        device=dev)
    b = pre.rho.shape[0]
    c = min(cfg.chunk(dev), b)
    while b % c:
        c -= 1
    nh = n // 2 + 1
    fh = torch.fft.rfftn(f, dim=(-3, -2, -1)).reshape(n, -1)
    ax, ay, az = op._alpha_factors(cfg, pre, pre.rho[:c], pre.sigma[:c])
    k6_args = (ax, (ay[:, :, None] * az[:, None, :]).reshape(c, -1), fh)
    fn = lambda: k6.alpha_multiply(*k6_args)
    a1f, a2f = fn()
    print(json.dumps(dict(label=args.label, kernel="K6", n=n, dtype=dtype, b=c,
                          bits=digest(a1f, a2f), events_ms=events_ms(fn),
                          device_ms=device_ms(fn, "alpha_multiply_kernel", per="call"),
                          card=card)), flush=True)
    if hasattr(k6, "plan"):  # the entry takes its launch as given: sweep nb and the block
        m2 = fh.shape[1]
        p = k6.plan(c, n, m2, fh.element_size(), True)
        out = torch.empty((2, c, n, m2), dtype=fh.dtype, device=dev)
        ref = torch.stack((a1f, a2f))
        for threads in (128, 256):
            for nb in (1, 2, 4, 8, 16):
                sweep = lambda: k6._entry(fh.dtype)(
                    k6_args[0].data_ptr(), k6_args[1].data_ptr(), fh.data_ptr(),
                    out.data_ptr(), c, n, m2, p.vec, threads, nb,
                    torch.cuda.current_stream().cuda_stream)
                out.zero_()
                rc = sweep()
                torch.cuda.synchronize()
                print(json.dumps(dict(label=args.label, kernel="K6 launch sweep", n=n, dtype=dtype,
                                      vec=p.vec, threads=threads, nb=nb, plan_nb=p.nb, rc=rc,
                                      same_bits=torch.equal(out, ref),
                                      device_ms=device_ms(sweep, "alpha_multiply_kernel",
                                                          per="call"),
                                      card=card)), flush=True)
        del out, ref
    stacked = torch.stack((a1f, a2f)).reshape(2 * c, n, n, nh)
    two = lambda: [torch.fft.irfftn(a.reshape(c, n, n, nh), s=(n, n, n), dim=(-3, -2, -1))
                   for a in (a1f, a2f)]
    one = lambda: torch.fft.irfftn(stacked, s=(n, n, n), dim=(-3, -2, -1))
    same = torch.equal(one(), torch.cat(two()))
    for name, t in (("two irfftn", two), ("one irfftn over 2B", one)):
        print(json.dumps(dict(label=args.label, kernel=f"K6 chunk inverse, {name}", n=n,
                              dtype=dtype, b=c, same_bits=same, events_ms=events_ms(t),
                              device_ms=device_ms(t, "", per="call"), card=card)), flush=True)
    del stacked, a1f, a2f
    evals = [("rfft+pallas eval eager", lambda: bt.collide(cfg, pre, f))]
    if "jit" in inspect.signature(bt.make_collision_operator).parameters:
        collide, pre_g = bt.make_collision_operator(cfg, device=dev)
        evals.append(("rfft+pallas eval graphed", lambda: collide(f, pre_g)))
    for name, ev in evals:
        for _ in range(2):
            q = ev()
        torch.cuda.synchronize()
        walls = []
        for _ in range(EVAL_TRIALS):
            t0 = time.perf_counter()
            ev()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        by, wall = profile(ev, 1)
        busy = sum(v[0] for v in by.values())
        print(json.dumps(dict(label=args.label, kernel=name, n=n, dtype=dtype, bits=digest(q),
                              wall_ms=statistics.median(walls), walls_ms=walls,
                              profiled_wall_ms=wall / 1e3, device_ms=busy / 1e3,
                              idle_share=1 - busy / wall,
                              launches=sum(v[1] for v in by.values()),
                              k6_device_ms=sum(v[0] for k, v in by.items()
                                               if "alpha_multiply" in k) / 1e3,
                              card=card)), flush=True)
    del evals, pre
    torch.cuda.empty_cache()


def ds_leaves(x):
    return [x.re.hi, x.re.lo, x.im.hi, x.im.lo]


if __name__ == "__main__":
    raise SystemExit(main())
