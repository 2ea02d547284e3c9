"""Time K10 (``gmain12_nodemat``) and K11 (``hadamard_wsum``) of a checkout of
``boltzfft_torch`` on the card, at the shapes of the ds routes (32^3 and
64^3, Ns=12, BKW t = 6.5): K10 on the "12" route's nodes (C = 24 at 32^3,
4 at 64^3) at each z block that fits, K11 on two nodes of the full routes'
rolled streams.  Prints one JSON line per measurement: CUDA events around
one call (median of ``--trials``, the wrapper's host time included) and the
kernel's device time per launch from ``torch.profiler`` over 10 calls.

    python3 tools/ds_kernels_ab.py [--root DIR] [--label NAME] [--grids 32 64]

``--root`` names the directory that holds the ``boltzfft_torch`` package to
time (default: this checkout), so that two versions can be timed in turns
in one run on one card: parent, change, change, parent.
"""

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="this")
    ap.add_argument("--grids", type=int, nargs="+", default=[32, 64])
    ap.add_argument("--trials", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    import numpy as np
    import torch

    import boltzfft_torch as bt
    from boltzfft_torch import ds
    from boltzfft_torch import ds_operator as dso
    from boltzfft_torch import oz
    from boltzfft_torch.kernels import oz_gmain12 as k10
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

    def device_ms(fn, family, calls=10):
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        for _ in range(3):
            with torch.profiler.profile(activities=acts) as prof:
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
            t = n = 0
            for e in prof.key_averages():
                if e.device_type == torch.autograd.DeviceType.CUDA and family in e.key:
                    t += getattr(e, "self_device_time_total", None) or e.self_cuda_time_total
                    n += e.count
            if n:
                return t / n / 1e3
        return None

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
        gb = 2 if n <= 32 else 1
        take = (lambda t: tm(lambda a: a[:gb].reshape((-1,) + tuple(a.shape[2:])), t)) \
            if n <= 32 else (lambda t: tm(lambda a: a[0, :2], t))
        cat = lambda a, b: tm(lambda x, y: torch.cat((x, y)), a, b)
        m_y = cat(take(pre.pm1[1]), take(pre.pm2[1]))
        m_x = cat(take(pre.pm1[0]), take(pre.pm2[0]))
        c = m_y.re.shape[0]
        grid = cfg.grid_shape
        ref = k10.gmain12_nodemat(x_pre, m_y, m_x, grid, cmax=6, zh_block=1)
        for zb in [None, 1, 2, 4]:
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
            fn = lambda: k11.hadamard_wsum(a1, a2, w)
            print(json.dumps(dict(label=args.label, kernel="K11", n=n, c=2, layout=layout,
                                  events_ms=events_ms(fn),
                                  device_ms=device_ms(fn, "hadamard"), card=card)), flush=True)
        del pre
        torch.cuda.empty_cache()
    return 0


def ds_leaves(x):
    return [x.re.hi, x.re.lo, x.im.hi, x.im.lo]


if __name__ == "__main__":
    raise SystemExit(main())
