"""Time K1 (``kernels.fused_collide``) of a checkout of ``boltzfft_torch`` on
the card, Ns = 12 on the BKW state at t = 6.5: CUDA events around one eval
(median of ``--trials``, the wrapper's host time included), the profiler's
device time per eval of each of K1's kernels over ``--calls`` evals (the
node streams' y/z plane pass among them, alone), a hash of Q's bytes, and
the plane pass's bounds beside each other: the dense DMMA product's
arithmetic, the two-factor split's arithmetic and the streams' bytes, with
the eval's dense DMMA bound and the kGain x pass's dense arithmetic.
``--batch E`` evaluates E distributions in one launch (the TG-2D cells'
batch: ``--grids 16 --batch 256``).  Prints one JSON line per (grid, dtype).

    python3 tools/k1_ab.py [--root DIR] [--label NAME] [--grids 64 32]
        [--dtypes float64 float32] [--batch 1] [--trials 20] [--calls 5]

``--root`` names the directory that holds the ``boltzfft_torch`` package to
time (default: this checkout), so that two versions are timed in turns in
one call on one card: parent, change, change, parent.
"""

import argparse
import hashlib
import json
import math
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# Peaks of an H100 SXM at 700 W (NVIDIA's data sheet): device memory
# bytes/s, and the tensor cores' dense rates that K1's transforms run at:
# DMMA in float64, TF32 in float32, where 3xTF32 does 3 products for each
# one.
PEAK_BYTES = 3.35e12
PEAK_TC = {"float64": 67e12, "float32": 495e12}
TC_PASSES = {"float64": 1, "float32": 3}


def k1_flops(shape, n_nodes, n_groups, batch=1):
    """K1's arithmetic: every transform is a dense DFT along one axis,
    n3 * N_axis complex multiply-adds per axis, 8 FLOPs each; per eval the
    forward of f, 2 streams per node, one forward per group and the 2 final
    inverses (``csrc/fused_collide.cu``)."""
    n3 = shape[0] * shape[1] * shape[2]
    return batch * 8.0 * n3 * sum(shape) * (2 * n_nodes + n_groups + 3)


def plane_pass_bounds(n, n_nodes, dtype):
    """(dense ms, split ms or None, bytes ms) of K1's node-stream y/z plane
    pass per eval at n^3: 2 B grids, 2 axes at n complex multiply-adds a
    point as dense products, 2 sqrt(n) as the two-factor split (only where n
    is a square), 8 FLOPs each, on the tensor cores; each stream written
    once (its input, f_hat, stays in L2)."""
    flops = 2 * n_nodes * 2 * n ** 3 * 8.0
    r = math.isqrt(n)
    t = lambda macs: 1e3 * TC_PASSES[dtype] * flops * macs / PEAK_TC[dtype]  # noqa: E731
    csize = 16 if dtype == "float64" else 8
    return t(n), (t(2 * r) if r * r == n else None), 1e3 * 2 * n_nodes * n ** 3 * csize / PEAK_BYTES


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--label", default="this")
    ap.add_argument("--grids", type=int, nargs="+", default=[64])
    ap.add_argument("--dtypes", nargs="+", default=["float64", "float32"])
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--trials", type=int, default=20)
    ap.add_argument("--calls", type=int, default=5)
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    import torch

    import boltzfft_torch as bt
    from boltzfft_torch import operator as op
    from boltzfft_torch.kernels import fused_collide as k1

    if not torch.cuda.is_available():
        raise SystemExit("k1_ab: no card")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()

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
        return out

    def device_per_eval(fn):
        """{kernel: device ms per eval} over ``args.calls`` evals; the
        profiler can miss a window's kernels, so up to three windows."""
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        for _ in range(3):
            with torch.profiler.profile(activities=acts) as prof:
                for _ in range(args.calls):
                    fn()
                torch.cuda.synchronize()
            by = {}
            for e in prof.key_averages():
                if e.device_type == torch.autograd.DeviceType.CUDA:
                    t = getattr(e, "self_device_time_total", None) or e.self_cuda_time_total
                    by[e.key] = by.get(e.key, 0.0) + t / args.calls / 1e3
            if any("plane_dft_kernel" in k or "line_dft_kernel" in k for k in by):
                return by
        return None

    for n in args.grids:
        for dtype in args.dtypes:
            cfg = bt.CollisionConfig(nv=n, ns=12, impl="fused", dtype=dtype)
            pre = bt.build_precomp(cfg, dev)
            f = torch.as_tensor(bt.bkw_f(cfg.velocity_grid.r_squared(), 6.5),
                                dtype=cfg.real_dtype, device=dev)
            if args.batch > 1:  # distinct items: f scaled per item
                scale = 1.0 + 1e-3 * torch.arange(args.batch, dtype=cfg.real_dtype, device=dev)
                f = scale[:, None, None, None] * f
            ax, ay, az = op._alpha_factors(cfg, pre, pre.rho, pre.sigma)
            k1_args = (pre.rho, pre.gain_w, ax, ay, az, f, pre.beta2,
                       pre.dft_inv_axes(), pre.dft_fwd_axes(), pre.norm_l)
            kw = dict(length=cfg.domain_length, b_gamma=cfg.b_gamma, radial_group=cfg.ns_eff)
            run = lambda: k1.fused_collide(*k1_args, **kw)  # noqa: E731
            q = run()
            torch.cuda.synchronize()
            ms = events_ms(run)
            by = device_per_eval(run)
            n_nodes = pre.rho.shape[0]
            E = args.batch
            dense, split, nbytes = (None if v is None else E * v
                                    for v in plane_pass_bounds(n, n_nodes, dtype))
            plane = None if by is None else {k: v for k, v in by.items() if "plane_dft_kernel" in k}
            streams = None if not plane else max(plane.values())  # the streams' pass
            plan = getattr(k1, "split_yz", None)
            line = {
                "label": args.label, "grid": n, "batch": E, "dtype": dtype, "card": card,
                "eval_ms": statistics.median(ms), "eval_ms_quartiles":
                    [round(v, 5) for v in statistics.quantiles(ms, n=4)],
                "device_ms_per_eval": None if by is None else round(sum(by.values()), 5),
                "kernels_ms_per_eval": None if by is None else
                    {k: round(v, 5) for k, v in sorted(by.items(), key=lambda kv: -kv[1])},
                "plane_pass_streams_ms": None if streams is None else round(streams, 5),
                "split_yz": plan((n, n, n), cfg.real_dtype) if plan else "dense",
                "bounds_ms": {"eval_dense": round(1e3 * TC_PASSES[dtype] * k1_flops(
                                  (n, n, n), n_nodes, cfg.n_gl, E) / PEAK_TC[dtype], 4),
                              "x_gain_dense": round(1e3 * TC_PASSES[dtype] * E * 2 * n_nodes
                                                    * n ** 4 * 8.0 / PEAK_TC[dtype], 4),
                              "plane_pass_dense": round(dense, 4),
                              "plane_pass_split": None if split is None else round(split, 4),
                              "plane_pass_bytes": round(nbytes, 4)},
                "q_hash": hashlib.sha256(q.cpu().numpy().tobytes()).hexdigest()[:16],
            }
            print(json.dumps(line), flush=True)
            del pre, q
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
