"""Example: the accuracy/cost ladder in float32 on the card.

Evaluates the same BKW configuration through each pipeline and prints
error against the float64 BKW rate and wall time, the menu a user picks
from:

  fused (default)   the whole eval in K1; its transforms on the tensor
                    cores in 3xTF32 (three TF32 products a float32 one)
  fused (highest)   the same kernel: on the card both tiers run 3xTF32 in
                    float32 (DMMA in float64)
  rfft              the staged cuFFT pipeline (K6/K5 only with use_pallas)
  ds                compensated double-single, float32 pairs: f64-class
                    digits from the Ozaki kernels K7-K12 on the bf16 tensor
                    cores (boltzfft_torch/ds_operator.py)

    python -m boltzfft_torch.examples.precision_ladder [--Nv 32] [--device cpu]
"""

import argparse
import sys

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--Nv", type=int, default=16)
    p.add_argument("--Ns", type=int, default=6)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (raises without a card) or cpu")
    args = p.parse_args(argv)

    import torch

    import boltzfft_torch as bt
    from boltzfft_torch import ds
    from boltzfft_torch.cli import open_device

    device = open_device(args.device)
    cfg0 = bt.CollisionConfig(nv=args.Nv, ns=args.Ns, dtype="float32")
    g = cfg0.velocity_grid
    rsq = g.r_squared()
    f64 = np.asarray(bt.bkw_f(rsq, 6.5), np.float64)
    q64 = np.asarray(bt.bkw_dfdt(rsq, 6.5), np.float64)

    # The compensated pipeline doubles as the f64-class oracle in float32:
    # its result separates arithmetic error from method error for every
    # other pipeline.
    collide_ds, pre_ds = bt.make_ds_collision_operator(cfg0, device=device)
    f_ds = ds.from_f64(f64, device=device)
    qex = ds.from_f64(q64, device=device)

    def run_ds():
        q = collide_ds(f_ds, pre_ds)
        d = ds.sub(q, qex)
        return q.hi + q.lo, torch.max(torch.abs(d.hi + d.lo))

    st, (q_ds, linf_ds) = bt.time_fn(run_ds, device=device, trials=1, warmup=1)
    dt_ds = st.mean
    q_ds = q_ds.cpu().numpy().astype(np.float64)

    print(f"{'pipeline':>16} {'Linf vs BKW':>12} {'arith error':>12} {'s/eval':>10}")
    print(f"{'':>16} {'(method+arith)':>12} {'(vs ds)':>12}")

    variants = [
        ("fused default", dict(impl="fused", fused_precision="default")),
        ("fused highest", dict(impl="fused", fused_precision="highest")),
        ("rfft", dict(impl="rfft")),
    ]
    for name, kw in variants:
        cfg = bt.CollisionConfig(nv=args.Nv, ns=args.Ns, dtype="float32", **kw)
        collide, pre = bt.make_collision_operator(cfg, device=device)
        f = torch.as_tensor(f64, dtype=torch.float32, device=device)
        st, q = bt.time_fn(collide, f, pre, device=device, trials=1, warmup=1)
        qn = q.cpu().numpy().astype(np.float64)
        print(f"{name:>16} {np.abs(qn - q64).max():12.4e} "
              f"{np.abs(qn - q_ds).max():12.4e} {st.mean:10.4f}")

    print(f"{'ds (compensated)':>16} {float(linf_ds):12.4e} {'oracle':>12} "
          f"{dt_ds:10.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
