"""Example: gradient-based parameter recovery through the collision operator.

Recovers the temperature of a Maxwellian from an observed collision rate by
differentiating THROUGH the operator: given Q_obs = Q(f(T*), f(T*)), minimize
``||Q(f(T)) - Q_obs||^2`` over T with Adam.  Works with every staged
pipeline and with ``impl="fused"`` on its K1 route, whose forward is the
hand-written kernel (``operator._FusedCollide``, a
``torch.autograd.Function`` whose backward is the staged c2c pipeline).
The operator is built with ``jit=False``: a replayed CUDA graph has no
backward.

    python -m boltzfft_torch.examples.adjoint_fit [--Nv 16 --impl fused] [--device cpu]
"""

import argparse
import math
import sys


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--Nv", type=int, default=16)
    p.add_argument("--Ns", type=int, default=6)
    p.add_argument("--impl", default="rfft",
                   choices=["rfft", "c2c", "dft", "fused"])
    p.add_argument("--steps", type=int, default=40)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (raises without a card) or cpu")
    args = p.parse_args(argv)

    import torch

    import boltzfft_torch as bt
    from boltzfft_torch.cli import open_device

    device = open_device(args.device)
    cfg = bt.CollisionConfig(nv=args.Nv, ns=args.Ns, n_radial=args.Nv // 2,
                             impl=args.impl, dtype="float32")
    collide, pre = bt.make_collision_operator(cfg, jit=False, device=device)
    g = cfg.velocity_grid
    rsq = torch.as_tensor(g.r_squared(), dtype=torch.float32, device=device)

    def maxwellian(temp):
        pref = 1.0 / (2.0 * math.pi * temp) ** 1.5
        return pref * torch.exp(-rsq / (2.0 * temp))

    t_true = 1.3
    with torch.no_grad():
        q_obs = collide(maxwellian(torch.tensor(t_true, device=device)), pre)

    def loss(temp):
        d = collide(maxwellian(temp), pre) - q_obs
        return torch.sum(d * d)

    # torch's Adam and optax.adam(5e-2) share their defaults: beta 0.9 /
    # 0.999, eps 1e-8 added to the bias-corrected square root
    temp = torch.tensor(0.7, dtype=torch.float32, device=device,
                        requires_grad=True)  # bad initial guess
    opt = torch.optim.Adam([temp], lr=5e-2)
    print(f"impl={args.impl}: recover T*={t_true} from Q_obs, start T={temp.item()}")
    with torch.no_grad():
        best_t, best_l = temp.item(), float(loss(temp))
    for i in range(args.steps):
        opt.zero_grad()
        loss(temp).backward()
        opt.step()
        with torch.no_grad():
            l = float(loss(temp))
        if l < best_l:  # near the f32 loss floor the iterates wander; keep
            best_t, best_l = temp.item(), l  # the best-loss iterate
        if (i + 1) % 10 == 0:
            print(f"  step {i+1:3d}: T = {temp.item():.6f}  loss = {l:.3e}")
    err = abs(best_t - t_true)
    print(f"recovered T = {best_t:.6f} (|error| = {err:.2e}, loss = {best_l:.3e})")
    return 0 if err < 2e-2 else 1  # coarse grids (Nv=8) bias the optimum ~1%


if __name__ == "__main__":
    sys.exit(main())
