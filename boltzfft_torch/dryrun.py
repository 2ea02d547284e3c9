"""The multi-device dry run: one sharded step of each operator family on an
``n_devices`` mesh (the counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``).

    python -m boltzfft_torch.dryrun 4 --device cpu     # 4 gloo ranks
    python -m boltzfft_torch.dryrun 8                  # 8 cards, NCCL

:func:`dryrun_multichip` starts ``n_devices`` ranks (a process each, joined
through a ``file://`` rendezvous in a temporary directory): on
``device="cuda"`` one card each over NCCL, which needs ``n_devices`` visible
cards; on ``device="cpu"`` gloo ranks.  It never switches from one to the
other.  The families, each printing its own ok line from rank 0:

* ``rfft``: the staged rfft operator, node-sharded (``all_reduce`` hook);
* ``fused``: the fused route on its kron scheme (K3 with the hook, then
  the c2c finale);
* ``ds``: the radial-sharded double-single operator (compensated fold);
* ``spatial2d`` / ``spatial3d``: the decomposed transport steps (halo
  exchanges between neighbouring ranks).

The mesh is ``(ensemble 2, node n/2)`` for an even ``n_devices``, else one
node dim; ``BOLTZFFT_DRYRUN_FAMILIES`` (comma separated) picks families.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist

FAMILIES = ("rfft", "fused", "ds", "spatial2d", "spatial3d")


def _say(text: str) -> None:
    if dist.get_rank() == 0:
        print(text, flush=True)


def _global_shape(mesh, f, axis):
    from .sharding import axis_size

    return (f.shape[0] * axis_size(mesh, axis),) + tuple(f.shape[1:])


def _dryrun_staged(mesh, ens_size, node_size, impl, fused_kwargs=None) -> None:
    """One sharded RK4 relaxation step of a staged or fused impl."""
    import boltzfft_torch as bt

    cfg = bt.CollisionConfig(nv=8, ns=6, n_radial=4, impl=impl, dtype="float64",
                             **(fused_kwargs or {}))
    node_axis = bt.NODE_AXIS if node_size > 1 else None
    ens_axis = bt.ENSEMBLE_AXIS if ens_size > 1 else None
    collide_fn, pre = bt.make_sharded_collision_operator(
        cfg, mesh, node_axis=node_axis, ensemble_axis=ens_axis, jit=False)
    pre = bt.place(pre, mesh, node_axis=node_axis)
    dev = bt.sharding.mesh_device(mesh)
    g = cfg.velocity_grid
    f0 = torch.as_tensor(bt.bkw_f(g.r_squared(), 6.5), dtype=cfg.real_dtype, device=dev)
    if ens_size > 1:
        f0 = torch.stack([f0] * 2)  # this rank's block of a (2 * ens, N, N, N) ensemble
    traj = bt.relax(lambda x: collide_fn(x, pre), f0, dt=0.05, n_steps=1, method="rk4",
                    record=lambda x: bt.moments(x, g.v, g.dv))
    f1, mass = traj.f, traj.recorded.mass
    assert f1.shape == f0.shape
    assert bool(torch.all(torch.isfinite(f1)))
    shape = _global_shape(mesh, f1, ens_axis) if ens_axis else tuple(f1.shape)
    _say(f"dryrun_multichip ok [{impl}]: mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))} "
         f"f={shape} mass={mass.cpu().numpy().ravel()[:2]}")


def _dryrun_ds(mesh, ens_size, node_size) -> None:
    """One radial-sharded double-single Euler step, with its compensated
    fold across ranks."""
    import boltzfft_torch as bt
    from boltzfft_torch import ds

    cfg = bt.CollisionConfig(nv=4, ns=6, n_radial=2 * max(node_size, 1), impl="c2c",
                             dtype="float32")
    dev = bt.sharding.mesh_device(mesh)
    radial_axis = bt.NODE_AXIS if node_size > 1 else None
    ens_axis = bt.ENSEMBLE_AXIS if ens_size > 1 else None
    collide_fn, pre = bt.make_sharded_ds_collision_operator(
        cfg, mesh, radial_axis=radial_axis, ensemble_axis=ens_axis, jit=False,
        contract="vpu" if dev.type == "cpu" else None, sub_batch=3)
    pre = bt.place_ds(pre, mesh, radial_axis=radial_axis)
    f_np = np.asarray(bt.bkw_f(cfg.velocity_grid.r_squared(), 6.5), np.float64)
    if ens_size > 1:
        f_np = np.stack([f_np] * 2)
    f0 = ds.from_f64(f_np, device=dev)
    q = collide_fn(f0, pre)
    f1 = ds.add(f0, ds.mul_f(q, torch.tensor(0.05, dtype=q.hi.dtype, device=dev)))
    assert f1.hi.shape == f0.hi.shape
    assert bool(torch.all(torch.isfinite(f1.hi + f1.lo)))
    shape = _global_shape(mesh, f1.hi, ens_axis) if ens_axis else tuple(f1.hi.shape)
    _say(f"dryrun_multichip ok [ds]: mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))} "
         f"f={shape} radial-sharded compensated fold")


def _spatial_step(mesh, names, deltas, make_step, label):
    """One decomposed Strang step of 2 cells per rank along each named dim."""
    import boltzfft_torch as bt
    from boltzfft_torch import transport

    cfg = bt.CollisionConfig(nv=8, ns=6, n_radial=2, impl="rfft", dtype="float32")
    dev = bt.sharding.mesh_device(mesh)
    coll, pre = bt.make_collision_operator(cfg, jit=False, device=dev)
    cells = tuple(2 * bt.sharding.axis_size(mesh, n) for n in names)
    base = transport.sod_initial_condition(cfg, 1, device="cpu").numpy()[0]
    rng = np.random.RandomState(0)
    lead = (None,) * len(cells)
    f = torch.as_tensor(base[lead] * (1.0 + 0.3 * rng.rand(*cells, 1, 1, 1)),
                        dtype=cfg.real_dtype)
    axes = dict(zip(("x_axis", "y_axis", "z_axis"), names))
    step = make_step(cfg, coll, mesh, *deltas, axes)
    f1 = step(bt.place_cells(f, mesh, **axes), pre)
    assert bool(torch.all(torch.isfinite(f1)))
    tot = torch.sum(f1.to(torch.float64)).reshape(1)
    dist.all_reduce(tot)
    tot0, tot1 = float(torch.sum(f.to(torch.float64))), float(tot)
    drift = abs(tot1 - tot0) / tot0
    assert drift < 2e-4, drift
    _say(f"dryrun_multichip ok [{label}]: mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))} "
         f"cells={cells} halo exchanges, rank-local FFTs, mass drift {drift:.1e}")


def _dryrun_spatial2d(mesh) -> None:
    """One 2D x 3V decomposed step, the (ensemble, node) mesh taken as the
    cell mesh."""
    from boltzfft_torch import transport

    names = tuple(mesh.mesh_dim_names[:2])
    _spatial_step(
        mesh, names, (0.25, 0.25),
        lambda cfg, coll, m, dx, dy, axes: transport.make_sharded_step_2d(
            cfg, coll, m, dx=dx, dy=dy, dt=0.01, **axes),
        "spatial2d")


def _dryrun_spatial3d(n_devices: int, device) -> None:
    """One 3D x 3V decomposed step on a cell mesh of up to three dims."""
    import boltzfft_torch as bt
    from boltzfft_torch import transport

    dims, n = [], n_devices
    for _ in range(2):
        if n % 2 == 0 and n > 1:
            dims.append(2)
            n //= 2
    dims.append(n)
    while len(dims) < 3:
        dims.append(1)
    mesh = bt.make_mesh(list(zip(("cx", "cy", "cz"), dims)), device=device)
    _spatial_step(
        mesh, ("cx", "cy", "cz"), (0.25, 0.25, 0.25),
        lambda cfg, coll, m, dx, dy, dz, axes: transport.make_sharded_step_3d(
            cfg, coll, m, dx=dx, dy=dy, dz=dz, dt=0.01, **axes),
        "spatial3d")


def _dryrun_body(n_devices: int, device) -> None:
    """The dry run on this rank; the process group must hold
    ``n_devices`` ranks."""
    import boltzfft_torch as bt

    if dist.get_world_size() < n_devices:
        raise RuntimeError(f"need {n_devices} ranks, have {dist.get_world_size()}")
    ens_size = 2 if (n_devices % 2 == 0 and n_devices >= 2) else 1
    node_size = n_devices // ens_size
    axes = [(bt.ENSEMBLE_AXIS, ens_size)] if ens_size > 1 else []
    axes.append((bt.NODE_AXIS, node_size))
    mesh = bt.make_mesh(axes, device=device)
    families = os.environ.get("BOLTZFFT_DRYRUN_FAMILIES", ",".join(FAMILIES)).split(",")
    if "rfft" in families:
        _dryrun_staged(mesh, ens_size, node_size, "rfft")
    if "fused" in families:
        _dryrun_staged(mesh, ens_size, node_size, "fused", {"fused_scheme": "kron"})
    if "ds" in families:
        _dryrun_ds(mesh, ens_size, node_size)
    if "spatial2d" in families:
        _dryrun_spatial2d(mesh)
    if "spatial3d" in families:
        _dryrun_spatial3d(n_devices, device)


def dryrun_multichip(n_devices: int, *, device="cuda", timeout: float = 900.0) -> None:
    """Run one sharded step of every family on ``n_devices`` ranks, each a
    process of its own; rank 0's lines are printed here.  ``device="cuda"``
    needs ``n_devices`` visible cards and raises otherwise;
    ``device="cpu"`` runs gloo ranks.  Raises if any rank fails."""
    device = torch.device(device)
    if device.type == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n_devices:
            raise RuntimeError(f"dryrun_multichip: need {n_devices} CUDA cards, have {have}")
    elif device.type != "cpu":
        raise ValueError(f"dryrun_multichip: device must be cuda or cpu, got {device}")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    with tempfile.TemporaryDirectory() as tmp:
        url = f"file://{os.path.join(tmp, 'rendezvous')}"
        procs = [
            subprocess.Popen(
                [sys.executable, "-m", "boltzfft_torch.dryrun", str(n_devices),
                 "--device", device.type, "--rank", str(r), "--init", url],
                cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(n_devices)
        ]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=timeout)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    sys.stdout.write(logs[0])
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise RuntimeError(
            f"dryrun_multichip: ranks {bad} failed:\n" + "\n".join(logs[r][-3000:] for r in bad))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n_devices", type=int)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--init", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.rank is None:
        dryrun_multichip(args.n_devices, device=args.device)
        return 0
    from .distributed import initialize_distributed

    if args.device == "cpu":
        torch.set_num_threads(1)  # the ranks share the host's cores
    initialize_distributed(args.init, args.n_devices, args.rank,
                           None if args.device == "cpu" else [args.rank], device=args.device)
    try:
        _dryrun_body(args.n_devices, args.device)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
