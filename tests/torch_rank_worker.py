"""Ranks for the port's multi-device tests: one process per rank, joined
through gloo on the CPU (or NCCL, a card a rank).

    python tests/torch_rank_worker.py WORLD SPEC OUT

``SPEC`` is a JSON file ``{"cases": [...], "init": bool, "backend": str,
"env": [{...} per rank]}``.  The process imports torch, NumPy and
``boltzfft_torch`` once, then forks one child per rank (so a world pays
for one import, not one per rank).  Every rank sets its ``env``, runs the
named cases in order (each a function of this module, its arguments after
``:`` in the name) and pickles ``{case: result}`` to ``OUT/rank<R>.pkl``.
With ``init`` a rank first joins the process group through a ``file://``
store under ``OUT`` (no TCP port, so no clashes between test workers).
Nothing here imports JAX, and every rank checks that at its end.

:func:`launch` runs a world and returns its ranks' results.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import pickle
import signal
import subprocess
import sys
import tempfile
import traceback
from datetime import timedelta
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def launch(world: int, cases, tmp: Path, *, init: bool = True, env=None,
           timeout: float = 600.0, backend: str = "gloo") -> list:
    """Run ``cases`` on ``world`` ranks; returns each rank's ``{case:
    result}``.  ``env``: extra environment per rank, a function of the
    rank.  ``backend="nccl"`` puts rank r on card r.  Kills every rank and
    raises, with the log, if one fails or the time runs out."""
    tmp = Path(tempfile.mkdtemp(dir=tmp))
    spec = tmp / "spec.json"
    spec.write_text(json.dumps({"cases": list(cases), "init": init, "backend": backend,
                                "env": [env(r) if env else {} for r in range(world)]}))
    proc = subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), str(world), str(spec), str(tmp)],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        log = proc.communicate(timeout=timeout)[0]
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)  # the ranks are in its session
            proc.wait()
    if proc.returncode:
        raise RuntimeError(f"ranks failed (rc {proc.returncode}):\n{log[-8000:]}")
    out = []
    for r in range(world):
        with open(tmp / f"rank{r}.pkl", "rb") as fh:
            out.append(pickle.load(fh))
    return out


# ---------------------------------------------------------------------------
# the cases (run on every rank)
# ---------------------------------------------------------------------------

CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


def _np(t):
    import torch

    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t


def _bkw(cfg):
    import torch

    import boltzfft_torch as bt

    return torch.as_tensor(bt.bkw_f(cfg.velocity_grid.r_squared(), 6.5), dtype=cfg.real_dtype)


def _raises(fn, exc=ValueError) -> str:
    try:
        fn()
    except exc as e:
        return str(e)
    raise AssertionError(f"{fn} did not raise {exc.__name__}")


def _pre_arrays(pre):
    return {k: _np(getattr(pre, k)) for k in ("rho", "sigma", "gain_w", "lx", "ly", "lz",
                                              "norm_l", "beta2")}


def _counts():
    from boltzfft_torch.kernels import fused_collide, fused_gain, fused_gain_dft

    return {"k1": fused_collide.REFERENCE_CALLS, "k2": fused_gain_dft.REFERENCE_CALLS["ct"],
            "k3": fused_gain.REFERENCE_CALLS}


def _world():
    import torch.distributed as dist

    return dist.get_world_size()


@case
def node(impl="rfft", nv="16", ns="6", scheme="auto", chunk="0"):
    """The node-sharded operator over every rank, on the placed shard and
    on the global precomp; its padded tables and this rank's rows."""
    import torch

    import boltzfft_torch as bt

    kw = dict(nv=int(nv), ns=int(ns), impl=impl)
    if impl == "fused":
        kw["fused_scheme"] = scheme
    if int(chunk):
        kw["node_chunk"] = int(chunk)
    cfg = bt.CollisionConfig(**kw)
    mesh = bt.make_mesh([(bt.NODE_AXIS, _world())])
    coll, pre = bt.make_sharded_collision_operator(cfg, mesh)
    f = _bkw(cfg)
    before = _counts()
    placed = bt.place(pre, mesh)
    q = coll(f, placed)
    after = _counts()
    q_global = coll(f, pre)
    return {"q": _np(q), "global_same": bool(torch.equal(q, q_global)),
            "pre": _pre_arrays(pre), "placed": _pre_arrays(placed),
            "calls": {k: after[k] - before[k] for k in after}}


@case
def ensemble(impl="rfft", nv="16"):
    """Ensemble sharding over every rank: this rank's member against the
    port's unsharded collide of that member."""
    import torch

    import boltzfft_torch as bt

    kw = dict(nv=int(nv), ns=6, impl=impl)
    if impl == "fused":
        kw["fused_scheme"] = "ct"
    cfg = bt.CollisionConfig(**kw)
    f = _bkw(cfg)
    ens = torch.stack([f * s for s in (1.0, 0.5, 0.25, 2.0)] * 2)
    mesh = bt.make_mesh([(bt.ENSEMBLE_AXIS, _world())])
    coll, pre = bt.make_sharded_collision_operator(cfg, mesh, node_axis=None,
                                                   ensemble_axis=bt.ENSEMBLE_AXIS)
    block = bt.place_cells(ens, mesh, x_axis=bt.ENSEMBLE_AXIS)
    before = _counts()
    q = coll(block, pre)
    after = _counts()
    ref, ref_pre = bt.make_collision_operator(cfg, device="cpu")
    q_ref = torch.stack([ref(fi, ref_pre) for fi in block])
    return {"q": _np(q), "index": bt.sharding.axis_index(mesh, bt.ENSEMBLE_AXIS),
            "bitwise": bool(torch.equal(q, q_ref)), "shape": tuple(q.shape),
            "calls": {k: after[k] - before[k] for k in after}}


@case
def mesh2x4():
    """The (ensemble 2, node 4) mesh: rfft 16^3, E = (f, f / 2)."""
    import torch

    import boltzfft_torch as bt

    cfg = bt.CollisionConfig(nv=16, ns=6, impl="rfft")
    f = _bkw(cfg)
    mesh = bt.make_mesh([(bt.ENSEMBLE_AXIS, 2), (bt.NODE_AXIS, 4)])
    coll, pre = bt.make_sharded_collision_operator(cfg, mesh, node_axis=bt.NODE_AXIS,
                                                   ensemble_axis=bt.ENSEMBLE_AXIS)
    block = bt.place_cells(torch.stack([f, 0.5 * f]), mesh, x_axis=bt.ENSEMBLE_AXIS)
    q = coll(block, bt.place(pre, mesh))
    return {"q": _np(q), "index": bt.sharding.axis_index(mesh, bt.ENSEMBLE_AXIS)}


@case
def mesh_api():
    """make_mesh's defaults, names and errors on an initialised group."""
    import boltzfft_torch as bt

    world = _world()
    default = bt.make_mesh()
    named = bt.make_mesh([("cx", 2), ("cy", world // 2)])
    return {
        "default": (default.mesh_dim_names, tuple(default.shape), default.device_type),
        "named": (named.mesh_dim_names, tuple(named.shape),
                  bt.sharding.axis_index(named, "cx"), bt.sharding.axis_index(named, "cy")),
        "too_many": _raises(lambda: bt.make_mesh([(bt.NODE_AXIS, 2 * world)])),
        "bad_axis": _raises(lambda: bt.sharding.axis_size(default, "cz")),
        "no_axes": _raises(lambda: bt.make_sharded_collision_operator(
            bt.CollisionConfig(nv=8, ns=6), default, node_axis=None)),
    }


@case
def mesh_single():
    """No process group: make_mesh starts one of this process alone (gloo,
    a HashStore), and the 1-rank sharded operator is the unsharded one."""
    import torch
    import torch.distributed as dist

    import boltzfft_torch as bt

    assert not dist.is_initialized()
    mesh = bt.make_mesh(device="cpu")
    cfg = bt.CollisionConfig(nv=8, ns=6, impl="rfft")
    coll, pre = bt.make_sharded_collision_operator(cfg, mesh)
    ref, ref_pre = bt.make_collision_operator(cfg, device="cpu")
    f = _bkw(cfg)
    return {
        "group": (dist.get_world_size(), dist.get_backend()),
        "mesh": (mesh.mesh_dim_names, tuple(mesh.shape), mesh.device_type),
        "bitwise": bool(torch.equal(coll(f, pre), ref(f, ref_pre))),
        "too_many": _raises(lambda: bt.make_mesh([(bt.NODE_AXIS, 2)])),
    }


# ---- the radial-sharded ds operator ----------------------------------------


def _ds_cfg(nv=8, n_radial=6):
    import numpy as np

    import boltzfft_torch as bt
    from boltzfft_torch import ds

    cfg = bt.CollisionConfig(nv=nv, ns=6, n_radial=n_radial, impl="c2c", dtype="float32")
    f64 = np.asarray(bt.bkw_f(cfg.velocity_grid.r_squared(), 6.5), np.float64)
    return cfg, ds.from_f64(f64, device="cpu")


def _ds_np(q):
    from boltzfft_torch import ds

    return ds.to_f64(q)


@case
def ds_radial():
    """vpu, the radial groups over every rank: two calls, the placed and
    the global tables."""
    import boltzfft_torch as bt
    from boltzfft_torch import ds

    cfg, f = _ds_cfg()
    mesh = bt.make_mesh([(bt.NODE_AXIS, _world())])
    coll, pre = bt.make_sharded_ds_collision_operator(cfg, mesh, contract="vpu")
    placed = bt.place_ds(pre, mesh)
    a, b, c = coll(f, placed), coll(f, placed), coll(f, pre)
    same = lambda x, y: bool((x.hi == y.hi).all() and (x.lo == y.lo).all())
    leaves = []
    ds.tree_map(lambda t: leaves.append(_np(t.float())), pre)
    placed_leaves = []
    ds.tree_map(lambda t: placed_leaves.append(_np(t.float())), placed)
    return {"q": _ds_np(a), "repeat_bitwise": same(a, b), "global_bitwise": same(a, c),
            "leaves": leaves, "placed_leaves": placed_leaves}


@case
def ds_mesh2x4():
    """vpu on the (ensemble 2, node 4) mesh, E = 4 copies of f."""
    import torch

    import boltzfft_torch as bt
    from boltzfft_torch import ds

    cfg, f = _ds_cfg()
    mesh = bt.make_mesh([(bt.ENSEMBLE_AXIS, 2), (bt.NODE_AXIS, 4)])
    coll, pre = bt.make_sharded_ds_collision_operator(cfg, mesh, ensemble_axis=bt.ENSEMBLE_AXIS,
                                                      contract="vpu")
    fe = ds.tree_map(lambda a: torch.stack([a] * 4), f)
    block = ds.tree_map(lambda a: bt.place_cells(a, mesh, x_axis=bt.ENSEMBLE_AXIS), fe)
    return {"q": _ds_np(coll(block, bt.place_ds(pre, mesh)))}


@case
def ds_half(knobs="0"):
    """The half g-streams on ozk (the kernels' plain versions here), as the
    JAX package's half-stream sharding tests run them."""
    import boltzfft_torch as bt

    cfg, f = _ds_cfg(nv=6, n_radial=4)
    mesh = bt.make_mesh([(bt.NODE_AXIS, _world())])
    kw = dict(group_batch=2, herm_downstream=True) if int(knobs) else {}
    coll, pre = bt.make_sharded_ds_collision_operator(cfg, mesh, contract="ozk",
                                                      g_stream="half", sub_batch=6, **kw)
    return {"q": _ds_np(coll(f, bt.place_ds(pre, mesh)))}


# ---- the decomposed transport steps ------------------------------------------


def _cells_f(cells, seed=7):
    import numpy as np
    import torch

    import boltzfft_torch as bt
    from boltzfft_torch import transport

    cfg = bt.CollisionConfig(nv=8, ns=6, n_radial=2, impl="rfft")
    base = transport.sod_initial_condition(cfg, 1, device="cpu").numpy()[0]
    rng = np.random.RandomState(seed)
    lead = (None,) * len(cells)
    f = base[lead] * (1.0 + 0.3 * rng.rand(*cells, 1, 1, 1))
    return cfg, torch.as_tensor(f)


@case
def step(dims="2x2", cells="4x4", scheme="muscl", steps="2"):
    """The decomposed 2-D or 3-D step, ``steps`` times, on this rank's
    block; returns the block and its offsets."""
    import boltzfft_torch as bt
    from boltzfft_torch import transport

    dims = tuple(int(s) for s in dims.split("x"))
    cells = tuple(int(s) for s in cells.split("x"))
    names = ("cx", "cy", "cz")[:len(dims)]
    cfg, f = _cells_f(cells)
    coll, pre = bt.make_collision_operator(cfg, jit=False, device="cpu")
    mesh = bt.make_mesh(list(zip(names, dims)))
    axes = dict(zip(("x_axis", "y_axis", "z_axis"), names))
    kw = dict(dx=0.3, dy=0.2, dt=0.01, knudsen=1.0, scheme=scheme, **axes)
    if len(dims) == 3:
        st = transport.make_sharded_step_3d(cfg, coll, mesh, dz=0.25, **kw)
    else:
        st = transport.make_sharded_step_2d(cfg, coll, mesh, **kw)
    block = bt.place_cells(f, mesh, **axes)
    for _ in range(int(steps)):
        block = st(block, pre)
    offsets = tuple(bt.sharding.axis_index(mesh, n) * (c // d) for n, c, d in zip(names, cells, dims))
    return {"block": _np(block), "offsets": offsets}


@case
def step_jit(dims="2x2", cells="4x4"):
    """The decomposed 2-D step built with ``jit=True`` and with ``jit=False``
    (2 steps each; on the CPU ``jit`` changes nothing), and ``jit=True`` on
    these gloo ranks with the mesh's device taken for a card: it raises
    when the step is built."""
    import torch

    import boltzfft_torch as bt
    from boltzfft_torch import sharding, transport

    dims = tuple(int(s) for s in dims.split("x"))
    cells = tuple(int(s) for s in cells.split("x"))
    cfg, f = _cells_f(cells)
    coll, pre = bt.make_collision_operator(cfg, jit=False, device="cpu")
    mesh = bt.make_mesh(list(zip(("cx", "cy"), dims)))
    kw = dict(dx=0.3, dy=0.2, dt=0.01, knudsen=1.0, x_axis="cx", y_axis="cy")
    out = {}
    for jit in (True, False):
        st = transport.make_sharded_step_2d(cfg, coll, mesh, jit=jit, **kw)
        block = bt.place_cells(f, mesh, x_axis="cx", y_axis="cy")
        for _ in range(2):
            block = st(block, pre)
        out[jit] = _np(block)
    real = sharding.mesh_device
    sharding.mesh_device = lambda m: torch.device("cuda")
    try:
        out["card"] = _raises(lambda: transport.make_sharded_step_2d(cfg, coll, mesh, **kw))
    finally:
        sharding.mesh_device = real
    out["offsets"] = tuple(bt.sharding.axis_index(mesh, n) * (c // d)
                           for n, c, d in zip(("cx", "cy"), cells, dims))
    return out


@case
def cells(dims="2x2"):
    """place_cells of a (4, 6[, 2], 2, 2, 2) arange on this rank."""
    import torch

    import boltzfft_torch as bt

    dims = tuple(int(s) for s in dims.split("x"))
    names = ("cx", "cy", "cz")[:len(dims)]
    shape = (4, 6, 2)[:len(dims)] + (2, 2, 2)
    f = torch.arange(int(torch.tensor(shape).prod()), dtype=torch.float64).reshape(shape)
    mesh = bt.make_mesh(list(zip(names, dims)))
    return {"block": _np(bt.place_cells(f, mesh, **dict(zip(("x_axis", "y_axis", "z_axis"),
                                                              names))))}


@case
def halo_narrow():
    """One cell a rank is narrower than MUSCL's halo of 2: it raises; upwind
    (a halo of 1) runs."""
    import boltzfft_torch as bt
    from boltzfft_torch import transport

    world = _world()
    cfg, f = _cells_f((world, 2))
    coll, pre = bt.make_collision_operator(cfg, jit=False, device="cpu")
    mesh = bt.make_mesh([("cx", world)])
    block = bt.place_cells(f, mesh, x_axis="cx")
    mk = lambda scheme: transport.make_sharded_step_2d(
        cfg, coll, mesh, dx=0.3, dy=0.2, dt=0.01, x_axis="cx", scheme=scheme)
    msg = _raises(lambda: mk("muscl")(block, pre))
    out = mk("upwind")(block, pre)
    return {"muscl": msg, "upwind_shape": tuple(out.shape)}


# ---- the launcher's environment and the multi-host mesh ------------------------


@case
def dist_env():
    """initialize_distributed from torchrun's environment (TCP), twice;
    make_multihost_mesh with LOCAL_WORLD_SIZE=2; the rank's ensemble slice;
    an ensemble x node run on that mesh against the unsharded collide."""
    import torch

    import boltzfft_torch as bt

    first = bt.initialize_distributed(device="cpu")
    again = bt.initialize_distributed(device="cpu")
    mesh = bt.make_multihost_mesh()
    cfg = bt.CollisionConfig(nv=8, ns=6, impl="rfft")
    f = _bkw(cfg)
    ens = torch.stack([f * s for s in (1.0, 0.5, 0.25, 2.0)])
    coll, pre = bt.make_sharded_collision_operator(cfg, mesh, ensemble_axis=bt.ENSEMBLE_AXIS)
    start, size = bt.process_local_ensemble_slice(4 * bt.sharding.axis_size(mesh, "ensemble"))
    block = bt.place_cells(ens, mesh, x_axis=bt.ENSEMBLE_AXIS)
    q = coll(block, pre)
    ref, ref_pre = bt.make_collision_operator(cfg, device="cpu")
    q_ref = torch.stack([ref(fi, ref_pre) for fi in block])
    scale = float(q_ref.abs().max())
    return {
        "init": (first, again), "mesh": (mesh.mesh_dim_names, tuple(mesh.shape)),
        "slice": (start, size), "err": float((q - q_ref).abs().max()) / scale,
        "per_host": _raises(lambda: bt.make_multihost_mesh(node_devices_per_host=3)),
        "node_only": _raises(lambda: bt.make_multihost_mesh(ensemble_hosts=False)),
        "uneven": _raises(lambda: bt.process_local_ensemble_slice(7)),
    }


# ---- checkpoints -------------------------------------------------------------


@case
def ckpt_blocks():
    """Every rank saves its own block; retention; restore with a template."""
    import torch
    import torch.distributed as dist

    import boltzfft_torch as bt
    from boltzfft_torch import ds

    rank = dist.get_rank()
    where = os.path.join(OUT, "ck_blocks")
    ck = bt.RelaxCheckpointer(where, max_to_keep=2)
    f = torch.arange(6, dtype=torch.float64).reshape(2, 3) + 10 * rank
    for step in (1, 2, 3):
        ck.save(step, f * step, 0.5 * step, extra={"n": torch.tensor([step, rank])})
    g, t, extra = ck.restore(template=f.to(torch.float32), extra_template={"n": torch.zeros(2)})
    pair = ds.from_f64(f.numpy(), device="cpu")
    ck.save(4, pair, 2.0)
    back, _ = ck.restore(4, template=pair)
    return {"latest": ck.latest_step(), "kept": sorted(os.listdir(where)),
            "f": _np(g), "dtype": str(g.dtype), "t": t, "extra": _np(extra["n"]),
            "ds_bitwise": bool(torch.equal(back.hi, pair.hi) and torch.equal(back.lo, pair.lo))}


@case
def ckpt_cli():
    """``ensemble_bkw --checkpoint-dir``: 4 steps at once, against 2 steps,
    then a resumed run to 4; the final states bitwise equal."""
    import torch

    import boltzfft_torch as bt
    from boltzfft_torch.cli import ensemble_bkw

    base = ["--ensemble", "4", "--Nv", "8", "--Ns", "6", "--dt", "0.05", "--device", "cpu"]
    whole, parts = os.path.join(OUT, "ck_whole"), os.path.join(OUT, "ck_parts")
    lines = []
    for d, steps, every in ((whole, 4, 4), (parts, 2, 1), (parts, 4, 1)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = ensemble_bkw.main(base + ["--steps", str(steps), "--checkpoint-every",
                                           str(every), "--checkpoint-dir", d])
        assert rc == 0
        lines.append(buf.getvalue())
    a, ta = bt.RelaxCheckpointer(whole).restore()
    b, tb = bt.RelaxCheckpointer(parts).restore()
    return {"bitwise": bool(torch.equal(a, b)), "t": (ta, tb), "lines": lines,
            "steps": (bt.RelaxCheckpointer(whole).latest_step(),
                      bt.RelaxCheckpointer(parts).latest_step())}


# ---- the drivers ---------------------------------------------------------------


@case
def cli(name="ensemble_bkw", *argv):
    """A driver's ``main`` on every rank; rank 0's lines."""
    import importlib

    mod = importlib.import_module(f"boltzfft_torch.cli.{name}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(list(argv))
    return {"rc": rc, "out": buf.getvalue()}


# ---- the examples -------------------------------------------------------------


@case
def example(name, *argv):
    """An example's ``main`` on every rank; ``NAME=value`` arguments first
    set the module's integer constants (``mixing_2d3v``'s ``CELLS``)."""
    import importlib

    mod = importlib.import_module(f"boltzfft_torch.examples.{name}")
    consts = dict(a.split("=") for a in argv if "=" in a)
    for k, v in consts.items():
        setattr(mod, k, int(v))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main([a for a in argv if "=" not in a])
    return {"rc": rc, "out": buf.getvalue()}


# ---- two ranks sharing one card over gloo (the card's tests) ----------------------


@case
def card_node(nv="16"):
    """The node-sharded fused route on the card (K2, then the gloo
    all_reduce of a CUDA tensor) against the unsharded K1 eval; jit=True
    over gloo raises."""
    import torch

    import boltzfft_torch as bt
    from boltzfft_torch.kernels import fused_gain_dft

    torch.cuda.set_device(0)
    mesh = bt.make_mesh([(bt.NODE_AXIS, _world())], device="cuda")
    cfg = bt.CollisionConfig(nv=int(nv), ns=12, impl="fused", fused_scheme="ct")
    msg = _raises(lambda: bt.make_sharded_collision_operator(cfg, mesh))
    coll, pre = bt.make_sharded_collision_operator(cfg, mesh, jit=False)
    f = _bkw(cfg).cuda()
    before = fused_gain_dft.LAUNCHES["ct"]
    q = coll(f, bt.place(pre, mesh))
    launches = fused_gain_dft.LAUNCHES["ct"] - before
    ref, ref_pre = bt.make_collision_operator(cfg, jit=False)
    q_ref = ref(f, ref_pre)
    err = float((q - q_ref).abs().max() / q_ref.abs().max())
    return {"jit": msg, "k2": launches, "err": err, "device": str(q.device)}


@case
def card_ds(nv="16"):
    """The 2-shard ds operator on the card's defaults (the gloo all_gather
    of CUDA tensors, the ds fold) against the unsharded ds eval."""
    import numpy as np
    import torch

    import boltzfft_torch as bt
    from boltzfft_torch import ds

    torch.cuda.set_device(0)
    mesh = bt.make_mesh([(bt.NODE_AXIS, _world())], device="cuda")
    cfg = bt.CollisionConfig(nv=int(nv), ns=12, impl="c2c", dtype="float32")
    coll, pre = bt.make_sharded_ds_collision_operator(cfg, mesh, jit=False)
    f = ds.from_f64(bt.bkw_f(cfg.velocity_grid.r_squared(), 6.5), torch.float32, "cuda")
    q = ds.to_f64(coll(f, bt.place_ds(pre, mesh)))
    ref, ref_pre = bt.make_ds_collision_operator(cfg, jit=False)
    q_ref = ds.to_f64(ref(f, ref_pre))
    return {"err": float(np.abs(q - q_ref).max() / np.abs(q_ref).max())}


@case
def nccl_ops():
    """NCCL ranks, a card each: the node-sharded fused route and the
    radial-sharded ds operator replayed from CUDA graphs that capture the
    collectives, against their eager evals (bitwise, two f) and the
    unsharded ones (1e-12 max|Q|)."""
    import numpy as np
    import torch

    import boltzfft_torch as bt
    from boltzfft_torch import ds
    from boltzfft_torch.kernels import fused_gain_dft

    mesh = bt.make_mesh([(bt.NODE_AXIS, _world())])
    cfg = bt.CollisionConfig(nv=32, ns=12, impl="fused")
    graphed, pre = bt.make_sharded_collision_operator(cfg, mesh)
    eager, _ = bt.make_sharded_collision_operator(cfg, mesh, jit=False)
    pre = bt.place(pre, mesh)
    f = _bkw(cfg).cuda()
    before = fused_gain_dft.LAUNCHES["ct"]
    q = eager(f, pre)
    k2 = fused_gain_dft.LAUNCHES["ct"] - before
    same = all(torch.equal(graphed(x, pre), eager(x, pre)) for x in (f, 1.1 * f, f))
    ref, ref_pre = bt.make_collision_operator(cfg, jit=False)
    q_ref = ref(f, ref_pre)
    out = {"fused_same": same, "k2": k2,
           "fused_err": float((q - q_ref).abs().max() / q_ref.abs().max())}
    cfg = bt.CollisionConfig(nv=32, ns=12, impl="c2c", dtype="float32")
    graphed, pre = bt.make_sharded_ds_collision_operator(cfg, mesh)
    eager, _ = bt.make_sharded_ds_collision_operator(cfg, mesh, jit=False)
    pre = bt.place_ds(pre, mesh)
    f = ds.from_f64(bt.bkw_f(cfg.velocity_grid.r_squared(), 6.5), torch.float32, "cuda")
    a, b = graphed(f, pre), eager(f, pre)
    out["ds_same"] = bool(torch.equal(a.hi, b.hi) and torch.equal(a.lo, b.lo))
    ref, ref_pre = bt.make_ds_collision_operator(cfg, jit=False)
    qa, qr = ds.to_f64(b), ds.to_f64(ref(f, ref_pre))
    out["ds_err"] = float(np.abs(qa - qr).max() / np.abs(qr).max())
    return out


@case
def card_step_jit():
    """Gloo ranks holding CUDA tensors: ``make_sharded_step_2d(jit=True)``
    raises when built (gloo's exchanges cannot be captured); the eager
    step (``jit=False``, halos through host copies), 2 steps, against the
    unsharded step on the same card, bitwise."""
    import torch

    import boltzfft_torch as bt
    from boltzfft_torch import transport

    torch.cuda.set_device(0)
    n = _world()
    mesh = bt.make_mesh([("cx", n), ("cy", 1)], device="cuda")
    cfg, f = _cells_f((2 * n, 2))
    coll, pre = bt.make_collision_operator(cfg, jit=False)
    kw = dict(dx=0.3, dy=0.2, dt=0.01, knudsen=1.0)
    msg = _raises(lambda: transport.make_sharded_step_2d(cfg, coll, mesh, x_axis="cx",
                                                         y_axis="cy", **kw))
    st = transport.make_sharded_step_2d(cfg, coll, mesh, x_axis="cx", y_axis="cy", jit=False, **kw)
    whole = transport.make_inhomogeneous_step_2d(cfg, coll, **kw)
    f = f.cuda()
    block, want = bt.place_cells(f, mesh, x_axis="cx", y_axis="cy"), f
    for _ in range(2):
        block, want = st(block, pre), whole(want, pre)
    k = bt.sharding.axis_index(mesh, "cx")
    return {"jit": msg, "same": bool(torch.equal(block, want[2 * k:2 * k + 2]))}


@case
def nccl_step(dims=""):
    """NCCL ranks, a card each, on a ``dims`` cell mesh (default: every
    rank along x): the decomposed TG-2D step at 16^3 on K1 built with
    ``jit=True`` (the halo sends and receives captured in the step's graph)
    against ``jit=False``, bitwise over 2 steps, twice; and the TG-2D
    driver's body (:func:`boltzfft_torch.cli.step_body` around the
    ``jit=False`` step, as ``--mesh`` builds it) against the same body run
    eagerly, bitwise on f and on every diagnostics entry."""
    import torch

    import boltzfft_torch as bt
    from boltzfft_torch import transport
    from boltzfft_torch.cli import march, step_body
    from boltzfft_torch.cli.taylor_green_2d3v import diagnostics_fn, taylor_green_f0

    mx, my = (int(s) for s in (dims or f"{_world()}x1").split("x"))
    mesh = bt.make_mesh([("cx", mx), ("cy", my)])
    dev = bt.sharding.mesh_device(mesh)
    cfg = bt.CollisionConfig(nv=16, ns=12, impl="fused")
    coll, pre = bt.make_collision_operator(cfg)
    nc = 4 * max(mx, my)
    d = 1.0 / nc
    kw = dict(dx=d, dy=d, dt=transport.cfl_dt(float(abs(cfg.velocity_grid.v).max()), d),
              knudsen=0.2, x_axis="cx", y_axis="cy")
    f0 = bt.place_cells(taylor_green_f0(cfg, nc, u0=0.8, temperature=3.0),
                        mesh, x_axis="cx", y_axis="cy")
    runs = {}
    for jit in (True, False):
        st = transport.make_sharded_step_2d(cfg, coll, mesh, jit=jit, **kw)
        outs = []
        for _ in range(2):
            f = f0
            for _ in range(2):
                f = st(f, pre)
            outs.append(f)
        runs[jit] = outs
    st = transport.make_sharded_step_2d(cfg, coll, mesh, jit=False, **kw)
    diagnostics = diagnostics_fn(cfg, d, dev)

    def eager(f, pre):
        f = st(f, pre)
        return f, diagnostics(f)

    graphed = step_body(st, diagnostics, dev)
    (fg, tg), (fe, te) = march(graphed, f0, pre, 2), march(eager, f0, pre, 2)
    torch.cuda.synchronize()
    return {"same": all(torch.equal(a, b) for a in runs[True] for b in runs[False]),
            "body_same": bool(torch.equal(fg, fe) and all(map(torch.equal, tg, te))),
            "body_graphed": graphed is not eager and type(graphed).__name__ == "Replayed"}


# ---------------------------------------------------------------------------

OUT = ""


def _rank(rank: int, world: int, spec: dict) -> None:
    """One rank: join the group, run the cases, pickle the results."""
    import torch
    import torch.distributed as dist

    os.environ.update(spec["env"][rank])
    torch.set_num_threads(1)
    if spec["init"]:
        kw = {}
        if spec["backend"] == "nccl":
            torch.cuda.set_device(rank)
            kw["device_id"] = torch.device("cuda", rank)
        dist.init_process_group(spec["backend"], init_method=f"file://{OUT}/store", rank=rank,
                                world_size=world, timeout=timedelta(seconds=240), **kw)
    results = {}
    for name in spec["cases"]:
        fn, *args = name.split(":")
        results[name] = CASES[fn](*args)
    if "jax" in sys.modules:
        raise RuntimeError("a rank imported jax")
    with open(Path(OUT) / f"rank{rank}.pkl", "wb") as fh:
        pickle.dump(results, fh)
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def main() -> int:
    """Import once, fork a child per rank, wait for them all; the first
    that fails takes the others down."""
    global OUT
    world, spec, OUT = int(sys.argv[1]), json.loads(Path(sys.argv[2]).read_text()), sys.argv[3]
    import torch  # noqa: F401  (imported once, before the fork)

    import boltzfft_torch  # noqa: F401

    children = {}
    for rank in range(world):
        pid = os.fork()
        if pid == 0:
            code = 0
            try:
                _rank(rank, world, spec)
            except Exception:
                traceback.print_exc()
                code = 1
            sys.stdout.flush()
            sys.stderr.flush()
            os._exit(code)
        children[pid] = rank
    failed = False
    while children:
        pid, status = os.wait()
        children.pop(pid, None)
        if status and not failed:
            failed = True
            for other in children:
                os.kill(other, signal.SIGKILL)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
