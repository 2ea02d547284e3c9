"""The whole-program units on a card: ``make_relaxation(jit=True)``, the
sharded steps built with ``jit=True`` and the spatial drivers' step-plus-
diagnostics body (``cli.step_body``), each replayed from one CUDA graph a
step against its eager run, bitwise; two runs in a row, results not
aliased across replays, launches counted on the capture, an inner operator
keeping no graph of its own, gloo ranks on the card raising, and on a host
of several cards NCCL ranks capturing the halo exchange.

No test here imports jax, so the file runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_step_graph_cuda.py -m cuda

Without a card every test skips.
"""

import pytest
import torch

import boltzfft_torch as bt
from boltzfft_torch import _graph, ds, transport
from boltzfft_torch.cli import march, step_body
from boltzfft_torch.cli.taylor_green_2d3v import taylor_green_f0
from boltzfft_torch.cli.taylor_green_3d3v import taylor_green_f0_3d
from boltzfft_torch.ds_operator import make_ds_collision_operator
from boltzfft_torch.kernels import fused_collide as k1
from boltzfft_torch.kernels import fused_gain as k3
from torch_rank_worker import launch


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _eager_body(step, diagnostics):
    """``step_body``'s body run eagerly."""
    def body(f, pre):
        f = step(f, pre)
        return f, diagnostics(f)

    return body


def _same(a, b):
    if isinstance(a, ds.DS):
        return torch.equal(a.hi, b.hi) and torch.equal(a.lo, b.lo)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a is None and b is None or torch.equal(a, b)


def _bkw(cfg, device, t=5.5):
    return torch.as_tensor(bt.bkw_f(cfg.velocity_grid.r_squared(), t), dtype=cfg.real_dtype,
                           device=device)


RELAX = {  # name -> CollisionConfig kwargs
    "fused ct (K1)": dict(nv=16, ns=12, impl="fused", fused_scheme="ct"),
    "rfft + use_pallas": dict(nv=16, ns=12, impl="rfft", use_pallas=True),
    "fused ct (K1) f32": dict(nv=16, ns=12, impl="fused", fused_scheme="ct", dtype="float32"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(RELAX))
def test_relaxation_graphed_matches_eager(cuda_device, name):
    """RK4 with a moments record: one step's graph replayed 3 times against
    3 eager steps (the operator eager too), twice in a row; the first run's
    results are not overwritten by the second."""
    cfg = bt.CollisionConfig(**RELAX[name])
    g = cfg.velocity_grid
    graphed_op, pre = bt.make_collision_operator(cfg, device=cuda_device)
    eager_op, _ = bt.make_collision_operator(cfg, jit=False, device=cuda_device)
    record = lambda x: bt.moments(x, g.v, g.dv)  # noqa: E731
    run = bt.make_relaxation(graphed_op, pre, dt=0.125, n_steps=3, method="rk4", record=record)
    eager = bt.make_relaxation(eager_op, pre, dt=0.125, n_steps=3, method="rk4", record=record,
                               jit=False)
    f0 = _bkw(cfg, cuda_device)
    first = run(f0)
    keep = (first.f.clone(), tuple(t.clone() for t in first.recorded))
    second = run(f0)
    want = eager(f0)
    torch.cuda.synchronize()
    assert _same(first.f, want.f) and _same(tuple(first.recorded), tuple(want.recorded))
    assert _same(second.f, want.f) and _same(tuple(second.recorded), tuple(want.recorded))
    assert _same(first.f, keep[0]) and _same(tuple(first.recorded), keep[1])
    assert first.f.data_ptr() != second.f.data_ptr()


@pytest.mark.cuda
def test_ds_relaxation_graphed_matches_eager(cuda_device):
    """ds RK4 at 16^3 on the card's defaults: the hoisted ds scalars held
    by the step's graph, the bits of the eager loop."""
    cfg = bt.CollisionConfig(nv=16, ns=12, impl="c2c", dtype="float32")
    graphed_op, pre = make_ds_collision_operator(cfg, device=cuda_device)
    eager_op, _ = make_ds_collision_operator(cfg, jit=False, device=cuda_device)
    f0 = ds.from_f64(bt.bkw_f(cfg.velocity_grid.r_squared(), 5.5), torch.float32, cuda_device)
    a = bt.make_relaxation(graphed_op, pre, dt=0.25, n_steps=2, method="rk4")(f0).f
    b = bt.make_relaxation(graphed_op, pre, dt=0.25, n_steps=2, method="rk4")(f0).f
    want = bt.make_relaxation(eager_op, pre, dt=0.25, n_steps=2, method="rk4", jit=False)(f0).f
    torch.cuda.synchronize()
    assert _same(a, want) and _same(b, want)


@pytest.mark.cuda
def test_inner_operator_keeps_no_graph_and_counts(cuda_device, monkeypatch):
    """Only the step captures: the operator (jit=True) runs eagerly inside
    the step's warm-up and capture.  The first graphed call counts two
    eager steps' launches (4 K1 evals each), a replay none."""
    captured = []
    real = _graph.Replayed._capture

    def spy(self, x, pre, dev):
        captured.append(self.fn.__name__)
        return real(self, x, pre, dev)

    monkeypatch.setattr(_graph.Replayed, "_capture", spy)
    cfg = bt.CollisionConfig(**RELAX["fused ct (K1)"])
    op, pre = bt.make_collision_operator(cfg, device=cuda_device)
    run = bt.make_relaxation(op, pre, dt=0.125, n_steps=1, method="rk4")
    f0 = _bkw(cfg, cuda_device)
    before = k1.LAUNCHES
    run(f0)
    first = k1.LAUNCHES - before
    run(f0)
    torch.cuda.synchronize()
    assert captured == ["body"]
    assert first == 8 and k1.LAUNCHES - before == 8


@pytest.mark.cuda
def test_relaxation_grad_needs_jit_false(cuda_device):
    cfg = bt.CollisionConfig(**RELAX["fused ct (K1)"])
    op, pre = bt.make_collision_operator(cfg, jit=False, device=cuda_device)
    f0 = _bkw(cfg, cuda_device).requires_grad_(True)
    with pytest.raises(RuntimeError, match="jit=False"):
        bt.make_relaxation(op, pre, dt=0.125, n_steps=1)(f0)
    traj = bt.make_relaxation(op, pre, dt=0.125, n_steps=1, jit=False)(f0)
    (grad,) = torch.autograd.grad(traj.f.sum(), f0)
    assert bool(torch.isfinite(grad).all()) and float(grad.abs().max()) > 0


def _diag(dv3, cell_vol):
    def diagnostics(f):
        return torch.stack([torch.sum(f) * dv3 * cell_vol,
                            torch.sum(bt.entropy(f, cell_volume=dv3)) * cell_vol])

    return diagnostics


def _spatial(name, cfg, coll, device):
    g = cfg.velocity_grid
    vmax = float(abs(g.v).max())
    tg = dict(u0=0.8, temperature=3.0)
    if name.startswith("TG-2D"):
        d = 1.0 / 4
        step = transport.make_inhomogeneous_step_2d(cfg, coll, dx=d, dy=d,
                                                    dt=transport.cfl_dt(vmax, d), knudsen=0.2)
        return step, taylor_green_f0(cfg, 4, device=device, **tg), d * d
    if name == "TG-3D":
        d = 1.0 / 2
        step = transport.make_inhomogeneous_step_3d(cfg, coll, dx=d, dy=d, dz=d,
                                                    dt=transport.cfl_dt(vmax, d), knudsen=0.2)
        return step, taylor_green_f0_3d(cfg, 2, device=device, **tg), d ** 3
    d = 1.0 / 8
    step = transport.make_inhomogeneous_step(cfg, coll, dx=d, dt=transport.cfl_dt(vmax, d),
                                             knudsen=0.5)
    return step, transport.sod_initial_condition(cfg, 8, device=device), d


SPATIAL = {  # name -> CollisionConfig kwargs
    "TG-2D K1": dict(nv=16, ns=12, impl="fused"),
    "TG-2D K1 f32": dict(nv=16, ns=12, impl="fused", dtype="float32"),
    "TG-2D kron (K3)": dict(nv=8, ns=12, impl="fused", fused_scheme="kron"),
    "TG-3D": dict(nv=16, ns=12, impl="fused"),
    "Sod": dict(nv=16, ns=12, impl="fused"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SPATIAL))
def test_driver_body_graphed_matches_eager(cuda_device, name):
    """The drivers' body (step plus diagnostics), one graph a step, 2 steps,
    twice, against the eager body around an eager operator: the final f and
    every trace entry bitwise; the first run kept."""
    cfg = bt.CollisionConfig(**SPATIAL[name])
    graphed_op, pre = bt.make_collision_operator(cfg, device=cuda_device)
    eager_op, _ = bt.make_collision_operator(cfg, jit=False, device=cuda_device)
    step, f0, cell_vol = _spatial(name, cfg, graphed_op, cuda_device)
    step_e, _, _ = _spatial(name, cfg, eager_op, cuda_device)
    diag = _diag(cfg.velocity_grid.cell_volume, cell_vol)
    body = step_body(step, diag, cuda_device)
    assert isinstance(body, _graph.Replayed)
    counter = k3 if "kron" in name else k1
    before = counter.LAUNCHES
    f1, tr1 = march(body, f0, pre, 2)
    captured = counter.LAUNCHES - before
    keep = (f1.clone(), [t.clone() for t in tr1])
    f2, tr2 = march(body, f0, pre, 2)
    fe, tre = march(_eager_body(step_e, diag), f0, pre, 2)
    torch.cuda.synchronize()
    assert _same(f1, fe) and _same(tr1, tre) and _same(f2, fe) and _same(tr2, tre)
    assert _same(f1, keep[0]) and _same(tr1, keep[1])
    assert captured == 4 and counter.LAUNCHES - before == 4 + 4  # 2 evals a step; eager 2 steps


@pytest.mark.cuda
def test_sharded_step_on_a_one_rank_nccl_mesh(cuda_device):
    """make_sharded_step_2d(jit=True) on a 1-rank NCCL mesh replays one
    graph a step: jit=False's bits and the unsharded step's."""
    import torch.distributed as dist

    started = not dist.is_initialized()
    mesh = bt.make_mesh([("cx", 1), ("cy", 1)], device="cuda")
    try:
        cfg = bt.CollisionConfig(**SPATIAL["TG-2D K1"])
        coll, pre = bt.make_collision_operator(cfg, device=cuda_device)
        d = 1.0 / 4
        kw = dict(dx=d, dy=d, dt=transport.cfl_dt(float(abs(cfg.velocity_grid.v).max()), d),
                  knudsen=0.2)
        f0 = taylor_green_f0(cfg, 4, device=cuda_device, u0=0.8, temperature=3.0)
        graphed = transport.make_sharded_step_2d(cfg, coll, mesh, x_axis="cx", y_axis="cy", **kw)
        eager = transport.make_sharded_step_2d(cfg, coll, mesh, x_axis="cx", y_axis="cy",
                                               jit=False, **kw)
        plain = transport.make_inhomogeneous_step_2d(cfg, coll, **kw)
        assert isinstance(graphed, _graph.Replayed)
        outs = []
        for st in (graphed, graphed, eager, plain):
            f = f0
            for _ in range(2):
                f = st(f, pre)
            outs.append(f)
        torch.cuda.synchronize()
        assert all(_same(o, outs[-1]) for o in outs)
    finally:
        if started:
            dist.destroy_process_group()


@pytest.mark.cuda
def test_gloo_ranks_on_the_card_raise_under_jit(cuda_device, tmp_path):
    for r in launch(2, ["card_step_jit"], tmp_path):
        res = r["card_step_jit"]
        assert "make_sharded_step_2d(jit=True)" in res["jit"] and "pass jit=False" in res["jit"]
        assert res["same"]


@pytest.mark.cuda
def test_nccl_ranks_capture_the_halo_exchange(cuda_device, tmp_path):
    """On every card along x, and on a 2-D mesh where the cards allow one:
    the step built with jit=True and the driver's graphed body give the
    eager bits."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more cards (NCCL takes one rank a card)")
    meshes = [f"{n}x1"] + ([f"2x{n // 2}"] if n >= 4 and n % 2 == 0 else [])
    for r in launch(n, [f"nccl_step:{m}" for m in meshes], tmp_path, backend="nccl"):
        for m in meshes:
            res = r[f"nccl_step:{m}"]
            assert res["same"] and res["body_same"] and res["body_graphed"], (m, res)
