"""``boltzfft_torch.obs`` on a card: a replayed step has the same bits with
obs on and off, obs off adds no graph node, a device span agrees with CUDA
events, the node counter agrees with the kept graph and its debug dump, and
a traced step's device spans add up.

No test here imports jax, so the file runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_obs_cuda.py -m cuda

Without a card every test skips.
"""

import statistics
import sys
from pathlib import Path

import pytest
import torch

import boltzfft_torch as bt
from boltzfft_torch import _graph, obs

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture
def observed():
    obs.enable()
    obs.reset()
    yield
    obs.disable()
    obs.reset()


def _relaxation(device, nv=32, jit=True):
    cfg = bt.CollisionConfig(nv=nv, ns=12, impl="fused", fused_scheme="ct")
    g = cfg.velocity_grid
    collide, pre = bt.make_collision_operator(cfg, jit=jit, device=device)
    record = lambda x: bt.moments(x, g.v, g.dv)  # noqa: E731
    run = bt.make_relaxation(collide, pre, dt=0.125, n_steps=1, method="rk4", record=record,
                             jit=jit)
    f0 = torch.as_tensor(bt.bkw_f(g.r_squared(), 5.5), dtype=cfg.real_dtype, device=device)
    return run, f0, pre, collide


def _steps(run, f, pre, n=3):
    out = []
    for _ in range(n):
        f, rec = run.step(f, pre)
        out.append((f, rec.mass, rec.energy))
    return out


def _graph_of(unit):
    return next(reversed(unit._graphs.values())).graph


def _parent_capture_nodes(fn, x, pre):
    """The nodes of ``fn``'s graph captured as ``Replayed`` captured it before
    obs (warm-up on a side stream, inner units eager, the graph kept)."""
    _graph._depth += 1
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn(x, pre)
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(g):
            fn(x, pre)
        g.instantiate()
    finally:
        _graph._depth -= 1
    return obs.graph_nodes(g)


@pytest.mark.cuda
def test_bits_equal_with_obs_on_and_off(cuda_device):
    """A replayed BKW 32^3 RK4 step with its moments: three steps with obs
    off, three from a graph captured with obs on, bitwise equal."""
    obs.disable()
    run, f0, pre, _ = _relaxation(cuda_device)
    off = _steps(run, f0, pre)
    obs.enable()
    try:
        run_on, _f0, pre_on, _ = _relaxation(cuda_device)
        on = _steps(run_on, f0, pre_on)
        s = obs.summary()
    finally:
        obs.disable()
        obs.reset()
    assert all(torch.equal(a, b) for x, y in zip(off, on) for a, b in zip(x, y))
    assert s["device"]["relaxation.step"]["step"]["count"] >= 3
    assert s["marks"]["lost"] == 0 and s["marks"]["unpaired"] == 0


@pytest.mark.cuda
def test_obs_off_adds_no_node(cuda_device):
    """Off, the step's graph has the nodes of the capture before obs; on,
    ten more: the step's two marks and two for each of its four evals."""
    obs.disable()
    run, f0, pre, _ = _relaxation(cuda_device, nv=16)
    run.step(f0, pre)
    off = obs.summary()["counters"]["graph_nodes"]["relaxation.step"]
    assert off == _parent_capture_nodes(run.step.fn, f0, pre)
    obs.enable()
    try:
        run_on, _f0, pre_on, _ = _relaxation(cuda_device, nv=16)
        run_on.step(f0, pre_on)
        on = obs.summary()["counters"]["graph_nodes"]["relaxation.step"]
        assert on == obs.graph_nodes(_graph_of(run_on.step)) == off + 10
    finally:
        obs.disable()
        obs.reset()


@pytest.mark.cuda
def test_collide_span_agrees_with_events(cuda_device, observed):
    """An eager K1 eval at 32^3: its ``collide`` device span (the marks'
    %globaltimer) against CUDA events around the same call, mean of 10."""
    _run, f0, pre, collide = _relaxation(cuda_device, jit=False)
    collide(f0, pre)
    torch.cuda.synchronize()
    obs.reset()
    events = []
    for _ in range(10):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        collide(f0, pre)
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    ev = statistics.mean(a.elapsed_time(b) for a, b in events)
    span = obs.summary()["device"]["main"]["collide"]
    assert span["count"] == 10
    marked = span["total_ms"] / 10
    assert abs(marked - ev) <= max(0.02 * ev, 0.005), (marked, ev)


@pytest.mark.cuda
def test_node_counter_agrees_with_the_kept_graph(cuda_device, observed, tmp_path):
    """``step_graph_nodes`` (the capture's count) against cudaGraphGetNodes
    of the kept graph and the nodes in chip_smoke's debug dump of it."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    run, f0, pre, _ = _relaxation(cuda_device, nv=16)
    run.step(f0, pre)
    counted = obs.summary()["counters"]["graph_nodes"]["relaxation.step"]
    graph = _graph_of(run.step)
    nodes = chip_smoke.graph_nodes(graph, tmp_path / "step.dot")
    assert counted == obs.graph_nodes(graph)
    assert counted == sum(nodes.get(t, 0) for t in chip_smoke.NODE_TYPES + ("unlabelled",))
    assert nodes["kernel: obs_mark"] == 10


@pytest.mark.cuda
def test_step_spans_add_up(cuda_device, observed):
    """A TG-2D step (``cli.step_body``) replayed 8 times: the step span's
    children are its two evals and four advections, its self time the rest,
    and 7 gaps lie between the 8 steps."""
    from boltzfft_torch import cli, transport
    from boltzfft_torch.cli.taylor_green_2d3v import diagnostics_fn, taylor_green_f0

    cfg = bt.CollisionConfig(nv=16, ns=12, impl="fused", fused_scheme="ct")
    collide, pre = bt.make_collision_operator(cfg, device=cuda_device)
    d = 1.0 / 8
    step = transport.make_inhomogeneous_step_2d(cfg, collide, dx=d, dy=d, dt=0.002, knudsen=0.2)
    body = cli.step_body(step, diagnostics_fn(cfg, d, cuda_device), cuda_device)
    f = taylor_green_f0(cfg, 8, u0=0.8, temperature=3.0, device=cuda_device)
    body(f, pre)
    obs.reset()
    for _ in range(8):
        f, _diag = body(f, pre)
    s = obs.summary()
    dev = s["device"]["step_body"]
    assert dev["step"]["count"] == 8 and dev["step/collide"]["count"] == 16
    assert dev["step/advect.x"]["count"] == 16 and dev["step/advect.y"]["count"] == 16
    children = sum(dev[k]["total_ms"] for k in ("step/collide", "step/advect.x", "step/advect.y"))
    assert dev["step"]["self_ms"] == pytest.approx(dev["step"]["total_ms"] - children)
    assert 0 < dev["step"]["self_ms"] < dev["step"]["total_ms"]
    assert s["gaps"]["step_body"]["count"] == 7
    assert s["host"]["step_body"]["replay/replay.launch"]["count"] == 8
    assert s["marks"]["lost"] == 0 and s["marks"]["unpaired"] == 0
