"""``boltzfft_torch.obs`` on the CPU: the switch, the host spans' nesting
and per-unit aggregates, what ``reset`` keeps, the kernel counters' view and
the ``boltzfft.*`` ranges in ``bt.trace``'s Chrome JSON.

A CPU has no CUDA graph, so :class:`_graph.Replayed` runs here against
stand-ins for ``torch.cuda``'s graph and stream objects (the ``fake_graphs``
fixture): its capture runs ``fn`` twice (warm-up and "capture") and a
replay runs nothing, which is all its spans and counters need."""

import contextlib
import json

import pytest
import torch

import boltzfft_torch as bt
from boltzfft_torch import _graph, obs
from boltzfft_torch.kernels import fused_collide


class _Stream:
    cuda_stream = 0

    def wait_stream(self, _other):
        pass


class _Graph:
    def __init__(self, keep_graph=False):
        self.keep_graph = keep_graph
        self.replays = 0

    def instantiate(self):
        pass

    def replay(self):
        self.replays += 1


@pytest.fixture
def fake_graphs(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device", lambda _dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "Stream", _Stream)
    monkeypatch.setattr(torch.cuda, "stream", lambda _s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *_a: _Stream())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "graph", lambda _g: contextlib.nullcontext())


@pytest.fixture
def observed():
    """obs on, cleared, and off again after the test."""
    obs.enable()
    obs.reset()
    yield
    obs.disable()
    obs.reset()


def _relaxation(jit=True):
    cfg = bt.CollisionConfig(nv=8, ns=6, n_radial=4, impl="fused")
    collide, pre = bt.make_collision_operator(cfg, device="cpu")
    f0 = torch.as_tensor(bt.bkw_f(cfg.velocity_grid.r_squared(), 6.5))
    run = bt.make_relaxation(collide, pre, dt=0.125, n_steps=1, method="rk4", jit=jit)
    return run, f0, pre


def test_off_records_nothing_and_enters_no_range(monkeypatch, fake_graphs, tmp_path):
    obs.disable()
    obs.reset()
    entered = []
    real = torch.autograd.profiler.record_function
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        lambda name, *a: entered.append(name) or real(name, *a))
    assert obs.span("replay") is obs.span("collide", like=torch.zeros(1))  # the shared no-op
    run, f0, pre = _relaxation()
    captures = obs.summary()["counters"]["captures"].get("relaxation.step", 0)
    with bt.trace(str(tmp_path)):
        run.step(f0, pre)
        run.step(f0, pre)
        _relaxation(jit=False)[0](f0)
    s = obs.summary()
    assert s["host"] == {} and s["device"] == {} and s["spans"] == [] and not s["enabled"]
    assert entered == []
    assert s["counters"]["captures"]["relaxation.step"] == captures + 1  # counters are always on


def test_host_spans_nest_under_the_relaxation_step(fake_graphs, observed):
    run, f0, pre = _relaxation()
    f1, _ = run.step(f0, pre)  # warm-up, capture, replay
    run.step(f1, pre)  # replay
    s = obs.summary()
    assert s["enabled"] and "main" in s["host"]  # the operator's tables
    assert s["host"]["main"]["precomp"]["count"] == 1
    unit = s["host"]["relaxation.step"]
    want = {"capture": 1, "capture/capture.warmup": 1, "capture/capture.graph": 1,
            "capture.warmup/step": 1, "capture.graph/step": 1, "step/collide": 8,
            "replay": 2, "replay/replay.copy_in": 2, "replay/replay.launch": 2,
            "replay/replay.clone_out": 2}
    assert {k: v["count"] for k, v in unit.items()} == want
    for k, v in unit.items():
        assert 0.0 < v["max_ms"] <= v["total_ms"], k
    assert unit["capture"]["total_ms"] >= unit["capture/capture.graph"]["total_ms"]
    assert unit["replay"]["total_ms"] >= unit["replay/replay.launch"]["total_ms"]
    # the kept spans: (unit, name, parent, start, end, attrs), each inside its parent
    spans = [sp for sp in s["spans"] if sp[0] == "relaxation.step"]
    assert len(spans) == sum(want.values())
    launch = next(sp for sp in spans if sp[1] == "replay.launch")
    outer = next(sp for sp in spans if sp[1] == "replay" and sp[3] <= launch[3])
    assert launch[2] == "replay" and outer[3] <= launch[3] <= launch[4] <= outer[4]
    assert s["device"] == {} and s["marks"]["written"] == 0  # no card: no marks


def test_eager_spans_belong_to_main(observed):
    run, f0, _pre = _relaxation(jit=False)
    run(f0)
    unit = obs.summary()["host"]["main"]
    assert unit["collide"]["count"] == 4 and unit["precomp"]["count"] == 1


def test_reset_keeps_what_captures_recorded(fake_graphs, observed):
    run, f0, pre = _relaxation()
    before = dict(obs.summary()["counters"]["captures"])
    run.step(f0, pre)
    obs.note("k1_plan", "1x8x8x8", {"nodes_per_chunk": 24, "chunks_per_eval": 1})
    obs.reset()
    s = obs.summary()
    assert s["host"] == {} and s["spans"] == []
    assert s["counters"]["captures"]["relaxation.step"] == before.get("relaxation.step", 0) + 1
    assert s["counters"]["k1_plan"]["1x8x8x8"] == {"nodes_per_chunk": 24, "chunks_per_eval": 1}
    run.step(f0, pre)  # a replay: no capture, spans again
    s = obs.summary()
    assert s["counters"]["captures"]["relaxation.step"] == before.get("relaxation.step", 0) + 1
    assert set(s["host"]["relaxation.step"]) == {
        "replay", "replay/replay.copy_in", "replay/replay.launch", "replay/replay.clone_out"}


def test_evictions_are_counted(fake_graphs, observed):
    before = obs.summary()["counters"]
    unit = _graph.Replayed(lambda x, pre: 2.0 * x, "doubler")
    for n in range(_graph.KEEP + 2):  # a new shape each call: a capture each, the oldest evicted
        unit(torch.zeros(n + 1), None)
    after = obs.summary()["counters"]
    assert after["captures"]["doubler"] - before["captures"].get("doubler", 0) == _graph.KEEP + 2
    assert after["evictions"]["doubler"] - before["evictions"].get("doubler", 0) == 2


def test_counter_view_reads_the_kernel_modules(monkeypatch):
    monkeypatch.setattr(fused_collide, "LAUNCHES", 7)
    monkeypatch.setattr(fused_collide, "REFERENCE_CALLS", 3)
    view = obs.summary()["counters"]["kernels"]
    assert view["fused_collide"] == {"LAUNCHES": 7, "REFERENCE_CALLS": 3}
    assert set(view["oz_contract"]) == {"LAUNCHES", "PHASED_LAUNCHES", "REFERENCE_CALLS", "COPIES"}
    assert set(view["fused_gain_dft"]["LAUNCHES"]) == {"ct", "transpose"}


def test_trace_holds_the_replay_ranges(fake_graphs, observed, tmp_path):
    run, f0, pre = _relaxation()
    with bt.trace(str(tmp_path)) as tr:
        f1, _ = run.step(f0, pre)
        run.step(f1, pre)
    with open(tr.path) as fh:
        names = [e.get("name") for e in json.load(fh)["traceEvents"]]
    assert names.count("boltzfft.replay") == 2
    assert names.count("boltzfft.replay.launch") == 2
    assert names.count("boltzfft.capture") == 1 and names.count("boltzfft.collide") == 8


def test_library_span_and_counters(monkeypatch, observed):
    from boltzfft_torch import _build

    class _Lib:
        def __getattr__(self, name):
            return type("Entry", (), {})()

    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "build", lambda: _build.LIB_PATH)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda _path: _Lib())
    loads = obs.summary()["counters"]["library"].get("loads", 0)
    _build.load_library()
    s = obs.summary()
    assert s["counters"]["library"]["loads"] == loads + 1
    (lib,) = [sp for sp in s["spans"] if sp[1] == "library"]
    assert set(lib[5]) == {"built"}
    assert s["host"]["main"]["library"]["count"] == 1
