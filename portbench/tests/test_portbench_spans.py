"""The span and counter metrics reduce ``boltzfft_torch.obs.summary()`` as a
run stored it on ``run.spans``; a run without spans reads nothing of them
(an untraced line, a CPU line, a program without obs)."""

import pytest

from portbench import harness, spans

SPAN_METRICS = ["step_collide_ms", "step_advect_ms", "step_halo_ms", "step_self_ms",
                "step_gap_us", "replay_launch_ms"]
COUNTER_METRICS = ["step_graph_nodes", "step_captures"]


def _run(summary=None):
    run = harness.Run(config={"nv": 16, "ns": 12, "n_radial": 16, "dtype": "float64"},
                      chips=4, steps=4, window_s=0.04, step_ms=[10.0] * 4, host_call_ms=[0.3],
                      setup_s=3.0, capture_s=0.1, precomp_s=0.05, evals_per_step=2, batch=256,
                      memory_peak_bytes=2**31)
    if summary is not None:
        run.spans = summary
    return run


def _ms(count, total, self_ms=None):
    out = {"count": count, "total_ms": total, "max_ms": total / count}
    if self_ms is not None:
        out["self_ms"] = self_ms
    return out


# a mesh step's summary over 10 steps: two evals, two advections a cell axis,
# each with its halo exchange
MESH = {
    "host": {"sharded_step_2d": {"replay": _ms(10, 3.0),
                                 "replay/replay.launch": _ms(10, 1.5)}},
    "device": {"sharded_step_2d": {
        "step": _ms(10, 140.0, self_ms=2.0),
        "step/collide": _ms(20, 130.0),
        "step/advect.x": _ms(20, 5.0, self_ms=3.0),
        "step/advect.y": _ms(20, 3.0, self_ms=2.0),
        "advect.x/halo.x": _ms(20, 2.0),
        "advect.y/halo.y": _ms(20, 1.0),
    }, "collide": {"collide": _ms(21, 140.0)}},
    "gaps": {"sharded_step_2d": _ms(9, 0.18)},
    "marks": {"written": 220, "lost": 0, "unpaired": 0},
    "counters": {"captures": {"sharded_step_2d": 1, "collide": 1},
                 "graph_nodes": {"sharded_step_2d": 611}},
}


def test_readers_reduce_a_summary():
    read = {m: harness.reader(m)(_run(MESH)) for m in SPAN_METRICS + COUNTER_METRICS}
    assert read["step_collide_ms"] == pytest.approx(13.0)
    assert read["step_advect_ms"] == pytest.approx(0.8)
    assert read["step_halo_ms"] == pytest.approx(0.3)
    assert read["step_self_ms"] == pytest.approx(0.2)
    assert read["step_gap_us"] == pytest.approx(20.0)
    assert read["replay_launch_ms"] == pytest.approx(0.15)
    assert read["step_graph_nodes"] == 611 and read["step_captures"] == 1
    # the decomposition closes: collide + advect + self + gap = a step's device time
    step = MESH["device"]["sharded_step_2d"]["step"]["total_ms"] / 10
    assert read["step_collide_ms"] + read["step_advect_ms"] + read["step_self_ms"] == \
        pytest.approx(step)


def test_a_relaxation_step_has_no_transport():
    relax = {"host": {}, "device": {"relaxation.step": {"step": _ms(4, 40.0, self_ms=0.8),
                                                        "step/collide": _ms(16, 39.2)}},
             "gaps": {}, "counters": {"captures": {"relaxation.step": 1}, "graph_nodes": {}}}
    read = {m: harness.reader(m)(_run(relax)) for m in SPAN_METRICS + COUNTER_METRICS}
    assert read["step_collide_ms"] == pytest.approx(9.8) and read["step_self_ms"] == pytest.approx(0.2)
    assert read["step_advect_ms"] is None and read["step_halo_ms"] is None
    assert read["step_gap_us"] is None and read["replay_launch_ms"] is None
    assert read["step_graph_nodes"] is None and read["step_captures"] == 1


def test_counters_alone_give_no_span_metric():
    """obs off: the counters are there, the spans are not."""
    off = {"host": {}, "device": {}, "gaps": {},
           "counters": {"captures": {"step_body": 1}, "graph_nodes": {"step_body": 431}}}
    run = _run(off)
    assert all(harness.reader(m)(run) is None for m in SPAN_METRICS)
    assert harness.reader("step_graph_nodes")(run) == 431


def test_no_spans_no_reading(monkeypatch):
    """A run without ``spans`` reads the program's own summary; a program
    without obs (the parent of the change that brought it) gives nothing."""
    import builtins

    real = builtins.__import__

    def no_obs(name, globals=None, locals=None, fromlist=(), level=0):
        if name == "boltzfft_torch" and fromlist and "obs" in fromlist:
            raise ImportError("no obs")
        return real(name, globals, locals, fromlist, level)

    monkeypatch.setattr(builtins, "__import__", no_obs)
    assert spans.summary(_run()) is None
    assert all(harness.reader(m)(_run()) is None for m in SPAN_METRICS + COUNTER_METRICS)
