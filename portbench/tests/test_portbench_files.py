"""Cells, configurations, traffic, settings and metric readers are files
found by name; BENCHMARK.json keeps to the contract's shapes."""

import json
import math
import re

import pytest

from portbench import cells, harness, solvers, work

BENCH = json.loads((cells.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_load_by_name(name):
    cell = cells.load_cell(name)
    entry = next(w for w in BENCH["workloads"] if w["name"] == name)
    assert cell["chips"] == entry["chips"] in (1, 4)
    assert solvers.kind(cell["traffic"]["solver"]).port_unit
    assert set(cell["settings"]) == {"depth", "profile_steps", "limits"}
    assert set(cell["settings"]["limits"]) <= {"step_err", "record_err"}
    assert {m["name"] for m in cell["metrics"]["end_to_end"]} >= {"step_ms", "step_p95_ms", "setup_s"}
    assert cell["metrics"]["per_layer"], "every cell reports a per-layer metric"
    # the configuration's numbers are those its work count reads
    assert work.eval_flops(cell["config"]) > 0


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_every_metric_has_a_reader(metric):
    assert callable(harness.reader(metric))


def test_names_units_and_limits_keep_to_the_contract():
    assert BENCH["command"] == ["python3", "portbench/run.py"] and BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [m["name"] for m in METRICS]
    assert all(NAME.match(n) for n in names)
    assert len(set(CELLS)) == len(CELLS) and len({m["name"] for m in METRICS}) == len(METRICS)
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") for m in METRICS)
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(CELLS) // 4)
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/") and not c["reduced"]
        assert len(c["source"]) <= 200 and len(c["why"]) <= 200
    assert all(len(w["why"]) <= 200 for w in BENCH["workloads"])
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_a_cell_added_by_files_alone(tmp_path, monkeypatch):
    """A later cell needs a traffic file, a settings file and entries:
    nothing of the harness changes."""
    monkeypatch.setattr(cells, "PKG", tmp_path)
    for sub in ("traffic", "workloads"):
        (tmp_path / sub).mkdir()
    (tmp_path / "traffic" / "bkw_rk2.json").write_text(json.dumps(
        {"solver": "relaxation", "initial": "bkw", "t0": [5.5, 6.5], "method": "rk2",
         "dt": 0.0625, "record": "moments"}))
    (tmp_path / "workloads" / "bkw64.rk2.json").write_text(json.dumps(
        {"depth": 2, "profile_steps": 10, "limits": {"step_err": 1e-9, "record_err": 1e-12}}))
    bench = dict(BENCH, workloads=BENCH["workloads"] + [
        {"name": "bkw64.rk2", "config": "bkw_v64_ns12_f64", "traffic": "bkw_rk2", "chips": 1,
         "why": "example"}])
    cell = cells.load_cell("bkw64.rk2", bench)
    assert cell["traffic"]["method"] == "rk2" and cell["config"]["nv"] == 64
    assert [m["name"] for m in cell["metrics"]["end_to_end"]] == ["step_ms", "step_p95_ms", "setup_s"]
    # per-layer metrics list their cells: the new cell reports none until listed
    assert cell["metrics"]["per_layer"] == []


def test_metric_readers_reduce_a_run():
    run = harness.Run(config={"nv": 16, "ns": 12, "n_radial": 16, "dtype": "float64"},
                      chips=1, steps=4, window_s=0.04, step_ms=[10.0, 10.0, 10.0, 12.0],
                      host_call_ms=[0.2, 0.4], setup_s=3.0, capture_s=0.1, precomp_s=0.05,
                      evals_per_step=2, batch=256, memory_peak_bytes=2**31, collision_ms=4.0,
                      profile={"busy_s": 0.019, "window_s": 0.02, "nccl_s": 0.0, "steps": 2})
    read = {m["name"]: harness.reader(m["name"])(run) for m in METRICS}
    assert read["step_ms"] == pytest.approx(10.0)
    assert read["step_p95_ms"] == pytest.approx(11.7)
    assert read["replay_host_ms"] == pytest.approx(0.3)
    assert read["transport_ms"] == pytest.approx(9.5 - 8.0)
    assert read["halo_ms"] is None  # no NCCL kernel: nothing to read
    assert read["device_idle_pct"] == pytest.approx(5.0)
    assert read["device_peak_gib"] == pytest.approx(2.0)
    least = work.least_seconds(run.config, 256) * 1e3
    assert read["collision_roofline"] == pytest.approx(100 * least / 4.0)
    assert read["step_mfu"] == pytest.approx(100 * 2 * work.eval_flops(run.config, 256) / 0.01 / 67e12)
    assert math.isfinite(read["setup_s"])


def test_a_solver_added_by_a_file_alone(tmp_path, monkeypatch):
    """A new solver is a module ``traffic/<solver>.py`` found by the name a
    traffic file gives."""
    import torch

    monkeypatch.setattr(cells, "PKG", tmp_path)
    (tmp_path / "traffic").mkdir()
    (tmp_path / "traffic" / "echo.py").write_text(
        "def draw(problem, rng):\n    return {'a': float(rng.uniform())}\n\n"
        "def dt(problem):\n    return 0.5 * problem.traffic['scale']\n")
    solvers.kind.cache_clear()
    try:
        problem = solvers.Problem({"nv": 4}, {"solver": "echo", "scale": 3.0}, 1,
                                  torch.device("cpu"))
        assert problem.dt == 1.5 and 0.0 <= problem.params["a"] < 1.0
        with pytest.raises(KeyError):
            solvers.kind("missing")
    finally:
        solvers.kind.cache_clear()


def test_a_relaxation_batch_is_a_traffic_key():
    """``batch`` distributions in one relaxation, each from its own drawn
    time: the ensemble cells of later PRs are data."""
    from portbench.tests import small

    cell = small.cell("bkw64.rk4")
    cell["traffic"].update(batch=3)
    line = small.run("bkw64.rk4", the_cell=cell)
    assert line["correct"] is True and line["attempted"] > 2
    import torch

    problem = solvers.Problem(cell["config"], cell["traffic"], 5, torch.device("cpu"))
    x0 = problem.initial_state()
    assert problem.batch == 3 and tuple(x0.shape) == (3, 8, 8, 8)
    assert len(set(problem.params["t0"])) == 3 and not torch.equal(x0[0], x0[1])


def test_restart_every_starts_the_state_again():
    import torch

    seen = []

    def step(x, _pre):
        seen.append(float(x))
        return x + 1.0, None

    unit = solvers.Unit(step, None, None, torch.zeros(()), (), 1, 0.0, restart_every=3)
    left = [7]

    def keep_going(_elapsed, _n):
        left[0] -= 1
        return left[0] >= 0

    n, *_rest, x, error = harness.dispatch(unit, unit.x0, torch.device("cpu"), 2, keep_going)
    assert n == 7 and error is None
    assert seen == [0.0, 1.0, 2.0, 0.0, 1.0, 2.0, 0.0] and float(x) == 1.0


def test_reference_tables_are_built_after_the_window(monkeypatch):
    """The reference's tables are its own seconds: none of them in set-up."""
    from portbench.reference import spectral
    from portbench.tests import small

    events = []
    tables, dispatch = spectral.tables, harness.dispatch

    def counted_tables(*a, **kw):
        events.append("tables")
        return tables(*a, **kw)

    def counted_dispatch(*a, **kw):
        events.append("window")
        return dispatch(*a, **kw)

    monkeypatch.setattr(spectral, "tables", counted_tables)
    monkeypatch.setattr(harness, "dispatch", counted_dispatch)
    assert small.run("tg2d.16x16.step")["correct"] is True
    assert events[0] == "window" and "tables" in events
