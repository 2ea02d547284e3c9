"""The benchmark's 32^3 BKW cell as files (``portbench``): its configuration
is BASELINE config 1's grid and quadrature, the cell loads by name, and the
K1 counter readers reduce a made-up ``obs.summary()``."""

import json
import math
from pathlib import Path

import pytest

from portbench import cells, harness

ROOT = Path(__file__).resolve().parent.parent
BASELINE = json.loads((ROOT / "BASELINE.json").read_text())["configs"]


def test_the_32_cubed_configuration_is_baseline_config_1():
    text = BASELINE[0]
    for words in ("maxwell_bkw", "Maxwell molecules", "N=32³", "32-pt Gauss-Legendre", "ss005.012"):
        assert words in text
    cfg = cells.load_cell("bkw32.rk4")["config"]
    assert (cfg["nv"], cfg["n_radial"], cfg["ns"], cfg["gamma"]) == (32, 32, 12, 0.0)
    assert cfg["b_gamma"] == pytest.approx(1.0 / (4.0 * math.pi), rel=1e-15)
    assert cfg["support_radius"] == 5.0 and cfg["antipodal"] is True and cfg["dtype"] == "float64"
    assert "atomics.txt:13-21" in cfg["source"]
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (entry,) = [c for c in bench["configs"] if c["name"] == cfg["name"]]
    assert entry["reduced"] == [] and entry["file"] == "portbench/configs/bkw_v32_ns12_f64.json"


def test_the_32_cubed_cell_loads_by_name():
    cell = cells.load_cell("bkw32.rk4")
    assert cell["chips"] == 1 and cell["config"]["nv"] == 32
    # the 64^3 cell's traffic, unchanged: one distribution
    assert cell["traffic"] == cells.load_cell("bkw64.rk4")["traffic"]
    t = cell["traffic"]
    assert (t["solver"], t["initial"], t["method"], t["dt"], t["record"], t["restart_every"]) == (
        "relaxation", "bkw", "rk4", 0.125, "moments", 64)
    assert t["batch"] == 1 and t["t0"] == [5.5, 6.5]
    assert cell["settings"]["depth"] == 2 and cell["settings"]["profile_steps"] == 20
    assert set(cell["settings"]["limits"]) == {"step_err", "record_err"}
    assert [m["name"] for m in cell["metrics"]["end_to_end"]] == ["step_ms", "step_p95_ms", "setup_s"]
    assert [m["name"] for m in cell["metrics"]["per_layer"]] == ["k1_chunks_per_eval", "k1_stream_gib"]


def _run(config, batch, summary):
    run = harness.Run(config=config, chips=1, steps=4, window_s=2.0, step_ms=[500.0] * 4,
                      host_call_ms=[0.3], setup_s=9.0, capture_s=1.0, precomp_s=0.1,
                      evals_per_step=4, batch=batch, memory_peak_bytes=2**35)
    run.spans = summary
    return run


ENS = {"nv": 32, "ns": 12, "n_radial": 32, "dtype": "float64"}
BKW64 = {"nv": 64, "ns": 12, "n_radial": 64, "dtype": "float64"}
SUMMARY = {"counters": {"k1_plan": {
    "256x32x32x32": {"nodes_per_chunk": 48, "chunks_per_eval": 4, "split_yz": "dense",
                     "stream_bytes": 24 * 2**30, "free_bytes_at_settle": 78 * 2**30},
    # a program that notes no stream bytes (the fields before them)
    "1x64x64x64": {"nodes_per_chunk": 384, "chunks_per_eval": 1, "split_yz": "8x8"},
}}}


@pytest.mark.parametrize("config,batch,chunks,gib", [
    (ENS, 256, 4.0, 24.0),
    (BKW64, 1, 1.0, None),
    (ENS, 1, None, None),  # no launch at this shape: nothing to read
])
def test_k1_readers_reduce_a_summary(config, batch, chunks, gib):
    run = _run(config, batch, SUMMARY)
    assert harness.reader("k1_chunks_per_eval")(run) == chunks
    assert harness.reader("k1_stream_gib")(run) == gib


def test_k1_readers_read_nothing_without_the_counter():
    run = _run(ENS, 256, {"counters": {"captures": {}}})
    assert harness.reader("k1_chunks_per_eval")(run) is None
    assert harness.reader("k1_stream_gib")(run) is None
