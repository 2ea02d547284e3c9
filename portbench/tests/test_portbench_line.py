"""A run's last line carries the contract's keys; a machine without a card,
or a checkout without the program, gives no line and a non-zero exit."""

import os
import shutil
import subprocess
import sys

import pytest

from portbench import cells
from portbench.tests import small

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("name", ["bkw64.rk4", "tg2d.16x16.step"])
def test_last_line_keys(name):
    line = small.run(name)
    assert list(line)[:5] == KEYS and list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 2
    cell = small.cell(name)
    assert set(line["metrics"]) == {m["name"] for m in cell["metrics"]["end_to_end"]}
    assert all(set(v) == {"value", "unit"} for v in line["metrics"].values())
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(line["checks"]) == set(cell["settings"]["limits"])
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())


def test_traced_line_has_the_per_layer_metrics_and_a_breakdown():
    line = small.run("tg2d.16x16.step", trace=True)
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"replay_host_ms", "capture_s", "collision_ms", "precomp_s", "step_mfu",
            "collision_roofline"} <= set(line["metrics"])
    assert "halo_ms" not in line["metrics"]  # no NCCL kernel on one process
    assert "step_ms" not in line["metrics"]


def _run_py(cwd, env=None):
    return subprocess.run([sys.executable, "portbench/run.py", "--workload", "bkw64.rk4",
                           "--seed", str(2**31 + 11), "--seconds", "1", "--trace", "0"],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_no_card_no_line():
    env = dict(os.environ, PYTHONPATH="", CUDA_VISIBLE_DEVICES="")
    out = _run_py(cells.ROOT, env)
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "CUDA device" in out.stderr


def test_the_benchmark_alone_is_not_enough(tmp_path):
    shutil.copy(cells.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(cells.PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run_py(tmp_path, dict(os.environ, PYTHONPATH=""))
    assert out.returncode != 0
    assert "{" not in out.stdout


def test_samples_keep_first_last_and_a_seeded_draw():
    from portbench import check

    picks = []
    for _ in range(2):
        s = check.Samples(3, seed=99)
        for n in range(50):
            s.offer(n, n, n + 1, None)
        picks.append([it[0] for it in s.items()])
    assert picks[0] == picks[1]
    assert picks[0][0] == 0 and picks[0][-1] == 49 and len(picks[0]) == 5
    other = check.Samples(3, seed=100)
    for n in range(50):
        other.offer(n, n, n + 1, None)
    assert [it[0] for it in other.items()] != picks[0]
