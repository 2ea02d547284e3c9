"""The port's transport CLIs on the CPU (plain versions of the kernels):
the runs pass their gates and print boltzfft's lines, ``--impl auto``
resolves by device, and the sharded flags (``--mesh``, ``--mesh-cells``,
``ensemble_bkw``) on gloo ranks print the JAX drivers' lines."""

import inspect

import pytest
import torch

from boltzfft_torch import CollisionConfig
from boltzfft_torch.cli import resolve_impl, sod_1d3v, taylor_green_2d3v, taylor_green_3d3v

SMALL = ["--Nv", "8", "--Ns", "6", "--steps", "2", "--n-radial", "4", "--device", "cpu"]


def test_resolve_impl():
    assert resolve_impl("auto", "cpu") == "rfft"
    assert resolve_impl("auto", "cuda") == "fused"
    assert resolve_impl("c2c", "cuda") == "c2c"


def test_sod_runs(capsys):
    assert sod_1d3v.main(SMALL + ["--nx", "8"]) == 0
    out = capsys.readouterr().out
    assert "Sod 1D×3V: nx=8" in out and "impl=rfft" in out
    assert "H trace" in out and "density profile" in out


@pytest.mark.parametrize("impl", ["auto", "fused"])
def test_taylor_green_2d_runs_and_decays(capsys, impl):
    assert taylor_green_2d3v.main(
        SMALL + ["--cells", "4", "--mass-tol", "0.05", "--impl", impl]) == 0
    out = capsys.readouterr().out
    assert "bulk-KE" in out and "cells batched" in out
    assert f"impl={'rfft' if impl == 'auto' else 'fused'}" in out


def test_taylor_green_3d_runs_and_decays(capsys):
    assert taylor_green_3d3v.main(
        SMALL + ["--cells", "4", "--mass-tol", "0.05", "--conserve"]) == 0
    out = capsys.readouterr().out
    assert "bulk-KE" in out and "H trace" in out


# The sharded flags on gloo ranks (tests/torch_rank_worker.py), each against
# the JAX driver with the same flags on its virtual CPU devices: the lines
# of reduced moments agree (the timing and mesh lines are each run's own).
SHARDED = {  # case -> (ranks, driver, flags, the lines compared)
    "ensemble": (2, "ensemble_bkw", ["--ensemble", "4", "--ens-mesh", "2"],
                 ("final mass range", "final temperature range", "H range")),
    "sod": (2, "sod_1d3v", ["--nx", "8", "--n-radial", "4", "--mesh-cells", "2"],
            ("total mass", "H trace", "H:", "  x=")),
    "tg2d": (4, "taylor_green_2d3v", ["--cells", "4", "--n-radial", "4", "--mesh", "2x2",
                                      "--mass-tol", "0.05"],
             ("total mass", "bulk-KE", "H trace", "H:")),
    "tg3d": (4, "taylor_green_3d3v", ["--cells", "4", "--n-radial", "4", "--mesh", "2x2x1",
                                      "--mass-tol", "0.05"],
             ("total mass", "bulk-KE", "H trace", "H:")),
}
SHARED = ["--Nv", "8", "--Ns", "6", "--steps", "2"]


def _case(key):
    world, driver, flags, _ = SHARDED[key]
    return ":".join(["cli", driver] + flags + SHARED + ["--device", "cpu"])


@pytest.fixture(scope="module")
def sharded_runs(tmp_path_factory):
    from torch_rank_worker import launch

    tmp = tmp_path_factory.mktemp("ranks")
    out = {}
    for world in sorted({w for w, *_ in SHARDED.values()}):
        keys = [k for k, v in SHARDED.items() if v[0] == world]
        res = launch(world, [_case(k) for k in keys], tmp)
        for k in keys:
            out[k] = [r[_case(k)] for r in res]
    return out


@pytest.mark.parametrize("key", list(SHARDED))
def test_sharded_flags_match_the_reference_driver(sharded_runs, key):
    import contextlib
    import importlib
    import io

    world, driver, flags, prefixes = SHARDED[key]
    runs = sharded_runs[key]
    assert [r["rc"] for r in runs] == [0] * world
    assert all(r["out"] == "" for r in runs[1:])  # rank 0 prints
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert importlib.import_module(f"boltzfft.cli.{driver}").main(flags + SHARED) == 0
    pick = lambda text: [ln for ln in text.splitlines() if ln.startswith(prefixes)]
    got, want = pick(runs[0]["out"]), pick(buf.getvalue())
    assert got and got == want
    if key in ("tg2d", "tg3d"):
        dims = flags[flags.index("--mesh") + 1]
        assert f"(spatial decomposition {dims} devices" in runs[0]["out"]


def test_bad_mesh_split_is_a_parser_error():
    with pytest.raises(SystemExit):
        taylor_green_2d3v.main(SMALL + ["--cells", "6", "--mesh", "4x2"])
    with pytest.raises(SystemExit):
        taylor_green_3d3v.main(SMALL + ["--cells", "4", "--mesh", "2x2"])


def test_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="is_available"):
        taylor_green_2d3v.main(["--Nv", "8", "--Ns", "6", "--cells", "2"])


@pytest.mark.parametrize("make,cells", [
    (taylor_green_2d3v.taylor_green_f0, (3, 3)),
    (taylor_green_3d3v.taylor_green_f0_3d, (3, 3, 3)),
])
def test_initial_data_defaults_to_the_card(make, cells):
    # an entry point runs on the card unless asked for the CPU
    assert inspect.signature(make).parameters["device"].default == "cuda"
    cfg = CollisionConfig(nv=8, ns=6)
    f = make(cfg, 3, u0=0.8, temperature=3.0, device="cpu")
    assert f.device.type == "cpu" and tuple(f.shape) == cells + (8, 8, 8)
    assert f.dtype == cfg.real_dtype and bool((f > 0).all())
