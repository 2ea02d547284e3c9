"""The port's transport CLIs on the CPU (plain versions of the kernels):
the runs pass their gates and print boltzfft's lines, ``--impl auto``
resolves by device, and what is not ported yet raises."""

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


@pytest.mark.parametrize("main,flag", [
    (sod_1d3v.main, ["--mesh-cells", "2"]),
    (taylor_green_2d3v.main, ["--mesh", "2x2"]),
    (taylor_green_3d3v.main, ["--mesh", "2x2x2"]),
])
def test_mesh_not_ported(main, flag):
    with pytest.raises(NotImplementedError, match="step 4"):
        main(SMALL + flag)


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
