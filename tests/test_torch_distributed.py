"""The port's multi-process start-up (``boltzfft_torch.distributed``):
``initialize_distributed`` from torchrun's environment (four gloo ranks over
TCP on this host), the multi-host mesh layout, and the rank's ensemble
slice, against the JAX package's functions of the same names."""

import inspect
import socket

import numpy as np
import pytest
import torch

import boltzfft as bz
import boltzfft_torch as bt
from torch_rank_worker import launch

ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = lambda r: dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE="4",
                         RANK=str(r), LOCAL_RANK=str(r % 2), LOCAL_WORLD_SIZE="2")
    return launch(4, ["dist_env"], tmp_path_factory.mktemp("ranks"), init=False, env=env)


def test_initialize_from_the_launchers_environment(ranks):
    assert [r["dist_env"]["init"] for r in ranks] == [(True, True)] * 4


def test_multihost_mesh_keeps_the_node_dim_in_a_host(ranks):
    # two hosts of two ranks (LOCAL_WORLD_SIZE=2): ensemble across, node within
    assert all(r["dist_env"]["mesh"] == ((bz.ENSEMBLE_AXIS, bz.NODE_AXIS), (2, 2)) for r in ranks)
    m = ranks[0]["dist_env"]
    assert m["per_host"] == "node_devices_per_host=3 must divide the 2 devices each host owns"
    assert "ensemble_hosts=False with multiple processes" in m["node_only"]


def test_ensemble_slice_per_rank(ranks):
    assert [r["dist_env"]["slice"] for r in ranks] == [(0, 2), (2, 2), (4, 2), (6, 2)]
    assert ranks[0]["dist_env"]["uneven"] == "ensemble size 7 must divide over 4 processes"


def test_ensemble_by_node_run_on_the_multihost_mesh(ranks):
    # each rank's members (E = 4 over 2 ensemble ranks, the nodes over 2)
    # against the port's unsharded collide
    assert all(r["dist_env"]["err"] <= 1e-13 for r in ranks)


def test_single_process_needs_no_group(monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    assert bt.initialize_distributed(device="cpu") is False
    assert not torch.distributed.is_initialized()
    assert bt.process_local_ensemble_slice(8) == bz.process_local_ensemble_slice(8) == (0, 8)


def test_signatures_follow_the_reference():
    for name in ("initialize_distributed", "make_multihost_mesh", "process_local_ensemble_slice"):
        ref = list(inspect.signature(getattr(bz, name)).parameters)
        got = inspect.signature(getattr(bt, name)).parameters
        assert list(got)[:len(ref)] == ref
        # the port's only extra parameter: the device, keyword-only
        assert [p for p in got if p not in ref] in ([], ["device"])
    dev = inspect.signature(bt.initialize_distributed).parameters["device"]
    assert dev.kind == dev.KEYWORD_ONLY and dev.default == "cuda"
    assert np.array_equal(bt.sharding.ENSEMBLE_AXIS, bz.ENSEMBLE_AXIS)
