"""Several processes: runtime start-up and the multi-host mesh layout (mirror
of ``boltzfft/distributed.py``), over ``torch.distributed``.

One process ("rank") drives one device.  A launcher such as ``torchrun``
starts the ranks and sets ``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``,
``RANK``, ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE``;
:func:`initialize_distributed` joins them into one process group (NCCL for
CUDA ranks, gloo on the CPU), and the sharded operators of
:mod:`boltzfft_torch.sharding` run over it::

    import boltzfft_torch as bt
    bt.initialize_distributed()          # torchrun's environment
    mesh = bt.make_multihost_mesh(ensemble_hosts=True)
    collide_fn, pre = bt.make_sharded_collision_operator(cfg, mesh, ...)

The layout rule of :func:`make_multihost_mesh`: the quadrature-node dim (one
``all_reduce`` per eval) stays inside a host, where NVLink carries it; only
the ensemble dim, which exchanges nothing per eval, crosses hosts.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from . import sharding as _sharding
from .sharding import ENSEMBLE_AXIS, NODE_AXIS, make_mesh


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
    *,
    device="cuda",
) -> bool:
    """Join this process to the ranks of a multi-process run (idempotent).

    With no arguments, reads the launcher's environment: ``MASTER_ADDR`` and
    ``MASTER_PORT`` (the coordinator), ``WORLD_SIZE`` and ``RANK``.
    ``coordinator_address`` is ``"host:port"`` (a TCP store) or a URL such as
    ``"file:///path"``.  On ``device="cuda"`` the rank takes the card
    ``local_device_ids[0]`` (default ``LOCAL_RANK`` modulo the cards it
    sees) and NCCL; on ``device="cpu"``, gloo.

    Returns ``True`` if a multi-process group is active after the call,
    ``False`` for a single process with nothing configured: a single
    process is never an error, so one driver runs on one card or many."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None:
        return False  # a plain single-process run
    if num_processes is None or process_id is None:
        raise ValueError(
            "initialize_distributed: a coordinator needs num_processes and process_id "
            "(or WORLD_SIZE and RANK)")
    device = torch.device(device)
    kw = {}
    if device.type == "cuda":
        if local_device_ids:
            card = int(local_device_ids[0])
        elif torch.cuda.is_available():
            card = int(env.get("LOCAL_RANK", 0)) % torch.cuda.device_count()
        else:
            card = None
        kw["device_id"] = _sharding._bind_card(card)
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(_sharding._backend_for(device.type), init_method=url,
                            world_size=num_processes, rank=process_id, **kw)
    return dist.get_world_size() > 1


def _world() -> Tuple[int, int]:
    """(ranks, this rank): (1, 0) without a process group."""
    if not dist.is_initialized():
        return 1, 0
    return dist.get_world_size(), dist.get_rank()


def make_multihost_mesh(
    node_devices_per_host: Optional[int] = None,
    ensemble_hosts: bool = True,
    *,
    device=None,
):
    """2-D ``(ensemble, node)`` mesh laid out so the node dim stays inside a
    host (its ``all_reduce`` on NVLink) and the ensemble dim spans hosts.

    A host is ``LOCAL_WORLD_SIZE`` consecutive ranks (torchrun numbers ranks
    host-major; default: every rank on one host).

    * ``node_devices_per_host``: node-dim span per host (default: all the
      ranks of a host).
    * ``ensemble_hosts=False`` asserts the run is node-only across hosts: it
      rejects several hosts, whose node ``all_reduce`` would cross them.  On
      one host it is only an assertion; the mesh is still 2-D, with ensemble
      size ``ranks // node_size``.

    ``device``: as for :func:`boltzfft_torch.make_mesh`."""
    world, _ = _world()
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if per_host < 1 or world % per_host:
        raise ValueError(f"LOCAL_WORLD_SIZE={per_host} must divide the {world} ranks")
    n_hosts = world // per_host
    node_size = node_devices_per_host or per_host
    if per_host % node_size:
        raise ValueError(
            f"node_devices_per_host={node_size} must divide the {per_host} "
            "devices each host owns"
        )
    ens_size = world // node_size
    if not ensemble_hosts and n_hosts > 1:
        raise ValueError(
            "ensemble_hosts=False with multiple processes would run the "
            "node-axis all_reduce across hosts; pass node_devices_per_host explicitly "
            "if that is really intended"
        )
    return make_mesh([(ENSEMBLE_AXIS, ens_size), (NODE_AXIS, node_size)], device=device)


def process_local_ensemble_slice(total: int) -> Tuple[int, int]:
    """(start, size) of this rank's block of a ``total``-member ensemble
    (a process drives one device here, so a process's block is a rank's)."""
    n, rank = _world()
    if total % n:
        raise ValueError(f"ensemble size {total} must divide over {n} processes")
    size = total // n
    return rank * size, size
