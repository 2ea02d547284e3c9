"""Several devices: meshes and sharded collision operators (mirror of
``boltzfft/sharding.py``), over ``torch.distributed``.

One process ("rank") drives one device.  A mesh is a
:class:`torch.distributed.device_mesh.DeviceMesh` with named dims, and every
array is rank-local: :func:`place` returns this rank's node rows of a
precomp, :func:`place_cells` this rank's block of cells, and a sharded
``collide_fn`` takes and returns the rank's block.  The JAX package's
``shard_map`` collectives become the mesh dim's process group: ``psum`` an
``all_reduce``, ``all_gather`` an ``all_gather``, ``ppermute`` sends and
receives (``transport._halo_exchange``).  The backend is NCCL for CUDA
ranks and gloo on the CPU.

* **Node-axis sharding**: each rank evaluates its shard of the quadrature
  batch against a replicated ``f``; one ``all_reduce`` over the node dim
  combines the partial gain spectra (the ``gain_reduce`` hook of
  :func:`boltzfft_torch.operator.collide`: on the fused ct route K2, then
  the hook; on ``rfft + use_pallas`` K6 and K5 per chunk, then the hook).
  No transform axis is ever sharded.
* **Ensemble sharding**: independent distributions spread over the ranks,
  with no communication.

Both compose on one 2-D mesh ``(ensemble, node)``.  Padded quadrature
entries carry zero gain weight, so uneven node counts shard cleanly.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from . import _graph, obs
from .kernels import fused_collide as _k1
from .operator import collide
from .weights import CollisionConfig, Precomp, build_precomp, repad_nodes

ENSEMBLE_AXIS = "ensemble"
NODE_AXIS = "node"


def _backend_for(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def _start_single_rank(device: torch.device) -> None:
    """A process group of this one process, in process (a ``HashStore``)."""
    kw = {}
    if device.type == "cuda":
        kw["device_id"] = _bind_card(device.index)
    dist.init_process_group(_backend_for(device.type), store=dist.HashStore(), rank=0,
                            world_size=1, **kw)


def _bind_card(index: Optional[int]) -> torch.device:
    """Make card ``index`` (default the current one) this process's device;
    NCCL binds its communicators to it."""
    if not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but torch.cuda.is_available() is False")
    torch.cuda.set_device(torch.cuda.current_device() if index is None else index)
    return torch.device("cuda", torch.cuda.current_device())


def make_mesh(
    axis_sizes: Sequence[Tuple[str, int]] | None = None,
    devices: Optional[Sequence[int]] = None,
    *,
    device=None,
) -> DeviceMesh:
    """A mesh over ranks, one device each (collective: every rank calls it).

    ``axis_sizes`` is an ordered list of ``(name, size)``; it defaults to
    every rank on one ``"node"`` dim.  Example: ``make_mesh([("ensemble",
    2), ("node", 4)])`` on 8 ranks.  ``devices``: the global ranks to lay out
    (default every rank, in order); the mesh takes the first ones it needs.

    With no process group, one of this process alone is started in process
    on ``device`` (default the card, NCCL; ``device="cpu"``: gloo).  With
    one, ``device`` defaults to its backend's: the card for NCCL, else the
    CPU (gloo ranks that share a card pass ``device="cuda"``)."""
    if not dist.is_initialized():
        _start_single_rank(torch.device("cuda" if device is None else device))
    if device is None:
        device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    ranks = list(range(dist.get_world_size())) if devices is None else [int(r) for r in devices]
    if axis_sizes is None:
        axis_sizes = [(NODE_AXIS, len(ranks))]
    names = tuple(n for n, _ in axis_sizes)
    shape = tuple(int(s) for _, s in axis_sizes)
    n_req = math.prod(shape)
    if n_req > len(ranks):
        raise ValueError(f"mesh {dict(axis_sizes)} needs {n_req} devices, have {len(ranks)}")
    layout = torch.tensor(ranks[:n_req], dtype=torch.int).reshape(shape)
    return DeviceMesh(torch.device(device).type, layout, mesh_dim_names=names)


def axis_size(mesh: DeviceMesh, name: Optional[str]) -> int:
    """Ranks along the mesh dim ``name`` (1 for ``None``)."""
    if name is None:
        return 1
    if name not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"mesh has no axis {name!r}; its axes are {mesh.mesh_dim_names}")
    return mesh.size(mesh.mesh_dim_names.index(name))


def axis_index(mesh: DeviceMesh, name: Optional[str]) -> int:
    """This rank's coordinate along the mesh dim ``name`` (0 for ``None``)."""
    if name is None:
        return 0
    axis_size(mesh, name)
    if mesh.get_coordinate() is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh {mesh}")
    return mesh.get_local_rank(name)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device: the current card for a CUDA mesh, else the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _node_sharded_precomp(cfg: CollisionConfig, n_shards: int, device) -> Precomp:
    """Precomp whose node axis divides evenly into ``n_shards`` shards (and
    chunks): fused shards hold whole radial groups (K1-K4 sum each group of
    ``ns_eff`` consecutive nodes with one rho), and with ``node_chunk`` set,
    whole chunks."""
    pre = build_precomp(cfg, device)
    have = pre.rho.shape[0]
    want = cfg.n_nodes
    while True:
        local = -(-want // n_shards)
        if cfg.impl == "fused":
            local = -(-local // cfg.ns_eff) * cfg.ns_eff
        if cfg.node_chunk is not None:
            c = cfg.chunk(device)
            local = -(-local // c) * c
        if n_shards * local >= have:
            return repad_nodes(pre, n_shards * local)
        want = have  # the device's own chunk padding went past the shards


def _rows(pre: Precomp, n: int, k: int) -> Precomp:
    """Shard ``k`` of ``n`` of the node rows (the rest replicated)."""
    b = pre.rho.shape[0]
    if b % n:
        raise ValueError(f"{b} nodes do not divide over {n} shards")
    s = slice(k * (b // n), (k + 1) * (b // n))
    return dataclasses.replace(pre, rho=pre.rho[s], sigma=pre.sigma[s], gain_w=pre.gain_w[s])


def place(pre: Precomp, mesh: DeviceMesh, node_axis: Optional[str] = NODE_AXIS) -> Precomp:
    """This rank's precomp on its device: its shard of the node rows along
    ``node_axis`` (``None``: all of them); every other table whole."""
    dev = mesh_device(mesh)
    if pre.device != dev:
        pre = pre.to(dev)
    return _rows(pre, axis_size(mesh, node_axis), axis_index(mesh, node_axis))


def place_cells(
    f: torch.Tensor,
    mesh: DeviceMesh,
    x_axis: Optional[str] = None,
    y_axis: Optional[str] = None,
    z_axis: Optional[str] = None,
) -> torch.Tensor:
    """This rank's block of a spatially decomposed distribution, on its
    device: the leading cell axes of ``f`` ``(Cx[, Cy[, Cz]], Nvx, Nvy,
    Nvz)`` cut along the mesh dims ``x_axis`` / ``y_axis`` / ``z_axis``
    (``None``: that cell axis whole).  The velocity axes are never cut."""
    n_cell_axes = f.dim() - 3
    if n_cell_axes not in (1, 2, 3):
        raise ValueError(f"expected (Cx[, Cy[, Cz]], Nvx, Nvy, Nvz), got {f.dim()}-d input")
    for axis, name in enumerate((x_axis, y_axis, z_axis)[:n_cell_axes]):
        n = axis_size(mesh, name)
        c = f.shape[axis]
        if c % n:
            raise ValueError(f"{c} cells along axis {axis} do not divide over {n} ranks of {name!r}")
        f = f.narrow(axis, axis_index(mesh, name) * (c // n), c // n)
    return f.to(mesh_device(mesh))


def _all_reduce(group):
    def reduce(x: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(x, group=group)
        return x

    return reduce


def _replay(fn: Callable, groups, what: str, name: str) -> Callable:
    """``fn(f, pre)`` replayed from a CUDA graph (the unit ``name``): where
    the process ``groups`` it communicates over (None entries: no traffic)
    are all NCCL's (the capture takes their collectives too).  A gloo
    collective cannot be captured, so that raises."""
    for group in groups:
        if group is not None and dist.get_backend(group) != "nccl":
            raise ValueError(
                f"{what}(jit=True) replays a CUDA graph, which cannot capture the "
                f"{dist.get_backend(group)} collective of this mesh; pass jit=False")
    return _graph.Replayed(fn, name)


def local_precomp(pre: Precomp, mesh: DeviceMesh, node_axis: Optional[str],
                  n_global: int) -> Precomp:
    """``pre`` as this rank's shard: the padded global precomp (its rows
    taken here, once per precomp, and kept in ``pre.derived``) or the shard
    :func:`place` returned."""
    b = pre.rho.shape[0]
    n = axis_size(mesh, node_axis)
    if b == n_global // n:
        return pre
    if b != n_global:
        raise ValueError(
            f"precomp with {b} nodes: expected the sharded operator's {n_global} or this "
            f"rank's {n_global // n}")
    key = ("placed", mesh, node_axis)
    if key not in pre.derived:
        pre.derived[key] = place(pre, mesh, node_axis)
    return pre.derived[key]


def make_sharded_collision_operator(
    cfg: CollisionConfig,
    mesh: DeviceMesh,
    node_axis: Optional[str] = NODE_AXIS,
    ensemble_axis: Optional[str] = None,
    jit: bool = True,
) -> Tuple[Callable[[torch.Tensor, Precomp], torch.Tensor], Precomp]:
    """A collision operator sharded over ``mesh``, on this rank's device.

    * ``node_axis`` (optional): the mesh dim sharding the quadrature-node
      batch; the gain reduction is one ``all_reduce`` over its group (no
      hook when it has one rank, as in the JAX package).
    * ``ensemble_axis`` (optional): the mesh dim sharding a leading ensemble
      axis of ``f``; ``f`` is then this rank's block ``(E_local, N, N, N)``.

    Returns ``(collide_fn, precomp)``: ``precomp`` is the padded global one
    (its node axis divides over ``node_axis``); ``collide_fn(f, precomp)``
    takes it or this rank's shard from :func:`place`, and returns this
    rank's block of Q.

    ``jit=True`` on CUDA replays the eval from a CUDA graph, as
    :func:`boltzfft_torch.make_collision_operator` does; an NCCL
    ``all_reduce`` is captured with it, and a gloo one raises (pass
    ``jit=False``).  On the CPU ``jit`` changes nothing."""
    if node_axis is None and ensemble_axis is None:
        raise ValueError("need at least one of node_axis/ensemble_axis")
    device = mesh_device(mesh)
    if cfg.impl == "fused" and device.type == "cuda":
        _k1.check_grid(cfg.grid_shape, cfg.real_dtype)
    n_node = axis_size(mesh, node_axis)
    axis_size(mesh, ensemble_axis)
    pre = _node_sharded_precomp(cfg, n_node, device)
    n_global = pre.rho.shape[0]
    group = mesh.get_group(node_axis) if node_axis and n_node > 1 else None
    hook = _all_reduce(group) if group is not None else None

    def body(f, p):
        if ensemble_axis is not None and f.dim() != 4:
            raise ValueError(
                f"an ensemble-sharded operator takes this rank's block (E, Nx, Ny, Nz), "
                f"got {tuple(f.shape)}")
        with obs.span("collide", like=f):
            return collide(cfg, p, f, gain_reduce=hook)

    run = body
    if jit and device.type == "cuda":
        run = _replay(body, [group], "make_sharded_collision_operator", "sharded_collide")

    def collide_fn(f, precomp):
        if run is not body and torch.is_grad_enabled() and f.requires_grad:
            raise RuntimeError(
                "make_sharded_collision_operator(jit=True) replays a CUDA graph, which has no"
                " backward; build the operator with jit=False to differentiate")
        return run(f, local_precomp(precomp, mesh, node_axis, n_global))

    return collide_fn, pre
