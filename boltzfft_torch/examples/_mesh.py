"""The spatial examples' mesh: the JAX examples' layout rule on the ranks
of ``torch.distributed`` (one device each), and the cell gather."""

from __future__ import annotations


def mesh_dims(n_ranks: int, cells: int) -> tuple:
    """``(mx, my)`` over ``n_ranks`` ranks: 4 along x where the ranks and the
    cells divide by 4, else 2 where the ranks divide by 2, else 1; up to 2
    along y (the JAX examples' rule, which a process alone reads as 1 x 1)."""
    mx = 4 if n_ranks % 4 == 0 and cells % 4 == 0 else (2 if n_ranks % 2 == 0 else 1)
    return mx, max(1, min(n_ranks // mx, 2))


def spatial_mesh(cells: int, device):
    """A ``("cx", "cy")`` mesh over the ranks of the process group (one of
    this process alone when there is none); call inside ``cli.ranks``."""
    import torch.distributed as dist

    import boltzfft_torch as bt

    n = dist.get_world_size() if dist.is_initialized() else 1
    mx, my = mesh_dims(n, cells)
    return bt.make_mesh([("cx", mx), ("cy", my)], device=device)


def gather_cells(t, mesh):
    """The global ``(Cx, Cy)`` array of per-cell values from each rank's
    block ``t`` (every rank gets it)."""
    import torch
    import torch.distributed as dist

    if mesh.size() == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t.contiguous())
    layout = mesh.mesh.tolist()
    return torch.cat([torch.cat([parts[r] for r in row], dim=1) for row in layout], dim=0)
