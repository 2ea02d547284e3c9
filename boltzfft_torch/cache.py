"""Precompute serialization (mirror of the precomp half of ``boltzfft/cache.py``).

``save_precomp`` / ``load_precomp`` write and read the JAX package's format:
one ``.npz`` archive holding the configuration as JSON under ``__config__``
and each table of the ``Precomp`` that is not ``None`` as ``arr_<name>``.  An
archive written by ``boltzfft.save_precomp`` loads here, and one written here
loads in ``boltzfft.load_precomp``: the port's configuration fields are a
subset of the JAX package's.

``pre.derived`` (the node chunks settled at the first eval, K3's tables) is
never written: the loaded tables settle their own on the loading device.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from .weights import CollisionConfig, Precomp, precomp_from_numpy

#: The JAX configuration's TPU kernel tiling fields, which the port's
#: ``CollisionConfig`` leaves out; an archive's values for them are dropped.
TPU_FIELDS = ("fused_nodes_per_step", "fused_radix", "fused_sub_batch")


def save_precomp(path: str | Path, cfg: CollisionConfig, pre: Precomp) -> None:
    """Serialize (config, precomp) to an .npz archive."""
    arrays = {
        f"arr_{f.name}": getattr(pre, f.name).detach().cpu().numpy()
        for f in dataclasses.fields(Precomp)
        if getattr(pre, f.name) is not None
    }
    np.savez_compressed(
        path, __config__=json.dumps(dataclasses.asdict(cfg)), **arrays
    )


def load_precomp(path: str | Path, *, device="cuda") -> tuple[CollisionConfig, Precomp]:
    """Load (config, precomp); the tables are placed on ``device`` (CUDA
    unless the caller asks for the CPU) in the config's dtype."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but torch.cuda.is_available() is False")
    with np.load(path, allow_pickle=False) as z:
        data = json.loads(str(z["__config__"]))
        # Archives written before the antipodal-pair reduction existed were
        # built from the full design; defaulting the missing key to False
        # keeps cfg.ns_eff consistent with the stored node tables (the new
        # default True would silently mis-group the radial hoisting).
        data.setdefault("antipodal", False)
        for name in TPU_FIELDS:
            data.pop(name, None)
        cfg = CollisionConfig(**data)
        arrays = {
            f.name: z[f"arr_{f.name}"]
            for f in dataclasses.fields(Precomp)
            if f"arr_{f.name}" in z.files
        }
    return cfg, precomp_from_numpy(arrays, device=device, dtype=cfg.dtype)
