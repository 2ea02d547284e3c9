"""Known-answer self-checks (mirror of ``boltzfft/health.py``): evaluate the
collision operator on a small BKW problem on a chosen device and compare it
with the analytic ``bkw_dfdt``, or with a second pipeline on the same device
(:func:`selfcheck`), and the ds engine's oz route against its vpu route
(:func:`selfcheck_ds`), as callable probes with a pass/fail verdict.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

# Relative-Linf threshold (max|Q - Q_bkw| / max|Q_bkw|) for the probe config
# nv=24, ns=6, n_radial=12, t=6.5, the JAX package's calibration: its method
# error there is 4.12e-2 in float64, and float32 roundoff sits orders of
# magnitude below it, so one threshold (3x that) covers every impl.  A
# wrong-but-bounded Q, e.g. a mis-scaled loss term, lands at O(1).
_REL_TOL = 0.12
_PROBE_TIME = 6.5


def _open(device) -> torch.device:
    """``device`` as a torch device; CUDA without a card raises (no quiet
    fall-back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but torch.cuda.is_available() is False")
    return device


def selfcheck(
    nv: int = 24,
    ns: int = 6,
    n_radial: Optional[int] = None,
    dtype: Optional[str] = None,
    impl: Optional[str] = None,
    rel_tol: float = _REL_TOL,
    pre_transform: Optional[Callable] = None,
    cfg_kwargs: Optional[dict] = None,
    compare_impl: Optional[str] = None,
    device="cuda",
) -> dict:
    """Run a small end-to-end collision eval and compare it with the BKW
    oracle.

    Returns a dict with ``ok`` (bool), the relative Linf deviation, timing
    and the device.  ``device`` defaults to CUDA and raises without a card
    (pass ``device="cpu"`` for the plain versions); ``impl`` defaults to
    ``"fused"`` on CUDA and ``"rfft"`` on the CPU;
    ``dtype`` to float64.  ``pre_transform`` is a fault-injection hook: it
    receives the ``Precomp`` before the eval and returns the one to use.
    ``cfg_kwargs`` passes extra ``CollisionConfig`` fields (``fused_scheme``,
    ``use_pallas``, ``nvy``/``nvz``...).  ``compare_impl`` replaces the
    analytic oracle by a second pipeline evaluated on the same device (pass a
    matching ``rel_tol``).
    """
    import boltzfft_torch as bt

    device = _open(device)
    if dtype is None:
        dtype = "float64"
    if impl is None:
        impl = "fused" if device.type == "cuda" else "rfft"

    cfg = bt.CollisionConfig(
        nv=nv, ns=ns, n_radial=n_radial if n_radial is not None else nv // 2,
        dtype=dtype, impl=impl, **(cfg_kwargs or {}),
    )
    collide, pre = bt.make_collision_operator(cfg, device)
    if pre_transform is not None:
        pre = pre_transform(pre)
    g = cfg.velocity_grid
    rsq = g.r_squared()
    f = torch.as_tensor(bt.bkw_f(rsq, _PROBE_TIME), dtype=cfg.real_dtype, device=device)

    t0 = time.perf_counter()
    q = collide(f, pre)
    if compare_impl is not None:
        cfg_ref = dataclasses.replace(cfg, impl=compare_impl, use_pallas=False)
        collide_ref, pre_ref = bt.make_collision_operator(cfg_ref, device)
        q_exact = collide_ref(f, pre_ref)
    else:
        q_exact = torch.as_tensor(bt.bkw_dfdt(rsq, _PROBE_TIME), dtype=cfg.real_dtype,
                                  device=device)
    q_max = float(torch.max(torch.abs(q_exact)))
    rel_linf = float(torch.max(torch.abs(q - q_exact))) / q_max
    q_mass = float(torch.sum(q)) * g.cell_volume
    finite = bool(torch.all(torch.isfinite(q)))
    elapsed = time.perf_counter() - t0

    ok = finite and rel_linf < rel_tol
    return {
        "ok": ok,
        "finite": finite,
        "rel_linf": rel_linf,
        "rel_tol": rel_tol,
        "q_mass": q_mass,
        "elapsed_s": elapsed,
        "backend": device.type,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "config": {"nv": nv, "ns": ns, "dtype": dtype, "impl": impl},
    }


def selfcheck_ds(
    nv: int = 16,
    ns: int = 6,
    n_radial: Optional[int] = None,
    rel_tol: float = 1e-11,
    cfg_kwargs: Optional[dict] = None,
    symmetrize: bool = False,
    device="cuda",
    **collide_kwargs,
) -> dict:
    """Cross-engine known-answer probe of the ds pipeline: ``collide_ds`` with
    the oz engine (the kernels K7-K12 on CUDA, their plain versions
    on the CPU; any knob passes through ``collide_kwargs``) against the vpu
    engine on the same device, on a seeded Nyquist-rich positive noise input.
    The bound is the ds noise floor (~2^-49 relative; tolerance 1e-11): an
    exactness fault in a kernel lands orders of magnitude above it.
    ``symmetrize`` makes the input centrally symmetric (for ``g1_reversal``).
    ``device`` defaults to CUDA and raises without a card.  The oz engine
    takes its default g-stream for the device
    (:func:`ds_operator.default_g_stream`, as the JAX package does): the
    half streams on CUDA (K9, K12), the full streams on the CPU (K11's plain
    version), unless ``g_stream`` is passed; the half-path-only knobs
    (``group_batch``, ``g1_reversal``) need ``g_stream="half"`` on the
    CPU."""
    import numpy as np

    import boltzfft_torch as bt
    from boltzfft_torch import ds
    from boltzfft_torch.ds_operator import build_ds_precomp, collide_ds

    device = _open(device)
    cfg = bt.CollisionConfig(
        nv=nv, ns=ns, n_radial=n_radial if n_radial is not None else nv // 2,
        dtype="float32", impl="c2c", **(cfg_kwargs or {}),
    )
    pre = build_ds_precomp(cfg, device=device)
    rng = np.random.default_rng(12345)
    fm = np.abs(rng.standard_normal(cfg.grid_shape)) + 0.1
    if symmetrize:
        fm = 0.5 * (fm + fm[::-1, ::-1, ::-1])
    f = ds.from_f64(fm, torch.float32, device)
    t0 = time.perf_counter()
    q_oz = collide_ds(cfg, pre, f, contract="oz", **collide_kwargs)
    q_ref = collide_ds(cfg, pre, f, contract="vpu")
    dev = q_oz.hi - q_ref.hi + (q_oz.lo - q_ref.lo)
    rel = float(dev.abs().max()) / float(q_ref.hi.abs().max())
    finite = bool((torch.isfinite(q_oz.hi) & torch.isfinite(q_oz.lo)).all())
    elapsed = time.perf_counter() - t0
    return {
        "ok": finite and rel < rel_tol,
        "finite": finite,
        "rel_linf": rel,
        "rel_tol": rel_tol,
        "elapsed_s": elapsed,
        "backend": device.type,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "config": {"nv": nv, "ns": ns, **collide_kwargs},
    }
