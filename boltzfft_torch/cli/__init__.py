"""Command-line drivers of the port (argparse, flags of the reference drivers).

    python -m boltzfft_torch.cli.maxwell_bkw --Nv 32 --Ns 12 --impl fused --trials 10
    python -m boltzfft_torch.cli.maxwell_bkw --Nv 32 --Ns 12 --impl fused --steps 10
    python -m boltzfft_torch.cli.maxwell_bkw --Nv 64 --Ns 12 --impl ds --trials 3
    python -m boltzfft_torch.cli.fft_benchmark --Nv 32 --Ns 12
    python -m boltzfft_torch.cli.loop_benchmark --Nv 32 --Ns 12 --tile-size 4 8 16
    python -m boltzfft_torch.cli.sod_1d3v --Nv 16 --nx 32 --steps 20
    python -m boltzfft_torch.cli.taylor_green_2d3v --cells 16 --steps 20
    python -m boltzfft_torch.cli.taylor_green_3d3v --cells 8 --steps 10
    python -m boltzfft_torch.cli.ensemble_bkw --ensemble 256 --Nv 32 --impl fused --steps 2
    torchrun --nproc-per-node 4 -m boltzfft_torch.cli.taylor_green_2d3v --mesh 2x2

A sharded driver (``--mesh``, ``--mesh-cells``, ``ensemble_bkw``) runs one
rank per device under a launcher such as ``torchrun`` (NCCL on the cards,
gloo with ``--device cpu``); rank 0 prints its lines from moments reduced
over every rank.  The spatial drivers chain their steps as the JAX drivers'
``lax.scan`` does, through :func:`step_body` and :func:`march`: on the card
each step and its diagnostics replay from one CUDA graph.
"""

from __future__ import annotations

import argparse
import contextlib
import math


def standard_parser(description: str) -> argparse.ArgumentParser:
    """Shared flags: grid, quadrature, trials, dtype, impl, device, VHS kernel."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--Nv", type=int, default=32, help="velocity grid points per axis")
    p.add_argument("--Nvy", type=int, default=None,
                   help="y-axis grid points (default: Nv)")
    p.add_argument("--Nvz", type=int, default=None,
                   help="z-axis grid points (default: Nv)")
    p.add_argument("--Ns", type=int, default=12, help="spherical design size")
    p.add_argument("-t", "--trials", type=int, default=1, help="timing trials")
    p.add_argument("--dtype", choices=["float32", "float64"], default="float64",
                   help="compute dtype")
    p.add_argument(
        "--impl", choices=["auto", "rfft", "c2c", "dft", "fused", "ds"], default="rfft",
        help="pipeline: rfft (real transforms), c2c (complex transforms), "
             "dft (per-axis DFT einsums), fused (the hand-written CUDA "
             "kernels: the whole eval in K1, or K3 with its cuFFT finale "
             "where Nvy*Nvz <= 64; their plain PyTorch versions on --device "
             "cpu), ds (compensated double-single, float32 pairs: the Ozaki "
             "kernels K7-K12 on CUDA); auto = fused on a CUDA device, "
             "rfft on the CPU",
    )
    p.add_argument(
        "--ds-contract", choices=["vpu", "oz", "ozk"], default=None,
        help="ds transform engine (--impl ds only): vpu = compensated rank-1 "
             "updates in plain PyTorch (the bit reference), oz = the Ozaki "
             "kernels (ozk is the same engine); default oz on CUDA, vpu on the CPU",
    )
    p.add_argument(
        "--oz-cmax", type=int, default=None,
        help="Ozaki slice-pair retention of the ds oz engine (default 6 = "
             "every reference digit; 4 = ~1.6e-11 at 64^3)",
    )
    p.add_argument(
        "--g-stream", choices=["full", "half"], default=None,
        help="ds inverse-stream formulation: half = the exact half-spectrum "
             "Nyquist-block decomposition (the oz default on CUDA), full = "
             "direct complex streams (oz: K8, then K11's Hadamard sum; the "
             "vpu and CPU default)",
    )
    p.add_argument(
        "--group-batch", type=int, default=None,
        help="ds half path: radial groups per launch set (must divide the "
             "radial group count; default 2 on grids <= 32/axis on CUDA)",
    )
    p.add_argument(
        "--oz-merge", choices=["on", "off"], default=None,
        help="ds oz engine: K-merged complex contractions where merge_ok "
             "holds (default on)",
    )
    p.add_argument(
        "--gmain-fused", choices=["auto", "off", "3", "12"], default="auto",
        help="ds half path: the fused main block. auto = K9 ('3') on grids "
             "up to ~40^3 on CUDA, off = staged K8, 3 = force K9, 12 = K10 "
             "(y and x fused, z-blocked) then the half-z stage through K8",
    )
    p.add_argument(
        "--g1-reversal", action="store_true",
        help="ds half path, opt-in: stream 1 from stream 2 by velocity "
             "reversal, exact only for centrally symmetric f (the BKW states "
             "maxwell_bkw evaluates)",
    )
    p.add_argument(
        "--device", default="cuda",
        help="torch device: cuda (raises if there is no card) or cpu",
    )
    p.add_argument("--node-chunk", type=int, default=None,
                   help="quadrature nodes per staged chunk (memory/speed tradeoff)")
    p.add_argument("--n-radial", type=int, default=None,
                   help="Gauss-Legendre radial points (default: Nv)")
    p.add_argument("--gamma", type=float, default=0.0,
                   help="VHS velocity exponent (0=Maxwell, 1=hard spheres)")
    p.add_argument("--b-gamma", type=float, default=None,
                   help="VHS kernel coefficient (default 1/(4*pi))")
    p.add_argument(
        "--no-antipodal", dest="antipodal", action="store_false",
        help="evaluate all Ns spherical nodes instead of the exact "
             "antipodal-pair reduction (Ns/2 nodes, 2x weights)",
    )
    return p


def vhs_kwargs(args) -> dict:
    """CollisionConfig kwargs for the VHS kernel flags."""
    b_gamma = args.b_gamma if args.b_gamma is not None else 1.0 / (4.0 * math.pi)
    return {"gamma": args.gamma, "b_gamma": b_gamma, "antipodal": args.antipodal}


def resolve_impl(impl: str, device) -> str:
    """Resolve ``--impl auto``: the fused kernels on a CUDA device, the staged
    rfft pipeline on the CPU (where the kernels' plain versions are a
    checking path, not a speed path)."""
    if impl != "auto":
        return impl
    import torch

    return "fused" if torch.device(device).type == "cuda" else "rfft"


def open_device(name: str):
    """``--device`` as a torch device; raises when CUDA is asked for and
    there is no card."""
    import torch

    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: torch.cuda.is_available() is False")
    return device


@contextlib.contextmanager
def ranks(device):
    """The scope of a sharded driver: this process joins the launcher's
    ranks (:func:`boltzfft_torch.initialize_distributed`; without a
    launcher a mesh of one rank starts its own group), ranks other than 0
    print nothing to stdout (the driver's lines come once, from rank 0,
    from moments reduced over every rank), and a group started here is
    left at the end."""
    import io

    import torch.distributed as dist

    import boltzfft_torch as bt

    started = not dist.is_initialized()
    bt.initialize_distributed(device=device)
    quiet = dist.is_initialized() and dist.get_rank() != 0
    try:
        with contextlib.redirect_stdout(io.StringIO()) if quiet else contextlib.nullcontext():
            yield
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


def parse_mesh(p, text: str, n_axes: int, cells: int) -> tuple:
    """``--mesh MXxMY[xMZ]`` as ints; a parser error if malformed or if
    ``cells`` does not divide by each."""
    try:
        dims = tuple(int(s) for s in text.lower().split("x"))
        if len(dims) != n_axes:
            raise ValueError
    except ValueError:
        p.error(f"--mesh must look like {'x'.join(['2'] * n_axes)}, got {text!r}")
    if any(cells % m for m in dims):
        p.error(f"--cells {cells} not divisible by mesh {'x'.join(map(str, dims))}")
    return dims


def all_sum(t, mesh):
    """``t`` summed over every rank (``t`` itself without a mesh)."""
    if mesh is not None:
        import torch.distributed as dist

        dist.all_reduce(t)
    return t


def step_body(step, diagnostics, device):
    """The JAX drivers' scan body ``body(f, pre) = (f', diagnostics(f'))``
    with ``f' = step(f, pre)``; on the card replayed from one CUDA graph per
    step (:func:`boltzfft_torch._graph.jit`: the transport, the operator's
    kernels, halo exchanges and the diagnostics' reductions in it), with the
    eager body's bits."""
    from boltzfft_torch import _graph

    def body(f, pre):
        f = step(f, pre)
        return f, diagnostics(f)

    return _graph.jit(body, device, "step_body")


def march(body, f, pre, steps: int):
    """``steps`` calls of a :func:`step_body`; returns the final f and the
    per-step diagnostics as a list (the device reduces, the host reads them
    after the run)."""
    trace = []
    for _ in range(steps):
        f, d = body(f, pre)
        trace.append(d)
    return f, trace


def report_h(h0: float, h_trace, steps: int) -> tuple:
    """Print the spatial CLIs' H-trace lines (total Boltzmann H after each
    step); returns ``(dissipated, worst per-step rise)``."""
    import numpy as np

    trace = np.concatenate(([h0], np.asarray(h_trace, np.float64)))
    stride = max(1, steps // 8)
    samples = " ".join(
        f"{h:.6f}" for h in trace[:: stride][: (steps // stride) + 1]
    )
    print(f"H trace (every {stride} steps): {samples} -> {trace[-1]:.6f}")
    worst_rise = float(np.diff(trace).max())
    dissipated = h0 - float(trace[-1])
    print(f"H: {h0:.6f} -> {trace[-1]:.6f} (dissipated {dissipated:.3e}; "
          f"worst per-step rise {worst_rise:.3e})")
    return dissipated, worst_rise
