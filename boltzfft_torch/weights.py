"""Configuration and one-time precompute for the collision operator (mirror of
``boltzfft/weights.py``).

The per-node phase ``alpha1(b, l) = exp(-i c rho_b (l . sigma_b))`` is
separable, ``ax[b, lx] * ay[b, ly] * az[b, lz]``, so only ``(B, N)`` tables are
ever built; ``beta1`` is recomputed from ``|l|`` and the loss multiplier
``beta2`` is precomputed.  Tables are built in host float64 NumPy exactly as
the JAX package builds them, then turned into tensors on an explicit device.

Left out of ``CollisionConfig``: ``fused_nodes_per_step``, ``fused_radix``
and ``fused_sub_batch`` (the TPU kernels' VMEM tiling, which the port's
kernels do not have).  :func:`ds_precomp_from_numpy` carries the JAX
package's double-single tables across.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Mapping, Optional

import numpy as np
import torch

from . import grid as _grid
from . import modes as _modes
from . import quadrature as _quad

_FALLBACK_HBM_BUDGET = 6 << 30  # working-set budget off CUDA (as boltzfft on CPU)
_HBM_BUDGET_FRACTION = 6 / 16  # share of the free device memory for node chunks


def _device_hbm_budget(device) -> int:
    """Working-set byte budget for node chunking: a share of the free memory
    of a CUDA device, the JAX package's constant anywhere else (so the node
    padding matches ``boltzfft`` on the CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        free, _total = torch.cuda.mem_get_info(device)
        return int(free * _HBM_BUDGET_FRACTION)
    return _FALLBACK_HBM_BUDGET


def torch_dtype(dtype) -> torch.dtype:
    """``"float32"``/``"float64"`` (or a torch real dtype) as a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return {"float32": torch.float32, "float64": torch.float64}[dtype]


@dataclasses.dataclass(frozen=True)
class CollisionConfig:
    """Static configuration of a collision operator (hashable).

    VHS kernel ``B(|g|, cos th) = b_gamma * |g|^gamma``; Maxwell molecules are
    ``gamma=0, b_gamma=1/(4 pi)``.
    """

    nv: int = 32  # velocity grid points, x axis (all axes unless nvy/nvz given)
    ns: int = 12  # spherical design size (see quadrature.SPHERICAL_DESIGN_FILES)
    nvy: Optional[int] = None
    nvz: Optional[int] = None
    n_radial: Optional[int] = None  # Gauss-Legendre points; default nv
    gamma: float = 0.0
    b_gamma: float = 1.0 / (4.0 * math.pi)
    support_radius: float = 5.0  # S
    radial_radius: Optional[float] = None  # R; default 2*S
    length: Optional[float] = None  # L; default ((3+sqrt 2)/2)*S
    dtype: str = "float64"  # "float32" | "float64"
    # "rfft": real half-spectrum transforms (torch.fft);
    # "c2c":  complex transforms (torch.fft), the f64 oracle on the card;
    # "dft":  every transform as per-axis einsums against DFT matrices;
    # "fused": the hand-written kernels on CUDA (see fused_scheme).
    impl: str = "rfft"
    node_chunk: Optional[int] = None  # nodes per staged chunk; None = auto
    # impl="rfft": the phase multiply and the node reduction of each chunk in
    # the hand-written kernels K6 and K5 (cubic grids only)
    use_pallas: bool = False
    # Matmul precision of impl="fused" and impl="dft", named as in boltzfft,
    # where "default" takes the TPU's bf16-pass matmuls.  Both tiers run IEEE
    # float32/float64 arithmetic here: the kernels use the CUDA cores, and the
    # dft einsums PyTorch's float32 matmuls, which are full float32 unless
    # the caller turns on torch.backends.cuda.matmul.allow_tf32.
    fused_precision: str = "default"
    # impl="fused": "ct" runs the whole eval in K1 (the gain spectrum in K2
    # under a gain_reduce hook); "transpose" the gain spectrum in K4 and
    # "kron" in K3, each inside the staged c2c finale; "auto" is
    # operator.pick_scheme (kron on Ny*Nz <= 64, such as 8^3; ct elsewhere).
    fused_scheme: str = "auto"
    antipodal: bool = True  # exact antipodal-pair reduction (ns/2 nodes, 2x weights)
    # Ozaki slice-pair retention of the ds engine's oz contractions
    # (ds_operator.collide_ds): None = the digit-exact default (6); a
    # per-call collide_ds(..., oz_cmax=) overrides it.  Ignored by the vpu
    # engine and the non-ds impls.
    oz_cmax: Optional[int] = None

    def __post_init__(self):
        if self.impl not in ("rfft", "c2c", "dft", "fused"):
            raise ValueError(
                f"impl must be 'rfft', 'c2c', 'dft' or 'fused', got {self.impl!r}"
            )
        if self.use_pallas and self.impl != "rfft":
            raise ValueError("use_pallas requires impl='rfft'")
        if self.use_pallas and not self.is_isotropic:
            raise ValueError("use_pallas requires a cubic grid")
        if self.fused_precision not in ("default", "highest"):
            raise ValueError(
                f"fused_precision must be 'default' or 'highest', got "
                f"{self.fused_precision!r}"
            )
        if self.fused_scheme not in ("auto", "kron", "ct", "transpose"):
            raise ValueError(
                f"fused_scheme must be auto/kron/ct/transpose, got "
                f"{self.fused_scheme!r}"
            )
        if self.dtype not in ("float32", "float64"):
            raise ValueError(f"dtype must be float32/float64, got {self.dtype!r}")
        for name, n in (("nv", self.nv), ("nvy", self.nvy), ("nvz", self.nvz)):
            if n is not None and n % 2 != 0:
                raise ValueError(f"{name} must be even (FFT mode ordering)")
        if (
            not self.is_isotropic
            and self.impl == "fused"
            and self.fused_scheme == "transpose"
        ):
            raise ValueError(
                "fused_scheme='transpose' requires a cubic grid; use "
                "'auto'/'kron'/'ct' for anisotropic resolutions"
            )
        if self.ns not in _quad.SPHERICAL_DESIGN_FILES:
            raise ValueError(
                f"No spherical design with {self.ns} points; available: "
                f"{sorted(_quad.SPHERICAL_DESIGN_FILES)}"
            )
        if self.antipodal and self.ns % 2:
            raise ValueError("antipodal reduction requires an even ns")
        if self.oz_cmax is not None and not (0 <= self.oz_cmax <= 14):
            raise ValueError(
                f"oz_cmax must be in [0, 14] (slice-pair level sum), got "
                f"{self.oz_cmax!r}"
            )

    # ---- derived static quantities -------------------------------------
    @property
    def grid_shape(self) -> tuple:
        return (self.nv, self.nvy or self.nv, self.nvz or self.nv)

    @property
    def is_isotropic(self) -> bool:
        s = self.grid_shape
        return s[0] == s[1] == s[2]

    @property
    def n_gl(self) -> int:
        return self.n_radial if self.n_radial is not None else self.nv

    @property
    def r_max(self) -> float:
        if self.radial_radius is not None:
            return self.radial_radius
        return 2.0 * self.support_radius

    @property
    def domain_length(self) -> float:
        if self.length is not None:
            return self.length
        return 0.5 * (3.0 + math.sqrt(2.0)) * self.support_radius

    @property
    def ns_eff(self) -> int:
        """Spherical nodes per radial point: ns/2 under the antipodal
        reduction, ns otherwise (the radial group size)."""
        return self.ns // 2 if self.antipodal else self.ns

    @property
    def n_nodes(self) -> int:
        """Quadrature batch size B = N_gl * N_sph(effective)."""
        return self.n_gl * self.ns_eff

    def chunk(self, device) -> int:
        c = self.node_chunk if self.node_chunk is not None else self.auto_chunk(device)
        return max(1, min(c, self.n_nodes))

    def auto_chunk(self, device, budget_bytes: Optional[int] = None) -> int:
        """Node-chunk size for the staged pipelines: the largest chunk whose
        working set (~9 mode-grid arrays per node: the two phased spectra,
        g1, g2, h, h_hat and FFT workspace) fits the budget, split evenly."""
        nx, ny, nz = self.grid_shape
        n_modes = nx * ny * (nz // 2 + 1 if self.impl == "rfft" else nz)
        if budget_bytes is None:
            budget_bytes = _device_hbm_budget(device)
        itemsize = 16 if self.dtype == "float64" else 8
        per_node = 9 * n_modes * itemsize
        cap = max(1, budget_bytes // per_node)
        if cap >= self.n_nodes:
            return self.n_nodes
        n_chunks = -(-self.n_nodes // cap)
        return -(-self.n_nodes // n_chunks)

    def n_chunks(self, device) -> int:
        return -(-self.n_nodes // self.chunk(device))

    def n_nodes_padded(self, device) -> int:
        return self.n_chunks(device) * self.chunk(device)

    @property
    def real_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @property
    def complex_dtype(self) -> torch.dtype:
        return torch.complex128 if self.dtype == "float64" else torch.complex64

    @property
    def velocity_grid(self) -> _grid.VelocityGrid:
        return _grid.VelocityGrid(
            nv=self.nv, length=self.domain_length, nvy=self.nvy, nvz=self.nvz
        )


@dataclasses.dataclass(frozen=True)
class Precomp:
    """Quadrature + mode tables as tensors on one device.

    Node-major tensors carry the flattened quadrature batch ``b = r * Ns + s``
    padded to ``n_nodes_padded`` (padded entries have ``gain_w == 0``).  The
    fields and their layout are those of ``boltzfft.weights.Precomp``.
    """

    rho: torch.Tensor  # (Bp,)   radial node per batch entry
    sigma: torch.Tensor  # (Bp, 3) spherical direction per batch entry
    gain_w: torch.Tensor  # (Bp,)   w_gl * w_sph * rho^(gamma+2)
    lx: torch.Tensor  # (Nx,)   FFT-order modes
    ly: torch.Tensor  # (Ny,)
    lz: torch.Tensor  # (Nz,) for c2c/fused | (Nz/2+1,) for rfft
    norm_l: torch.Tensor  # |l| on the (possibly half) mode grid
    beta2: torch.Tensor  # loss multiplier on the (possibly half) mode grid
    # DFT matrices for impl="dft"/"fused" as stacked real planes [re, im] (2, N, N);
    # the y/z fields are None on cubic grids (all axes share the x matrix).
    dft_fwd: Optional[torch.Tensor] = None  # exp(-2 pi i m x / N)
    dft_inv: Optional[torch.Tensor] = None  # exp(+2 pi i m x / N) / N
    dft_fwd_y: Optional[torch.Tensor] = None
    dft_inv_y: Optional[torch.Tensor] = None
    dft_fwd_z: Optional[torch.Tensor] = None
    dft_inv_z: Optional[torch.Tensor] = None

    def dft_fwd_axes(self) -> tuple:
        """(x, y, z) forward-matrix stacks (shared x matrix when cubic)."""
        return (
            self.dft_fwd,
            self.dft_fwd_y if self.dft_fwd_y is not None else self.dft_fwd,
            self.dft_fwd_z if self.dft_fwd_z is not None else self.dft_fwd,
        )

    def dft_inv_axes(self) -> tuple:
        return (
            self.dft_inv,
            self.dft_inv_y if self.dft_inv_y is not None else self.dft_inv,
            self.dft_inv_z if self.dft_inv_z is not None else self.dft_inv,
        )

    def to(self, device) -> "Precomp":
        """The same tables on ``device``."""
        return Precomp(**{
            f.name: None if getattr(self, f.name) is None
            else getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
        })

    @property
    def device(self) -> torch.device:
        return self.rho.device

    @functools.cached_property
    def derived(self) -> dict:
        """Tables derived from these fields, built once per ``Precomp`` and
        kept here (not a field: ``to`` and ``precomp_from_numpy`` start a
        fresh one).  ``operator`` keys them by what built them."""
        return {}


def sincc(x, eps: float):
    """Singularity-free sinc ``sin(x + eps) / (x + eps)`` on NumPy arrays or
    tensors (the reference helper, eps matched to the dtype)."""
    if isinstance(x, torch.Tensor):
        return torch.sin(x + eps) / (x + eps)
    return np.sin(x + eps) / (x + eps)


def spherical_quadrature(cfg: CollisionConfig) -> _quad.SphericalQuadrature:
    """The configuration's spherical rule, antipodally reduced when enabled."""
    sph = _quad.spherical_design(cfg.ns)
    if cfg.antipodal:
        sph = _quad.antipodal_reduce(sph)
    return sph


def precomp_from_numpy(
    arrays: Mapping[str, np.ndarray], *, device, dtype
) -> Precomp:
    """A ``Precomp`` from host arrays named like its fields, e.g. the JAX
    package's ``{k: np.asarray(v) for k, v in pre._asdict().items()}``.
    Absent fields (``None``, or NumPy's 0-d object array of ``None``) stay
    ``None``."""
    rd = torch_dtype(dtype)
    kw = {}
    for field in dataclasses.fields(Precomp):
        v = arrays.get(field.name)
        if v is not None and np.asarray(v).dtype == object:
            v = np.asarray(v).item()
        kw[field.name] = (
            None if v is None
            else torch.tensor(np.asarray(v, np.float64), dtype=rd, device=device)
        )
    return Precomp(**kw)


def build_precomp(cfg: CollisionConfig, device) -> Precomp:
    """Build the quadrature/mode/weight tables (float64 host math) on ``device``."""
    length = cfg.domain_length

    gl = _quad.gauss_legendre(cfg.n_gl, 0.0, cfg.r_max)
    sph = spherical_quadrature(cfg)
    ns = sph.n  # == cfg.ns_eff

    # Node-major flattening b = r * Ns + s.
    rho = np.repeat(gl.nodes, ns)  # (B,)
    sigma = np.tile(sph.points, (cfg.n_gl, 1))  # (B, 3)
    gain_w = np.repeat(
        gl.weights * gl.nodes ** (cfg.gamma + 2.0), ns
    ) * np.tile(sph.weights, cfg.n_gl)

    # Pad the node axis so it splits into equal chunks.
    pad = cfg.n_nodes_padded(device) - cfg.n_nodes
    if pad:
        rho = np.concatenate([rho, np.ones(pad)])
        sigma = np.concatenate([sigma, np.tile([[0.0, 0.0, 1.0]], (pad, 1))])
        gain_w = np.concatenate([gain_w, np.zeros(pad)])

    nx, ny, nz = cfg.grid_shape
    lx = _modes.fft_modes(nx)
    ly = _modes.fft_modes(ny)
    lz = _modes.rfft_modes(nz) if cfg.impl == "rfft" else _modes.fft_modes(nz)
    norm_l = _modes.mode_norm_grid(lx, ly, lz)

    # DFT matrices (impl="dft"/"fused"): F[m, x] = exp(-2 pi i m x / N),
    # Vinv[x, m] = exp(+2 pi i m x / N) / N, one pair per axis when anisotropic.
    mats = {}
    if cfg.impl in ("dft", "fused"):
        def dft_pair(n_axis):
            m = np.arange(n_axis)
            ph = 2.0 * np.pi * np.outer(m, m) / n_axis
            fwd = np.stack([np.cos(ph), -np.sin(ph)])  # exp(-i ph)
            inv = np.stack([np.cos(ph) / n_axis, np.sin(ph) / n_axis])
            return fwd, inv

        mats["dft_fwd"], mats["dft_inv"] = dft_pair(nx)
        if not cfg.is_isotropic:
            mats["dft_fwd_y"], mats["dft_inv_y"] = dft_pair(ny)
            mats["dft_fwd_z"], mats["dft_inv_z"] = dft_pair(nz)

    # Loss multiplier beta2(l) = sum_r 16 pi^2 b_gamma w_r rho_r^(gamma+2)
    #   * sincc(pi rho_r |l| / L).
    eps64 = float(np.finfo(np.float64).eps)
    radial_w = gl.weights * gl.nodes ** (cfg.gamma + 2.0)  # (R,)
    arg = (np.pi / length) * gl.nodes[:, None] * norm_l.reshape(1, -1)
    beta2 = (
        16.0 * np.pi**2 * cfg.b_gamma * (radial_w @ sincc(arg, eps64))
    ).reshape(norm_l.shape)

    return precomp_from_numpy(
        dict(rho=rho, sigma=sigma, gain_w=gain_w, lx=lx, ly=ly, lz=lz,
             norm_l=norm_l, beta2=beta2, **mats),
        device=device, dtype=cfg.dtype,
    )


def _ds_leaf(v, device):
    """One host array of a JAX ds table as a tensor: bfloat16 slices (NumPy's
    ``bfloat16`` extension dtype) through float32, which holds them exactly."""
    a = np.asarray(v)
    if a.dtype.name == "bfloat16":
        return torch.as_tensor(a.astype(np.float32), device=device).to(torch.bfloat16)
    return torch.tensor(a, device=device)


def _ds_tree(v, device):
    from . import ds as _ds
    from . import oz as _oz

    if v is None:
        return None
    if isinstance(v, tuple):
        parts = [_ds_tree(x, device) for x in v]
        kinds = {"DS": _ds.DS, "CDS": _ds.CDS, "CSlicedMatrix": _oz.CSlicedMatrix}
        kind = kinds.get(type(v).__name__) if hasattr(v, "_fields") else None
        return kind(*parts) if kind is not None else tuple(parts)
    return _ds_leaf(v, device)


def ds_precomp_from_numpy(pre, *, device):
    """A port ``DsPrecomp`` from the JAX package's, given with NumPy leaves,
    e.g. ``jax.tree.map(np.asarray, boltzfft.ds_operator.build_ds_precomp(cfg))``
    (or a mapping of its field names).  The named tuples ``DS``, ``CDS`` and
    ``CSlicedMatrix`` map onto the port's by name; values keep their bits."""
    from .ds_operator import DsPrecomp

    get = pre.get if isinstance(pre, Mapping) else (lambda k: getattr(pre, k, None))
    return DsPrecomp(**{f: _ds_tree(get(f), device) for f in DsPrecomp._fields})


def repad_nodes(pre: Precomp, target_b: int) -> Precomp:
    """Grow the padded node axis of a ``Precomp`` to ``target_b`` entries
    (``boltzfft.weights.repad_nodes``).

    Extra entries carry ``gain_w == 0`` (and a harmless unit node ``rho = 1``,
    ``sigma = (0, 0, 1)``), so they change nothing numerically: the node
    axis then divides evenly across ranks and chunks."""
    b = pre.rho.shape[0]
    if target_b < b:
        raise ValueError(f"target_b={target_b} < current node count {b}")
    if target_b == b:
        return pre
    pad = target_b - b
    like = dict(dtype=pre.rho.dtype, device=pre.rho.device)
    unit = torch.tensor([[0.0, 0.0, 1.0]], **like).expand(pad, 3)
    return dataclasses.replace(
        pre,
        rho=torch.cat([pre.rho, torch.ones(pad, **like)]),
        sigma=torch.cat([pre.sigma, unit]),
        gain_w=torch.cat([pre.gain_w, torch.zeros(pad, **like)]),
    )
