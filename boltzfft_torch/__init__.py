"""boltzfft_torch: the fast Fourier spectral Boltzmann collision operator in
PyTorch, with its kernels hand-written in CUDA for Hopper (K1, the whole
collision eval; K2/K4, the gain spectrum by per-axis DFTs; K3, by the
Kronecker scheme; K5/K6, the node reduction and phase multiply of the rfft
route; K7-K12, the Ozaki-sliced contractions and Hadamard sums of the
double-single engine), the RK relaxation loop, the spatially inhomogeneous solver
around it, their sharding over several devices (one ``torch.distributed``
rank each), and the tooling around them: the autotuners (``autotune``,
``autotune_ds``), the tables' archives (``save_precomp``, ``load_precomp``),
``trace``, the spans and counters of ``obs``, and the examples
(``boltzfft_torch.examples``).

The PyTorch counterpart of ``boltzfft`` (JAX), which stays the reference.
Imports torch and NumPy only, never jax::

    import boltzfft_torch as bt
    cfg = bt.CollisionConfig(nv=32, ns=12, impl="fused")
    collide, pre = bt.make_collision_operator(cfg)  # jit=True, device="cuda"
    g = cfg.velocity_grid
    f = torch.as_tensor(bt.bkw_f(g.r_squared(), 6.5), device="cuda")
    q = collide(f, pre)  # replayed from one CUDA graph after the first call

``device="cpu"`` runs the plain PyTorch versions; ``jit=False`` runs eagerly.
"""

from . import ds, obs, transport
from .bkw import bkw_dfdt, bkw_f, bkw_k, maxwellian
from .cache import load_precomp, save_precomp
from .checkpoint import RelaxCheckpointer
from .conserve import ConservePrecomp, build_conserve_precomp, conservative, project
from .distributed import initialize_distributed, make_multihost_mesh, process_local_ensemble_slice
from .ds_operator import (
    DsPrecomp,
    build_ds_precomp,
    collide_ds,
    make_ds_collision_operator,
    make_sharded_ds_collision_operator,
    place_ds,
)
from .grid import VelocityGrid, domain_from_support
from .moments import Moments, entropy, moments
from .operator import collide, gain_spectrum, make_collision_operator, pick_scheme
from .quadrature import (
    SPHERICAL_DESIGN_FILES,
    Quadrature1D,
    SphericalQuadrature,
    antipodal_reduce,
    gauss_legendre,
    spherical_design,
)
from .sharding import (
    ENSEMBLE_AXIS,
    NODE_AXIS,
    make_mesh,
    make_sharded_collision_operator,
    place,
    place_cells,
)
from .stats import RunStats, error_norms, error_norms_device, time_fn, trace
from .timestepper import (
    Trajectory,
    euler_step,
    make_relaxation,
    relax,
    rk2_step,
    rk4_step,
)
from .tune import autotune, autotune_ds, autotune_fused
from .weights import (
    CollisionConfig,
    Precomp,
    build_precomp,
    ds_precomp_from_numpy,
    precomp_from_numpy,
    repad_nodes,
    sincc,
)

__all__ = [
    "CollisionConfig",
    "ENSEMBLE_AXIS",
    "ConservePrecomp",
    "DsPrecomp",
    "Moments",
    "NODE_AXIS",
    "Precomp",
    "Quadrature1D",
    "RelaxCheckpointer",
    "RunStats",
    "SPHERICAL_DESIGN_FILES",
    "SphericalQuadrature",
    "Trajectory",
    "VelocityGrid",
    "antipodal_reduce",
    "autotune",
    "autotune_ds",
    "autotune_fused",
    "bkw_dfdt",
    "bkw_f",
    "bkw_k",
    "build_conserve_precomp",
    "build_ds_precomp",
    "build_precomp",
    "collide",
    "collide_ds",
    "conservative",
    "domain_from_support",
    "ds",
    "ds_precomp_from_numpy",
    "entropy",
    "error_norms",
    "error_norms_device",
    "euler_step",
    "gain_spectrum",
    "gauss_legendre",
    "initialize_distributed",
    "load_precomp",
    "make_collision_operator",
    "make_ds_collision_operator",
    "make_mesh",
    "make_multihost_mesh",
    "make_relaxation",
    "make_sharded_collision_operator",
    "make_sharded_ds_collision_operator",
    "maxwellian",
    "moments",
    "pick_scheme",
    "place",
    "place_cells",
    "place_ds",
    "precomp_from_numpy",
    "process_local_ensemble_slice",
    "project",
    "relax",
    "repad_nodes",
    "rk2_step",
    "rk4_step",
    "save_precomp",
    "sincc",
    "spherical_design",
    "time_fn",
    "trace",
    "transport",
]
