"""boltzfft_torch: the fast Fourier spectral Boltzmann collision operator in
PyTorch, with its kernels hand-written in CUDA for Hopper (K1, the whole
collision eval; K2/K4, the gain spectrum by per-axis DFTs; K3, by the
Kronecker scheme; K5/K6, the node reduction and phase multiply of the rfft
route; K7-K12, the Ozaki-sliced contractions and Hadamard sums of the
double-single engine), the RK relaxation loop, and the spatially inhomogeneous solver
around it.

The PyTorch counterpart of ``boltzfft`` (JAX), which stays the reference.
Imports torch and NumPy only, never jax::

    import boltzfft_torch as bt
    cfg = bt.CollisionConfig(nv=32, ns=12, impl="fused")
    collide, pre = bt.make_collision_operator(cfg, device="cuda")
    g = cfg.velocity_grid
    f = torch.as_tensor(bt.bkw_f(g.r_squared(), 6.5), device="cuda")
    q = collide(f, pre)
"""

from . import transport
from .bkw import bkw_dfdt, bkw_f, bkw_k, maxwellian
from .conserve import ConservePrecomp, build_conserve_precomp, conservative, project
from .ds_operator import collide_ds, make_ds_collision_operator
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
from .stats import RunStats, error_norms, error_norms_device, time_fn
from .timestepper import (
    Trajectory,
    euler_step,
    make_relaxation,
    relax,
    rk2_step,
    rk4_step,
)
from .weights import (
    CollisionConfig,
    Precomp,
    build_precomp,
    ds_precomp_from_numpy,
    precomp_from_numpy,
    sincc,
)

__all__ = [
    "CollisionConfig",
    "ConservePrecomp",
    "Moments",
    "Precomp",
    "Quadrature1D",
    "RunStats",
    "SPHERICAL_DESIGN_FILES",
    "SphericalQuadrature",
    "Trajectory",
    "VelocityGrid",
    "antipodal_reduce",
    "bkw_dfdt",
    "bkw_f",
    "bkw_k",
    "build_conserve_precomp",
    "build_precomp",
    "collide",
    "collide_ds",
    "conservative",
    "domain_from_support",
    "ds_precomp_from_numpy",
    "entropy",
    "error_norms",
    "error_norms_device",
    "euler_step",
    "gain_spectrum",
    "gauss_legendre",
    "make_collision_operator",
    "make_ds_collision_operator",
    "make_relaxation",
    "maxwellian",
    "moments",
    "pick_scheme",
    "precomp_from_numpy",
    "project",
    "relax",
    "rk2_step",
    "rk4_step",
    "sincc",
    "spherical_design",
    "time_fn",
    "transport",
]
