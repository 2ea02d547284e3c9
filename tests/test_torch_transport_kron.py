"""The 1D/2D/3D Strang steps of the PyTorch port on the kron route
(``impl="fused"``: one K3 call per collision substep, its plain version on
the CPU) against ``boltzfft``'s steps on its kron scheme (Pallas in
interpret mode, jitted), on 4 / 2x2 / 2x2x2 cells at 8^3 velocities."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import boltzfft as bz

import boltzfft_torch as bt
from boltzfft_torch.kernels import fused_gain as k3

from test_torch_transport import STEPS, CELLS, cell_data, small_kw


@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_step_matches_boltzfft_kron(ndim):
    kw = small_kw(impl="fused")
    cfg_j = bz.CollisionConfig(fused_scheme="kron", **kw)
    cfg_t = bt.CollisionConfig(fused_scheme="kron", **kw)
    mk_j, mk_t, deltas = STEPS[ndim]
    f = cell_data(cfg_t, CELLS[ndim], seed=ndim)
    collide_j, pre_j = bz.make_collision_operator(cfg_j, jit=False)
    step_j = jax.jit(mk_j(cfg_j, collide_j, dt=0.02, knudsen=0.5, **deltas))
    a = np.asarray(step_j(jnp.asarray(f), pre_j))

    collide_t, pre_t = bt.make_collision_operator(cfg_t, device="cpu")
    step_t = mk_t(cfg_t, collide_t, dt=0.02, knudsen=0.5, **deltas)
    calls = k3.REFERENCE_CALLS
    b = step_t(torch.as_tensor(f), pre_t).numpy()
    assert k3.REFERENCE_CALLS == calls + 2  # one K3 call per RK2 stage, all cells
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-12 * np.abs(a).max())
