"""The plain reference against the BKW closed form and the transport's
invariants (CPU, small grids)."""

import math

import numpy as np
import pytest
import torch

from portbench.reference import spectral, stepping


def _bkw_errors(nv):
    tab = spectral.tables({"nv": nv, "ns": 12, "n_radial": nv}, "cpu")
    r2 = stepping.r_squared(tab)
    e = (spectral.collide(stepping.bkw_f(r2, 6.5), tab) - stepping.bkw_dfdt(r2, 6.5)).abs()
    return (float(e.sum() * tab.cell_volume), float(torch.sqrt((e * e).sum() * tab.cell_volume)),
            float(e.max()))


def test_reference_gives_the_reference_codes_bkw_digits_at_32():
    # Results/maxwell_bkw_fftw_atomics.txt:19-21 (BASELINE.md): Nv = 32^3, Ns = 12
    l1, l2, linf = _bkw_errors(32)
    assert l1 == pytest.approx(1.5403e-03, rel=1e-4)
    assert l2 == pytest.approx(1.0119e-04, rel=1e-4)
    assert linf == pytest.approx(4.2512e-05, rel=1e-4)


def test_reference_converges_to_the_closed_form():
    assert _bkw_errors(16)[2] > 5.0 * _bkw_errors(32)[2] > 0.0


def test_rk4_follows_the_bkw_relaxation():
    tab = spectral.tables({"nv": 24, "ns": 12, "n_radial": 24}, "cpu")
    r2 = stepping.r_squared(tab)
    f, t, dt = stepping.bkw_f(r2, 6.0), 6.0, 0.125
    for _ in range(4):
        f = stepping.rk_step(lambda x: spectral.collide(x, tab), f, dt, "rk4")
        t += dt
    exact = stepping.bkw_f(r2, t)
    change = (exact - stepping.bkw_f(r2, 6.0)).abs().max()
    assert (f - exact).abs().max() < 0.05 * change


def test_batched_eval_equals_per_item_and_blocks():
    tab = spectral.tables({"nv": 8, "ns": 12, "n_radial": 4}, "cpu")
    f = torch.rand(5, 8, 8, 8, dtype=torch.float64, generator=torch.Generator().manual_seed(3))
    q = spectral.collide(f, tab)
    q_small_blocks = spectral.collide(f, tab, block_bytes=1)
    assert torch.allclose(q, q_small_blocks, rtol=0, atol=1e-14 * float(q.abs().max()))
    for i in range(5):
        assert torch.allclose(q[i], spectral.collide(f[i], tab), rtol=0, atol=1e-14 * float(q.abs().max()))


def test_collisions_conserve_mass_momentum_energy_to_quadrature_error():
    tab = spectral.tables({"nv": 32, "ns": 12, "n_radial": 32}, "cpu")
    f = stepping.bkw_f(stepping.r_squared(tab), 6.5)
    m = stepping.moments(spectral.collide(f, tab), tab)
    assert abs(float(m["mass"])) < 1e-4 and abs(float(m["energy"])) < 1e-3
    assert float(m["momentum"].abs().max()) < 1e-13


def test_muscl_is_conservative_and_exact_for_unit_courant():
    torch.manual_seed(0)
    f = torch.rand(6, 5, 2, 2, 2, dtype=torch.float64)
    v = torch.full((1, 1, 2, 1, 1), 0.7, dtype=torch.float64)
    g = stepping.advect_muscl(f, v, 0.1, 0.05, 0)
    assert torch.allclose(g.sum(0), f.sum(0), atol=1e-14)
    one = stepping.advect_muscl(f, torch.full_like(v, 1.0), 0.1, 0.1, 0)
    assert torch.allclose(one, torch.roll(f, 1, dims=0), atol=1e-14)
    back = stepping.advect_muscl(f, torch.full_like(v, -1.0), 0.1, 0.1, 1)
    assert torch.allclose(back, torch.roll(f, -1, dims=1), atol=1e-14)


def test_taylor_green_monitor_of_a_resting_gas():
    tab = spectral.tables({"nv": 16, "ns": 12, "n_radial": 4}, "cpu")
    zero = torch.zeros(2, 2, dtype=torch.float64)
    f = stepping.maxwellian(zero, zero, tab, 1.0, 3.0)
    mass, ke, h = stepping.taylor_green_monitor(f, tab, 0.5)
    assert float(mass) == pytest.approx(1.0, rel=1e-6)
    assert abs(float(ke)) < 1e-20
    assert float(h) == pytest.approx(-1.5 * (math.log(2 * math.pi * 3.0) + 1.0), rel=1e-4)


def test_design_is_halved_by_antipodal_pairs():
    pts, w = spectral._design(12, True)
    full, wf = spectral._design(12, False)
    assert pts.shape == (6, 3) and w.sum() == pytest.approx(4 * math.pi)
    assert full.shape == (12, 3) and wf.sum() == pytest.approx(4 * math.pi)


@pytest.mark.parametrize("n", [16, 64])
def test_gauss_legendre_rule_to_an_ulp(n):
    mpmath = pytest.importorskip("mpmath")
    mpmath.mp.dps = 40
    x, w = spectral.gauss_legendre(n)
    for xi, wi in zip(x, w):
        root = mpmath.findroot(lambda t: mpmath.legendre(n, t), mpmath.mpf(float(xi)))
        dp = mpmath.diff(lambda t: mpmath.legendre(n, t), root)
        exact_w = 2 / ((1 - root**2) * dp**2)
        assert abs(xi - float(root)) <= np.spacing(abs(float(root)) + 1e-300)
        assert abs(wi - float(exact_w)) <= 2 * np.spacing(float(exact_w))
