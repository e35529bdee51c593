"""Taylor bar impact (UL J2 plasticity) — unit + coarse physics tests.

Reference: /root/reference/tests/3d_examples/test_3d_taylor_bar_UL/ with
its Column_TotalKineticEnergy DTW database (KE_0 = 209.6 J at dx = PL/12,
decayed to < 1% by t = 3.1e-5 s).
"""

import pytest

import math

import jax.numpy as jnp
import numpy as np

from sphinxsys_jax.physics import continuum as cn

pytestmark = pytest.mark.slow  # integration tier (full suite: pytest -m '')


def _j2(rho0=2700.0, Y=0.29e9, H=0.0):
    c0 = math.sqrt(78.2e9 / (3 * 0.4 * 2700.0))
    return cn.J2Plasticity(rho0=rho0, c0=c0, youngs_modulus=78.2e9,
                           poisson_ratio=0.3, yield_stress=Y,
                           hardening_modulus=H)


def test_j2_return_mapping_on_yield_surface():
    m = _j2()
    tau = 1.0e9  # pure shear well beyond yield
    s = jnp.asarray([[[0.0, tau, 0.0], [tau, 0.0, 0.0], [0.0, 0.0, 0.0]]])
    k = jnp.zeros((1,))
    out = np.asarray(m.return_mapping_shear_stress(s, k))[0]
    J2 = 0.5 * (out * out.T).sum()
    # sqrt(2 J2) == sqrt(2/3) * Y after radial return
    np.testing.assert_allclose(math.sqrt(2 * J2),
                               math.sqrt(2.0 / 3.0) * m.yield_stress,
                               rtol=1e-5)
    # direction preserved
    assert out[0, 1] > 0 and abs(out[0, 0]) < 1e-3 * tau


def test_j2_elastic_state_untouched():
    m = _j2()
    tau = 1.0e8  # below yield: sqrt(2 J2) = sqrt(2) tau = 1.41e8 < 2.37e8
    s = jnp.asarray([[[0.0, tau, 0.0], [tau, 0.0, 0.0], [0.0, 0.0, 0.0]]])
    k = jnp.zeros((1,))
    out = np.asarray(m.return_mapping_shear_stress(s, k))[0]
    np.testing.assert_allclose(out[0, 1], tau, rtol=1e-6)
    assert float(m.hardening_factor_rate(s, k)[0]) == 0.0


def test_j2_hardening_raises_yield():
    m = _j2(H=1.0e9)
    tau = 1.0e9
    s = jnp.asarray([[[0.0, tau, 0.0], [tau, 0.0, 0.0], [0.0, 0.0, 0.0]]])
    k0 = jnp.zeros((1,))
    rate = m.hardening_factor_rate(s, k0)
    assert float(rate[0]) > 0.0
    k1 = k0 + cn.J2Plasticity._SQRT23 * rate
    out = np.asarray(m.return_mapping_shear_stress(s, k1))[0]
    J2 = 0.5 * (out * out.T).sum()
    target = math.sqrt(2.0 / 3.0) * (m.yield_stress
                                     + m.hardening_modulus * float(k1[0]))
    np.testing.assert_allclose(math.sqrt(2 * J2), target, rtol=1e-5)
    # hardened surface sits above the virgin one
    assert target > math.sqrt(2.0 / 3.0) * m.yield_stress


def test_taylor_bar_impact_ke_decay():
    """Coarse (dx = PL/6) impact: the KE decay must track the reference
    curve scale — the reference (dx = PL/12) is at KE/KE_0 = 0.417 by
    t = 1.2e-5 s and < 0.005 by t = 3.1e-5 s."""
    from sphinxsys_jax.cases import taylor_bar_ul_3d as tb

    case, col = tb.build_case_ci()
    s = tb.init_sim(case, col)
    run = tb.make_run_chunk(case)
    ke0 = tb.kinetic_energy(s)
    m_col = float(jnp.sum(s.column["Mass"]))
    # analytic initial KE: 0.5 * rho * pi r^2 h * v^2 (lattice quantized)
    ke_analytic = 0.5 * tb.RHO0 * math.pi * tb.PL ** 2 * tb.PW * tb.VEL0 ** 2
    assert abs(ke0 - ke_analytic) / ke_analytic < 0.15

    r0 = tb.mushroom_radius(case, s)
    s = run(s, jnp.asarray(1.2e-5, jnp.float32))
    assert not bool(s.overflow)
    ke1 = tb.kinetic_energy(s)
    frac = ke1 / ke0
    # reference fraction 0.417 at this time; coarse-lattice tolerance
    assert 0.25 < frac < 0.60, frac
    # plastic mushrooming has begun
    assert tb.mushroom_radius(case, s) > r0 + 0.5 * case.dx
    # positions finite, column above the wall face (minus small overlap)
    z = np.asarray(s.column["Position"][:, 2])
    assert np.isfinite(z).all() and z.min() > -2 * case.dx
