"""Two-phase (air-water) dambreak tests (test_2d_two_phase_dambreak
counterpart)."""

import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.slow  # integration tier (full suite: pytest -m '')


@pytest.fixture(scope="module")
def two_phase_run():
    from sphinxsys_jax.cases import two_phase_dambreak_2d as tp

    case, water, air = tp.build_case(dx=0.1)
    s = tp.init_sim(case, water, air)
    run = tp.make_run_chunk(case)
    fronts, ts = [], []
    for i in range(1, 7):
        s = run(s, jnp.asarray(i * 0.5, s.time.dtype))
        w = s.water
        n = w["Position"].shape[0]
        front = float(jnp.max(jnp.where(jnp.arange(n) < w["NReal"],
                                        w["Position"][:, 0], -1.0)))
        fronts.append(front)
        ts.append(float(s.time))
    return tp, case, s, np.asarray(ts), np.asarray(fronts)


def test_surge_front_reaches_far_wall(two_phase_run):
    """The water surge under air must reach the far wall around t ~ 2
    (front speed ~ 2 sqrt(g LH) over the 3.3 run-up), like the
    single-phase dambreak."""
    tp, case, s, t, front = two_phase_run
    assert not bool(s.overflow)
    i15 = np.argmin(np.abs(t - 1.5))
    assert front[i15] > 3.3          # well past half the tank
    assert front[-1] > tp.DL - 3 * case.dx   # pinned at the far wall


def test_phases_stay_distinct_and_bounded(two_phase_run):
    tp, case, s, _, _ = two_phase_run
    rho_w = np.asarray(s.water["Density"])
    rho_a = np.asarray(s.air["Density"])
    # weak compressibility of the heavy phase
    assert abs(rho_w / tp.RHO0_F - 1.0).max() < 0.05
    # the light phase stays three orders lighter everywhere
    assert rho_a.max() < 0.01 * tp.RHO0_F
    assert rho_a.min() > 0.1 * tp.RHO0_A
    assert np.isfinite(np.asarray(s.air["Velocity"])).all()


def test_air_mass_conserved(two_phase_run):
    """Summation density + Vol = m/rho keeps each phase's total mass
    exactly (mass is carried, not recomputed)."""
    tp, case, s, _, _ = two_phase_run
    m_air = float(jnp.sum(s.air["Mass"]))
    expect = case.n_air * tp.RHO0_A * case.dx ** 2
    np.testing.assert_allclose(m_air, expect, rtol=1e-6)
    # and the summed air volume stays near its initial share of the tank
    vol_air = float(jnp.sum(s.air["VolumetricMeasure"]))
    vol0 = case.n_air * case.dx ** 2
    assert 0.7 * vol0 < vol_air < 1.3 * vol0
