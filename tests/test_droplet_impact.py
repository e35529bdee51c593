"""Droplet impact (cases/droplet_impact_2d.py vs test_2d_droplet_impact).

Full-horizon KE parity vs the reference's committed 51-snapshot DB runs in
benchmarks/run_refdb_parity.py droplet_impact; CI tracks the impact
transient (this case is also the regression canary for the cross-phase
Riemann ORIENTATION convention — with a (water, air)-ordered solver
applied to the air phase, the air reads water-scale interface pressures,
the advection dt collapses ~25x and the water KE GROWS instead of
decaying).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from sphinxsys_jax.cases import droplet_impact_2d as di

pytestmark = pytest.mark.slow  # integration tier (full suite: pytest -m '')

# reference WaterBody_TotalKineticEnergy snapshots at t = k*0.004
# (identical across the DB's three committed runs to ~0.06)
REF_KE = {0: 9.875, 1: 9.6867, 2: 9.6448, 3: 9.6982, 4: 9.3565, 5: 8.7790}


@pytest.fixture(scope="module")
def impact_run():
    case, water, air = di.build_case()
    s = di.init_sim(case, water, air)
    run = di.make_run_chunk(case)
    kes = {0: di.water_kinetic_energy(s)}
    for i in (1, 3, 5):
        s = run(s, jnp.asarray(i * 0.004, s.time.dtype))
        kes[i] = di.water_kinetic_energy(s)
    return case, s, kes


def test_initial_kinetic_energy_exact(impact_run):
    """KE(0) = 1/2 rho V N U^2 must equal the reference's snapshot_0
    exactly (same lattice count inside the ball, same U_ref)."""
    _, _, kes = impact_run
    np.testing.assert_allclose(kes[0], REF_KE[0], rtol=1e-6)


def test_impact_dissipation_tracks_reference(impact_run):
    """KE through the impact transient within 5% of the reference DB
    (lattice-start vs the reference's relaxed reload ICs)."""
    _, s, kes = impact_run
    assert not bool(s.overflow)
    for i in (1, 3, 5):
        assert abs(kes[i] - REF_KE[i]) / REF_KE[i] < 0.05, (i, kes[i])
    # monotone trend on the resolved scale: impact dissipates
    assert kes[5] < kes[0]


def test_advection_dt_healthy(impact_run):
    """The shared advection dt must stay on the U_ref scale (~3e-4); the
    orientation bug collapsed it to ~1.2e-5 via spurious air jets."""
    case, s, _ = impact_run
    t = float(s.time)
    assert t / int(s.n_adv) > 1.0e-4
    # air stays three orders lighter and bounded
    rho_a = np.asarray(s.air["Density"])[: int(s.air["NReal"])]
    assert rho_a.max() < 0.01
    assert np.isfinite(np.asarray(s.air["Velocity"])).all()
