"""3D granular repose angle (test_3d_repose_angle).

Reference DB (GranularBody_TotalMechanicalEnergy): decays 3.99 -> 1.517
over its snapshots.  At dx = RADIUS/5 (CI economy; reference is RADIUS/10)
our settled energy lands within ~3% of the DB's settled value.
"""

import jax.numpy as jnp
import numpy as np
import pytest


@pytest.fixture(scope="module")
def repose_run():
    from sphinxsys_jax.cases import repose_angle_3d as ra

    case, soil = ra.build_case(dx=ra.RADIUS / 5)
    s = ra.init_sim(case, soil)
    e0 = ra.mechanical_energy(case, s)
    run = ra.make_run_chunk(case)
    hist = []
    for i in range(1, 8):
        s = run(s, jnp.asarray(i * 0.1, s.time.dtype))
        hist.append((float(s.time), ra.mechanical_energy(case, s)))
    return case, s, e0, np.asarray(hist)


def test_energy_settles_at_reference_value(repose_run):
    case, s, e0, hist = repose_run
    assert not bool(s.overflow)
    # initial potential energy matches the analytic column value
    assert abs(e0 - 4.00) < 0.1
    # monotone decay (plastic dissipation, no bounce-back)
    e = hist[:, 1]
    assert np.all(np.diff(e) < 1e-2)
    # settled value vs the reference DB's 1.517
    assert abs(e[-1] - 1.517) < 0.05, e[-1]
    # settled: last two outputs nearly identical
    assert abs(e[-1] - e[-2]) < 0.01


def test_pile_forms_at_repose_slope(repose_run):
    """The settled pile's flank slope sits below the 30-deg friction angle
    (rolling spreads the toe) but the pile is a genuine cone, not a puddle."""
    from sphinxsys_jax.cases import repose_angle_3d as ra

    case, s, _, _ = repose_run
    n = case.n_soil
    pos = np.asarray(s.soil["Position"])[:n]
    r = np.hypot(pos[:, 0] - ra.DL / 2, pos[:, 2] - ra.DW / 2)
    h_max = pos[:, 1].max()
    runout = np.quantile(r, 0.95)
    slope = np.degrees(np.arctan2(h_max, runout))
    assert 0.03 < h_max < 0.08
    assert 8.0 < slope < 32.0, slope
    # column stayed centered (no drift through the wall)
    assert abs(pos[:, 0].mean() - ra.DL / 2) < 0.02
