"""Fish FSI case (flow_stream_around_fish counterpart): composition smoke
test + regression on the committed production-run curves."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "fish")


def test_fish_fsi_composition_runs():
    """Coarse end-to-end: channel + fish + open boundaries advance stably
    with conserved bodies and no capacity overflow."""
    from sphinxsys_jax.cases import fish_fsi_2d as ff

    case, fluid, fish = ff.build_case(dx=0.01)
    s = ff.init_sim(case, fluid, fish)
    run = ff.make_run_chunk(case)
    c0 = ff.fish_center_of_mass(s)
    s = run(s, jnp.asarray(0.1, s.time.dtype))
    assert not bool(s.overflow)
    c1 = ff.fish_center_of_mass(s)
    assert np.isfinite(np.asarray(s.fluid["Velocity"])).all()
    assert np.isfinite(np.asarray(s.fish["Position"])).all()
    # the fish stays in the channel and barely drifts this early
    assert abs(c1[1] - c0[1]) < 0.05


@pytest.mark.skipif(not os.path.isdir(GOLDEN), reason="golden curves missing")
def test_fish_production_self_propulsion_curve():
    """The committed production run (dx = 0.0025 = the reference's
    particle_spacing_ref, t = 0..1.7 = End_Time, benchmarks/
    run_fish_validation.py) shows sustained forward self-propulsion:
    over half a body length of forward travel, stable lateral position."""
    from sphinxsys_jax.io import regression as rg

    coms = rg.read_result_xml(
        os.path.join(GOLDEN, "FishBody_CenterOfMass_Run_0_result.xml"))[0]
    ke = rg.read_result_xml(
        os.path.join(GOLDEN, "WaterBody_TotalKineticEnergy_Run_0_result.xml"))[0]
    assert coms.shape[1] == 2 and len(coms) >= 50

    dx_total = coms[-1, 0] - coms[0, 0]
    fish_length = 0.2
    assert dx_total > 0.4 * fish_length, f"forward travel {dx_total}"
    # monotonic forward motion once the muscle ramp is up (2nd half)
    n2 = len(coms) // 2
    assert coms[-1, 0] > coms[n2, 0]
    # lateral excursion bounded (straight swimming)
    assert np.abs(coms[:, 1] - coms[0, 1]).max() < 0.05 * 0.4
    # the stirred wake carries bounded kinetic energy
    assert np.isfinite(ke).all() and ke.max() < 10.0
