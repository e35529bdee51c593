"""Composed windkessel channel case (cases/channel_windkessel_2d.py =
test_2d_channel_windkessel_rigid_shell): pulsatile inflow + RCR outlet."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.slow  # integration tier (full suite: pytest -m '')


def test_inflow_waveform_matches_reference_series():
    """The 8-harmonic clamped waveform (cpp:104-123): periodic with the
    1 s cardiac cycle, mean ~ 0.23, peak during systole."""
    from sphinxsys_jax.cases.channel_windkessel_2d import inflow_velocity

    t = np.linspace(0.0, 1.0, 201)
    u = np.asarray([float(inflow_velocity(jnp.asarray(tt))) for tt in t])
    assert (u >= 0.0).all()
    assert abs(float(inflow_velocity(jnp.asarray(0.3)))
               - float(inflow_velocity(jnp.asarray(1.3)))) < 1e-5
    assert 0.15 < u.mean() < 0.35
    assert u.max() > 0.4          # systolic peak
    assert u.min() < 0.15         # diastolic trough


def test_windkessel_channel_pressure_responds():
    """Run the channel into early systole: the flow follows the imposed
    inflow and the windkessel outlet pressure rises from the 80 mmHg
    baseline as flow accumulates (the reference's regression quantity is
    this pressure/flow coupling)."""
    from sphinxsys_jax.cases import channel_windkessel_2d as cw

    case, fluid = cw.build_case()
    s = cw.init_sim(case, fluid)
    run = cw.make_run_chunk(case)
    s = run(s, jnp.asarray(0.065, s.time.dtype))

    f = s.fluid
    assert not bool(s.overflow)
    m = np.asarray(f["Alive"])
    u = np.asarray(f["Velocity"])[m]
    rho = np.asarray(f["Density"])[m]
    assert np.isfinite(u).all() and np.isfinite(rho).all()
    assert np.abs(rho / cw.RHO0_F - 1.0).max() < 0.15
    # bulk flow tracks the inflow waveform
    u_in = float(cw.inflow_velocity(s.time))
    assert abs(u[:, 0].mean() - u_in) < 0.6 * max(u_in, 0.1)
    # the RCR pressure moved off the baseline and stays physiological
    p = cw.outlet_pressure_mmhg(s)
    assert 80.5 < p < 200.0
