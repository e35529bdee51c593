"""Nonlinear wave FSI (cases/nonlinear_wave_fsi_2d.py =
test_2d_nonlinear_wave_fsi): 32-component focused wave packet piston +
tension-leg moored floating structure.

CI runs dx = 0.06 (2x the reference spacing) through the 1 s settling
window + 2 s of wave generation: the packet components satisfy the
dispersion relation, the piston radiates, and the tension-leg platform
holds station — the buoyancy excess (the structure displaces ~3x its
weight at the prescribed draft, h:124-134) keeps both tethers TAUT with
the structure pinned near its initial position.  The full 20 s focused
impact at the reference resolution is the offline validation
(benchmarks/run_wave_fsi_validation.py).
"""

import pytest

import jax.numpy as jnp
import numpy as np

pytestmark = pytest.mark.slow  # integration tier (full suite: pytest -m '')


def test_focused_packet_dispersion_and_strokes():
    from sphinxsys_jax.physics import wavemaker as wm
    from sphinxsys_jax.cases import nonlinear_wave_fsi_2d as nw

    pk = wm.make_focused_packet(dtype=jnp.float64, **nw.PACKET)
    om = np.asarray(pk.om)
    k = np.asarray(pk.k)
    S = np.asarray(pk.S)
    assert om.shape == (32,)
    # every component satisfies om^2 = g k tanh(k h)
    resid = om ** 2 - 9.81 * k * np.tanh(k * 0.8)
    assert np.abs(resid).max() < 1e-8
    # strokes: S = a (sinh kh cosh kh + kh)/sinh^2 kh, decreasing with f
    assert (S > 0).all() and (np.diff(S) < 0).all()
    assert S.max() < 0.1
    # focus: the velocity components add coherently near (xf, tf)
    t = np.linspace(0, 40, 4001)
    v = np.asarray([float(pk.velocity(jnp.asarray(ti))) for ti in t])
    t_peak = t[np.abs(v).argmax()]
    assert abs(v).max() > 3.0 * np.abs(v[t < 5.0]).max()
    # piston crescendo toward the focus time tf = 20.48 (the peak PISTON
    # velocity precedes tf: the slow long-wave components launch last)
    assert 12.0 < t_peak < 22.0, t_peak


def test_cable_springs_hold_tension_leg():
    """Static check of the SimTK::CableSpring law on the built case: at the
    initial draft the buoyancy excess is ~1.3 kN, so equilibrium needs a
    ~2 mm tether stretch; _cable_forces restores with that stiffness."""
    from sphinxsys_jax.cases import nonlinear_wave_fsi_2d as nw

    case, _ = nw.build_case(dx=0.06)
    rb = case.rb0
    # lift the structure 1 cm: tethers pull DOWN with 2 k s
    rb_up = rb._replace(com=rb.com + jnp.asarray([0.0, 0.01], rb.com.dtype))
    f, tau, T = nw._cable_forces(rb_up, case.rb0.com)
    assert float(f[1]) < -2.0 * nw.CABLE_K * 0.009
    assert (np.asarray(T) > 0).all()
    # slack: pushing it down makes tension vanish
    rb_dn = rb._replace(com=rb.com - jnp.asarray([0.0, 0.01], rb.com.dtype))
    f2, _, T2 = nw._cable_forces(rb_dn, case.rb0.com)
    assert np.allclose(np.asarray(T2), 0.0)


def test_wave_fsi_station_keeping():
    from sphinxsys_jax.cases import nonlinear_wave_fsi_2d as nw

    case, fluid = nw.build_case(dx=0.06)
    com0 = np.asarray(case.rb0.com)
    s = nw.init_sim(case, fluid)
    run = nw.make_run_chunk(case)
    rows = []
    for i in range(1, 9):
        s = run(s, jnp.asarray(i * 0.25, s.time.dtype))
        rows.append((float(s.time), *np.asarray(s.rb.com),
                     float(s.rb.theta), *np.asarray(s.tension),
                     float(nw.wave_gauge(s, x=2.0, half_width=0.078))))
    assert not bool(s.overflow)
    t, cx, cy, th, TA, TB, gauge = map(np.asarray, zip(*rows))
    assert np.isfinite(np.asarray(s.fluid["Pressure"])).all()

    # tension-leg station keeping: the taut tethers pin the structure
    assert np.abs(cx - com0[0]).max() < 0.05
    assert np.abs(cy - com0[1]).max() < 0.05
    assert np.abs(th).max() < 0.2
    # tethers stay taut through the window (mean tension ~ the buoyancy
    # excess split over two cables)
    assert TA.mean() > 100.0 and TB.mean() > 100.0

    # the piston radiates: the near gauge (x = 2) deviates from the still
    # water level within the window
    assert np.abs(gauge - 0.8).max() > 0.015
