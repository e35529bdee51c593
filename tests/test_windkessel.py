"""Windkessel RCR outlet tests (windkessel_bc.h counterpart)."""

import math

import jax.numpy as jnp
import numpy as np

from sphinxsys_jax.physics import windkessel as wks


def run_ode(q_fn, Rp, C, Rd, dt, n_steps, p0=0.0):
    wk = wks.init_windkessel(p0, dtype=jnp.float64)
    ps, ts = [], []
    for i in range(n_steps):
        t = i * dt
        # inject a prescribed flow instead of measuring one
        wk = wk._replace(flow_acc=jnp.asarray(q_fn(t) * dt))
        wk = wks.windkessel_update(wk, jnp.asarray(dt), Rp, C, Rd)
        ps.append(float(wk.p))
        ts.append(t + dt)
    return np.asarray(ts), np.asarray(ps)


def test_constant_flow_reaches_total_resistance_pressure():
    """Steady state of the RCR circuit under constant Q: p = Q (Rp + Rd),
    approached with time constant C*Rd."""
    Rp, C, Rd, Q = 0.5, 2.0, 3.0, 1.5
    tau = C * Rd
    t, p = run_ode(lambda t: Q, Rp, C, Rd, dt=tau / 200, n_steps=200 * 8)
    p_inf = Q * (Rp + Rd)
    np.testing.assert_allclose(p[-1], p_inf, rtol=1e-3)
    # one time constant in: 1 - 1/e of the way from the Rp jump
    i_tau = np.argmin(np.abs(t - tau))
    p_start = Q * Rp  # the proximal resistance responds instantly
    expect_tau = p_start + (p_inf - p_start) * (1 - math.exp(-1.0))
    np.testing.assert_allclose(p[i_tau], expect_tau, rtol=2e-2)


def test_pulsatile_flow_matches_impedance():
    """For Q = Q0 + Qa sin(wt), the steady oscillation amplitude equals
    |Z(w)| Qa with Z = Rp + Rd/(1 + j w C Rd)."""
    Rp, C, Rd = 0.4, 1.5, 2.5
    Q0, Qa, w = 1.0, 0.3, 2.0
    tau = C * Rd
    dt = 2 * math.pi / w / 400
    t, p = run_ode(lambda t: Q0 + Qa * math.sin(w * t), Rp, C, Rd,
                   dt=dt, n_steps=int(8 * tau / dt))
    # analyze the last two periods
    sel = t > t[-1] - 2 * (2 * math.pi / w)
    amp = 0.5 * (p[sel].max() - p[sel].min())
    Z = Rp + Rd / complex(1.0, w * C * Rd)
    np.testing.assert_allclose(amp, abs(Z) * Qa, rtol=2e-2)
    np.testing.assert_allclose(p[sel].mean(), Q0 * (Rp + Rd), rtol=2e-2)


def test_pressure_condition_imposes_on_buffer_region():
    from sphinxsys_jax.core.state import make_fluid_state
    from sphinxsys_jax.core.materials import WeaklyCompressibleFluid
    from sphinxsys_jax.physics.boundary import AlignedBoxRegion

    pos = np.asarray([[0.1, 0.5], [0.95, 0.5], [0.99, 0.2]])
    fluid = dict(make_fluid_state(pos, 0.01, 1.0))
    eos = WeaklyCompressibleFluid(rho0=1.0, c0=10.0)
    region = AlignedBoxRegion(lower=(0.95, 0.0), upper=(1.0, 1.0))
    out = wks.impose_pressure_condition(fluid, region, jnp.asarray(2.5), eos)
    p = np.asarray(out["Pressure"])
    assert p[0] == 0.0
    np.testing.assert_allclose(p[1:], 2.5)
    rho = np.asarray(out["Density"])
    np.testing.assert_allclose(rho[1:], float(eos.density_from_pressure(
        jnp.asarray(2.5))))

    # flow accumulation through the region
    fluid["Velocity"] = jnp.asarray([[1.0, 0.0], [2.0, 0.0], [4.0, 0.0]])
    wk = wks.init_windkessel()
    wk = wks.accumulate_flow(wk, fluid, region, axis=0, dt=jnp.asarray(0.1))
    expect = (2.0 * 0.01 + 4.0 * 0.01) / 0.05 * 0.1
    np.testing.assert_allclose(float(wk.flow_acc), expect, rtol=1e-6)
