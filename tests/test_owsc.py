"""OWSC with the reference's piston wavemaker (cases/owsc_2d.py =
test_2d_owsc): 18.42 m tank, Biesel-stroke piston (wave 5 m / 10 s at
scale 1:25 -> 0.2 m / 2 s model wave), berm, bottom-pinned buoyant flap
with the PTO damper c = 20 (owsc.cpp:158).

CI runs dx = 0.06 (2x the reference spacing) to t = 6 s: the piston
generates a wave train of the target period, the wave reaches the flap at
x = 7.92 around t ~ 4 s (phase speed ~2.3 m/s), and the flap pitches with
strong PTO energy capture.  Measured at this resolution: gauge-x=3
oscillation 0.63-0.80 m around the 0.691 m still level, flap pitch peaks
~ +-0.35 rad, PTO energy 0.3 -> 18.7 J across wave arrival.
"""

import pytest

import jax
import jax.numpy as jnp
import numpy as np

pytestmark = pytest.mark.slow  # integration tier (full suite: pytest -m '')


def test_pin_joint_dynamics_units():
    """pin_joint_step: free undamped pendulum-spring about the pivot
    oscillates at omega_n = sqrt(k/I); the damper extracts energy."""
    from sphinxsys_jax.physics import rigid as rg

    pj = rg.PinJoint2D(pivot=jnp.zeros(2), theta=jnp.asarray(0.2),
                       omega=jnp.asarray(0.0), mass=jnp.asarray(1.0),
                       inertia=jnp.asarray(0.5), com0=jnp.zeros(2))
    k = 8.0
    dt = 1e-3
    th = []
    for _ in range(5000):
        pj = rg.pin_joint_step(pj, jnp.asarray(0.0), dt, stiffness=k)
        th.append(float(pj.theta))
    th = np.asarray(th)
    # period T = 2 pi sqrt(I/k) = 2 pi / 4
    zc = np.nonzero((th[:-1] > 0) & (th[1:] <= 0))[0] * dt
    period = np.diff(zc).mean()   # same-direction crossings = full period
    assert abs(period - 2 * np.pi / 4.0) < 0.02
    assert abs(th).max() < 0.21          # energy conserved undamped


def test_piston_stroke_dispersion():
    """Wavemaker coefficients: dispersion root and Biesel stroke for the
    OWSC target (the reference prints 'Wave stroke: ... frequency: ...',
    owsc.h:321-323): om = pi, k solves om^2 = g k tanh(k h)."""
    from sphinxsys_jax.physics import wavemaker as wm

    piston = wm.make_piston(5.0, 10.0, 0.691, 9.81, model_scale=25.0)
    assert abs(piston.omega - np.pi) < 1e-12
    k = wm.dispersion_wavenumber(piston.omega, 0.691, 9.81)
    assert abs(9.81 * k * np.tanh(k * 0.691) - np.pi ** 2) < 1e-8
    # shallow-ish water: stroke is larger than the 2a deep-water limit
    assert 0.2 < piston.stroke < 0.25


def test_owsc_wave_train_drives_flap():
    from sphinxsys_jax.cases import owsc_2d as ow

    case, fluid = ow.build_case(dx=0.06)
    s = ow.init_sim(case, fluid)
    run = ow.make_run_chunk(case)
    rows = []
    for i in range(1, 25):
        s = run(s, jnp.asarray(i * 0.25, s.time.dtype))
        pos = s.fluid["Position"]
        band = jnp.abs(pos[:, 0] - 3.0) < 1.3 * case.dx
        gauge = float(jnp.max(jnp.where(band, pos[:, 1], 0.0)))
        rows.append((float(s.time), gauge, float(s.pj.theta),
                     float(s.pto_energy)))
    assert not bool(s.overflow)
    t, gauge, theta, energy = map(np.asarray, zip(*rows))
    assert np.isfinite(gauge).all() and np.isfinite(theta).all()

    # 1. the piston radiates a wave train: gauge amplitude above the still
    # level (0.691) and a period ~ 2 s (peak-to-peak of the maxima)
    sel = t > 1.5
    assert gauge[sel].max() > 0.72 and gauge[sel].min() < 0.67
    peaks = [i for i in range(1, len(t) - 1)
             if sel[i] and gauge[i] >= gauge[i - 1] and gauge[i] > gauge[i + 1]
             and gauge[i] > 0.71]
    if len(peaks) >= 2:
        period = np.diff(t[peaks]).mean()
        assert 1.4 < period < 2.8, period

    # 2. the flap responds when the wave arrives (~4 s): strong bounded
    # pitch with oscillation
    late = t > 4.0
    assert 0.15 < np.abs(theta[late]).max() < 1.0
    assert (theta[late] > 0.05).any() and (theta[late] < -0.05).any()

    # 3. PTO captures energy across wave arrival
    e_pre = energy[np.searchsorted(t, 3.5)]
    assert energy[-1] > 5.0 * max(e_pre, 0.1)
