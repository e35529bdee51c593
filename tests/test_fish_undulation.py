"""Fish active-strain undulation (structural half of
test_2d_flow_stream_around_fish)."""

import jax.numpy as jnp
import numpy as np
import pytest


def test_active_model_pk1_zero_strain_is_passive():
    from sphinxsys_jax.physics import solid as sd

    rng = np.random.default_rng(0)
    F = jnp.asarray(np.eye(2) + 0.05 * rng.normal(size=(7, 2, 2)))
    Ea = jnp.zeros((7, 2, 2))
    lam, G = 2.0, 1.5
    P = sd.active_model_pk1(F, Ea, lam, G)
    # with E_a = 0: F0 = I, so PK1 = F (lam tr(E) I + 2 G E)
    E = 0.5 * (jnp.swapaxes(F, -1, -2) @ F - jnp.eye(2))
    S = lam * jnp.trace(E, axis1=-2, axis2=-1)[:, None, None] * jnp.eye(2) + 2 * G * E
    np.testing.assert_allclose(np.asarray(P), np.asarray(F @ S), rtol=1e-6,
                               atol=1e-12)


def test_active_strain_relaxes_to_activation():
    """A free homogeneous block with constant active strain E_a must relax
    to F^T F = 2 E_a + I (stress-free at F = F0)."""
    from sphinxsys_jax.physics import solid as sd

    F = jnp.broadcast_to(jnp.eye(2), (3, 2, 2))
    ea = jnp.zeros((3, 2, 2)).at[:, 0, 0].set(-0.05)
    F0 = np.linalg.cholesky(np.asarray(2 * ea + jnp.eye(2)))
    P = sd.active_model_pk1(jnp.asarray(F0), ea, 2.0, 1.5)
    np.testing.assert_allclose(np.asarray(P), 0.0, atol=1e-7)


@pytest.fixture(scope="module")
def fish_run():
    from sphinxsys_jax.cases import fish_undulation_2d as fu

    case, s = fu.build_case(dx=0.004)
    run = fu.make_run_chunk(case)
    tips, ts, coms = [], [], []
    for i in range(1, 25):
        s = run(s, jnp.asarray(i * 0.025, s.time.dtype))
        ts.append(float(s.time))
        tips.append(fu.tail_lateral_displacement(case, s))
        coms.append(fu.center_of_mass(s))
    return case, s, np.asarray(ts), np.asarray(tips), np.asarray(coms)


def test_tail_beats_at_drive_frequency(fish_run):
    case, s, t, d, _ = fish_run
    assert np.isfinite(d).all()
    sel = t > 0.25  # past the activation ramp
    cr = np.where(np.diff(np.sign(d[sel])))[0]
    tt = t[sel]
    assert len(cr) >= 2
    freq = 0.5 * (len(cr) - 1) / (tt[cr[-1]] - tt[cr[0]])
    np.testing.assert_allclose(freq, 4.0, rtol=0.15)  # measured 4.000 (fp32)
    amp = np.abs(d[sel]).max()
    assert 0.005 < amp < 0.05   # a few % of the body length


def test_momentum_conserved_in_vacuum(fish_run):
    case, s, t, d, coms = fish_run
    drift = np.linalg.norm(coms - coms[0], axis=1).max()
    assert drift < 1e-3 * 0.2   # no self-propulsion without fluid
