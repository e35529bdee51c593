"""Porous-media (multi-species continuum) tests
(porous_media_dynamics counterpart, test_2d_membrane physics)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sphinxsys_jax.core.adaptation import SPHAdaptation
from sphinxsys_jax.neighbors import grid_from_bounds, build_cell_table, build_neighbor_list
from sphinxsys_jax.physics import porous as pm
from sphinxsys_jax.physics import solid as sd


def make_block(nx=20, ny=8, dx=0.05):
    xs = (np.arange(nx) + 0.5) * dx
    ys = (np.arange(ny) + 0.5) * dx
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    pos = np.stack([X.ravel(), Y.ravel()], -1)
    mat = pm.PorousMediaSolid(rho0=2.0, youngs_modulus=8.242e6,
                              poisson_ratio=0.26316,
                              diffusivity_constant=1.0e-4,
                              fluid_initial_density=1.0,
                              water_pressure_constant=3.0e6)
    state = pm.make_porous_state(pos, dx * dx, mat)
    ad = SPHAdaptation(spacing=dx, dim=2)
    grid = grid_from_bounds((-0.2, -0.2), (nx * dx + 0.2, ny * dx + 0.2),
                            ad.cutoff)
    n = len(pos)
    table = build_cell_table(state["Position"], jnp.int32(n), grid, cap=24)
    nl = build_neighbor_list(state["Position"], jnp.int32(n),
                             state["Position"], jnp.int32(n), table, grid,
                             ad.cutoff, k_max=32, include_self=False)
    rp = sd.freeze_reference_pairs(state["Position"], nl, ad.kernel, 2)
    state["LinearGradientCorrectionMatrix"] = sd.linear_gradient_correction_matrix(
        rp, state["VolumetricMeasure"])
    return state, rp, ad, mat, pos


def test_saturation_diffusion_conserves_mass_and_spreads():
    state, rp, ad, mat, pos = make_block()
    mid = jnp.asarray((pos[:, 0] > 0.3) & (pos[:, 0] < 0.7))
    state = pm.set_initial_saturation(state, mid, 0.4, mat)
    m0 = float(jnp.sum(state["FluidMass"]))
    Dt = pm.saturation_time_step(mat, ad.h, 2)
    assert Dt > 0

    @jax.jit
    def step(s):
        return pm.saturation_relaxation(s, rp, mat, jnp.asarray(Dt))

    for _ in range(400):
        state = step(state)
    sat = np.asarray(state["FluidSaturation"])
    np.testing.assert_allclose(float(jnp.sum(state["FluidMass"])), m0,
                               rtol=1e-5)          # fluid mass conserved
    assert sat.max() < 0.4 - 1e-3                  # peak decays
    outside = np.asarray(~mid)
    assert sat[outside].max() > 1e-4               # fluid reached new region
    assert sat.min() > -1e-6                       # no negative saturation


def test_uniform_saturation_swells_block():
    """A free block uniformly saturated must swell isotropically: the pore
    pressure k_w s balances the elastic response at a positive volumetric
    strain, with the center of mass fixed by symmetry."""
    state, rp, ad, mat, pos = make_block(nx=12, ny=12)
    all_mask = jnp.ones((len(pos),), bool)
    sat0 = 0.05
    state = pm.set_initial_saturation(state, all_mask, sat0, mat)
    h = ad.h
    w0 = ad.kernel.w0(2)
    dt = 0.1 * h / mat.sound_speed
    com0 = np.asarray(state["Position"]).mean(0)

    @jax.jit
    def step(s):
        s = pm.porous_stress_relaxation_1st_half(s, rp, mat, jnp.asarray(dt),
                                                 h, w0)
        return pm.porous_stress_relaxation_2nd_half(s, rp, mat,
                                                    jnp.asarray(dt))

    Js = []
    for i in range(1500):
        state = step(state)
        if i % 300 == 299:
            Js.append(float(jnp.mean(jnp.linalg.det(
                state["DeformationGradient"]))))
    assert np.isfinite(np.asarray(Js)).all()
    # swelling: J rises above 1 toward the linear-elastic balance
    # e_v ~ k_w s / (lambda + G) (2D), here ~ 0.04
    assert Js[-1] > 1.005
    e_v = Js[-1] - 1.0
    expect = mat.water_pressure_constant * sat0 / (mat.lambda0
                                                   + mat.shear_modulus)
    assert 0.3 * expect < e_v < 3.0 * expect
    com = np.asarray(state["Position"]).mean(0)
    np.testing.assert_allclose(com, com0, atol=1e-6)
