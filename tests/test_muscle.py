"""Muscle material + excitation-contraction coupling tests
(active_muscle_dynamics / electro_physiology composition — the physics
stack of the fish-swimming and cardiac cases)."""

import pytest

import jax
import jax.numpy as jnp
import numpy as np

from sphinxsys_jax.core.materials import Muscle
from sphinxsys_jax.physics import diffusion as df

pytestmark = pytest.mark.slow  # integration tier (full suite: pytest -m '')


def test_muscle_stress_free_at_identity():
    m = Muscle(rho0=1e3, bulk_modulus_param=1e5, f0=(1.0, 0.0), s0=(0.0, 1.0),
               a0=(100.0, 50.0, 30.0, 10.0), b0=(1.0, 1.0, 1.0, 1.0))
    S = np.asarray(m.stress_PK2(jnp.eye(2)[None]))
    np.testing.assert_allclose(S, 0.0, atol=1e-4)


def test_muscle_fiber_stiffer_than_cross():
    """Stretch along the fiber must produce a larger stress than the same
    stretch across it (anisotropy)."""
    m = Muscle(rho0=1e3, bulk_modulus_param=1e5, f0=(1.0, 0.0), s0=(0.0, 1.0),
               a0=(100.0, 5.0e4, 0.0, 0.0), b0=(1.0, 1.0, 1.0, 1.0))
    eps = 0.02
    F_f = jnp.asarray([[1.0 + eps, 0.0], [0.0, 1.0]])[None]
    F_c = jnp.asarray([[1.0, 0.0], [0.0, 1.0 + eps]])[None]
    S_f = float(m.stress_PK2(F_f)[0, 0, 0])
    S_c = float(m.stress_PK2(F_c)[0, 1, 1])
    assert S_f > 1.5 * S_c


def test_active_contraction_stress_reaction():
    """Depolarized tissue (V ~ 1) must grow ActiveContractionStress;
    resting tissue must not."""
    model = df.AlievPanfilowModel(k_a=2.0)
    assert "ActiveContractionStress" in model.species_names
    state = {
        "Voltage": jnp.asarray([1.0, 0.0]),
        "GateVariable": jnp.zeros(2),
        "ActiveContractionStress": jnp.zeros(2),
    }
    s = state
    for _ in range(200):
        s = df.reaction_step(s, model, 0.05)
    ta = np.asarray(s["ActiveContractionStress"])
    assert ta[0] > 10.0      # excited fiber develops tension
    assert ta[1] < 1e-3      # resting fiber does not


def test_active_muscle_beam_contracts():
    """Uniformly activating a free muscle beam along its fiber must
    shorten it (ActiveMuscle + total-Lagrangian solids composition)."""
    from sphinxsys_jax.core.adaptation import SPHAdaptation
    from sphinxsys_jax.neighbors import (grid_from_bounds, build_cell_table,
                                         build_neighbor_list)
    from sphinxsys_jax.physics import solid as sd

    dx = 0.02
    ad = SPHAdaptation(spacing=dx, dim=2)
    xs, ys = np.meshgrid(np.arange(0, 0.4, dx), np.arange(0, 0.08, dx),
                         indexing="ij")
    pos = np.stack([xs.ravel(), ys.ravel()], -1)
    mat = Muscle(rho0=1e3, bulk_modulus_param=2e6, f0=(1.0, 0.0),
                 s0=(0.0, 1.0), a0=(2e4, 1e4, 0.0, 0.0),
                 b0=(1.0, 1.0, 1.0, 1.0))
    solid = sd.make_elastic_solid_state(pos, dx * dx, mat)
    n = len(pos)
    grid = grid_from_bounds((-0.2, -0.2), (0.6, 0.3), ad.cutoff)
    table = build_cell_table(solid["Position"], jnp.int32(n), grid, cap=32)
    nl = build_neighbor_list(solid["Position"], jnp.int32(n), solid["Position"],
                             jnp.int32(n), table, grid, ad.cutoff, k_max=64,
                             include_self=False)
    rp = sd.freeze_reference_pairs(solid["Position"], nl, ad.kernel, 2)
    solid = dict(solid)
    solid["LinearGradientCorrectionMatrix"] = sd.linear_gradient_correction_matrix(
        rp, solid["VolumetricMeasure"])
    solid["Fiber"] = jnp.tile(jnp.asarray([1.0, 0.0], jnp.float32), (n, 1))
    # uniform active TENSION Ta > 0 pulls the fiber ends inward -> contraction
    solid["ActiveContractionStress"] = jnp.full((n,), 5e3, jnp.float32)

    active = sd.active_fiber_stress()
    h = ad.h
    w0 = ad.kernel.w0(2)
    length0 = pos[:, 0].max() - pos[:, 0].min()

    @jax.jit
    def step(so, dt):
        so = sd.integration_1st_half_pk2(so, rp, mat, dt, h, w0,
                                         active_stress_fn=active)
        so = sd.integration_2nd_half(so, rp, dt)
        return so

    dt = 0.3 * float(sd.solid_acoustic_time_step(solid, mat.sound_speed, h))
    for _ in range(800):
        solid = step(solid, dt)
        # light damping so the beam settles at the contracted equilibrium
        solid["Velocity"] = solid["Velocity"] * 0.99
    pos1 = np.asarray(solid["Position"])
    assert np.isfinite(pos1).all()
    length1 = pos1[:, 0].max() - pos1[:, 0].min()
    assert length1 < 0.99 * length0  # contracted along the fiber
