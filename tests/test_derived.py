"""Derived-quantity tests: vorticity, von Mises, quantity summation."""

import jax.numpy as jnp
import numpy as np

from sphinxsys_jax.core import geometry as G
from sphinxsys_jax.core.adaptation import SPHAdaptation
from sphinxsys_jax.core.generators import generate_lattice
from sphinxsys_jax.core.materials import SaintVenantKirchhoffSolid
from sphinxsys_jax.core.state import make_fluid_state
from sphinxsys_jax.neighbors import grid_from_bounds, build_cell_table, build_neighbor_list
from sphinxsys_jax.physics import general as gd
from sphinxsys_jax.physics import solid as sd


def test_vorticity_of_rigid_rotation():
    """v = omega x r: curl = 2 omega everywhere."""
    dx = 0.04
    shape = G.Box(G.Transform(translation=(0.5, 0.5)), halfsize=(0.5, 0.5))
    pos, vol = generate_lattice(shape, (0, 0), (1, 1), dx)
    adaptation = SPHAdaptation(spacing=dx, dim=2)
    state = dict(make_fluid_state(pos, vol, 1.0, dtype=jnp.float32))
    omega = 1.7
    p = np.asarray(pos) - 0.5
    state["Velocity"] = jnp.asarray(
        omega * np.stack([-p[:, 1], p[:, 0]], -1), jnp.float32)
    grid = grid_from_bounds((0, 0), (1, 1), adaptation.cutoff)
    table = build_cell_table(state["Position"], state["NReal"], grid, cap=32)
    nl = build_neighbor_list(state["Position"], state["NReal"], state["Position"],
                             state["NReal"], table, grid, adaptation.cutoff,
                             k_max=48, include_self=False)
    w = np.asarray(gd.vorticity(state, nl, adaptation.kernel, 2))
    interior = ((p > -0.35) & (p < 0.35)).all(axis=1)
    # uncorrected SPH gradient underestimates by ~3% at this resolution
    np.testing.assert_allclose(w[interior], 2 * omega, rtol=0.05)


def test_von_mises_uniaxial():
    """Pure shear F gives von Mises sigma ~ sqrt(3) * G * gamma for small
    gamma."""
    m = SaintVenantKirchhoffSolid(rho0=1e3, youngs_modulus=2e6, poisson_ratio=0.3)
    gamma = 1e-4
    F = jnp.asarray([[1.0, gamma], [0.0, 1.0]])[None]
    vm = float(sd.von_mises_stress({"DeformationGradient": F}, m)[0])
    np.testing.assert_allclose(vm, np.sqrt(3) * m.shear_modulus * gamma, rtol=1e-2)
    vm_e = float(sd.von_mises_strain({"DeformationGradient": F})[0])
    np.testing.assert_allclose(vm_e, gamma / np.sqrt(3), rtol=1e-2)


def test_quantity_summation():
    state = {
        "NReal": jnp.asarray(2, jnp.int32),
        "Position": jnp.zeros((3, 2)),
        "F": jnp.asarray([[1.0, 2.0], [3.0, 4.0], [100.0, 100.0]]),
    }
    total = np.asarray(gd.quantity_summation(state, "F"))
    np.testing.assert_allclose(total, [4.0, 6.0])
