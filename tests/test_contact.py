"""Solid-solid contact repulsion tests."""

import jax
import jax.numpy as jnp
import numpy as np

from sphinxsys_jax.core.adaptation import SPHAdaptation
from sphinxsys_jax.core.materials import SaintVenantKirchhoffSolid
from sphinxsys_jax.core.state import make_solid_state
from sphinxsys_jax.neighbors import grid_from_bounds, build_cell_table, build_neighbor_list
from sphinxsys_jax.physics import contact as ct


def two_blocks(gap):
    """Two 2D blocks with the given surface gap."""
    dx = 0.1
    adaptation = SPHAdaptation(spacing=dx, dim=2)
    xs, ys = np.meshgrid(np.arange(5) * dx, np.arange(5) * dx, indexing="ij")
    a = np.stack([xs.ravel(), ys.ravel()], -1)
    b = a.copy()
    b[:, 0] += a[:, 0].max() + gap
    sa = dict(make_solid_state(a, dx * dx, 1000.0, dtype=jnp.float32))
    sb = dict(make_solid_state(b, dx * dx, 1000.0, dtype=jnp.float32))
    grid = grid_from_bounds((-1, -1), (3, 3), adaptation.cutoff)
    ta = build_cell_table(sa["Position"], sa["NReal"], grid, cap=32)
    tb = build_cell_table(sb["Position"], sb["NReal"], grid, cap=32)
    nl_ab = build_neighbor_list(sa["Position"], sa["NReal"], sb["Position"],
                                sb["NReal"], tb, grid, adaptation.cutoff,
                                k_max=32, include_self=True)
    nl_ba = build_neighbor_list(sb["Position"], sb["NReal"], sa["Position"],
                                sa["NReal"], ta, grid, adaptation.cutoff,
                                k_max=32, include_self=True)
    return sa, sb, nl_ab, nl_ba, adaptation


def test_repulsion_pushes_bodies_apart():
    sa, sb, nl_ab, nl_ba, adaptation = two_blocks(gap=0.05)  # overlapping kernels
    kernel = adaptation.kernel
    fa = ct.repulsion_factor_contact(sa, sb, nl_ab, kernel, 2)
    fb = ct.repulsion_factor_contact(sb, sa, nl_ba, kernel, 2)
    assert float(fa.max()) > 0
    mat = SaintVenantKirchhoffSolid(rho0=1000.0, youngs_modulus=1e6, poisson_ratio=0.3)
    k = ct.contact_stiffness(mat)
    sa["ForcePrior"] = jnp.zeros_like(sa["Position"])
    sb["ForcePrior"] = jnp.zeros_like(sb["Position"])
    sa2 = ct.repulsion_force_contact(sa, sb, nl_ab, kernel, 2, fa, fb, k)
    sb2 = ct.repulsion_force_contact(sb, sa, nl_ba, kernel, 2, fb, fa, k)
    Fa = np.asarray(sa2["RepulsionForce"]).sum(axis=0)
    Fb = np.asarray(sb2["RepulsionForce"]).sum(axis=0)
    assert Fa[0] < 0      # body a (left) pushed left
    assert Fb[0] > 0      # body b (right) pushed right
    # Newton's third law (atol scaled to the force magnitude: the
    # transverse component is ~0 and sits at fp32 roundoff)
    np.testing.assert_allclose(Fa, -Fb, rtol=1e-4, atol=1e-6 * abs(Fa[0]))


def test_no_repulsion_when_separated():
    sa, sb, nl_ab, nl_ba, adaptation = two_blocks(gap=1.0)  # far apart
    fa = ct.repulsion_factor_contact(sa, sb, nl_ab, adaptation.kernel, 2)
    assert float(fa.max()) == 0.0


def test_self_repulsion_factor_zero_on_lattice():
    """The W(dp) offset makes the resting lattice read ~0 self-penetration."""
    sa, sb, nl_ab, nl_ba, adaptation = two_blocks(gap=1.0)
    dx = 0.1
    grid = grid_from_bounds((-1, -1), (3, 3), adaptation.cutoff)
    ta = build_cell_table(sa["Position"], sa["NReal"], grid, cap=32)
    nl_aa = build_neighbor_list(sa["Position"], sa["NReal"], sa["Position"],
                                sa["NReal"], ta, grid, adaptation.cutoff,
                                k_max=48, include_self=False)
    f = ct.repulsion_factor_self(sa, nl_aa, adaptation.kernel, 2, dx)
    # diagonal neighbors are farther than dp so contribute 0; axis-aligned
    # contribute exactly 0 after the offset
    assert float(jnp.max(f)) < 1e-6


def test_active_fiber_stress():
    from sphinxsys_jax.physics.solid import active_fiber_stress

    fn = active_fiber_stress()
    solid = {
        "ActiveContractionStress": jnp.asarray([2.0]),
        "Fiber": jnp.asarray([[1.0, 0.0]]),
    }
    S = np.asarray(fn(solid, None))
    np.testing.assert_allclose(S, [[[2.0, 0.0], [0.0, 0.0]]])
