"""Particle relaxation preprocessing tests (the --relax path, SURVEY §3.5)."""

import jax
import jax.numpy as jnp
import numpy as np

from sphinxsys_jax.core import geometry as G
from sphinxsys_jax.core.adaptation import SPHAdaptation
from sphinxsys_jax.core.generators import generate_lattice
from sphinxsys_jax.neighbors import grid_from_bounds, build_cell_table, build_neighbor_list
from sphinxsys_jax.physics import relax as rx


def _setup(dx=0.05):
    adaptation = SPHAdaptation(spacing=dx, dim=2)
    grid = grid_from_bounds((0, 0), (1, 1), adaptation.cutoff)
    return adaptation, grid


def _corrected_residual(pos, vol, shape, adaptation, grid, table_L):
    n = pos.shape[0]
    t = build_cell_table(pos, jnp.int32(n), grid, cap=32)
    nl = build_neighbor_list(pos, jnp.int32(n), pos, jnp.int32(n), t, grid,
                             adaptation.cutoff, k_max=48, include_self=False)
    r = rx.relaxation_residual(pos, jnp.full((n,), vol, pos.dtype), nl,
                               adaptation.kernel, 2)
    return r + rx.surface_residual_correction(pos, shape, table_L)


def test_half_space_correction_cancels_truncation():
    """Near a flat boundary of a perfect lattice the corrected residual is
    ~0 (the raw residual is O(20))."""
    adaptation, grid = _setup(dx=0.04)
    box = G.Box(G.Transform(translation=(0.5, 0.25)), halfsize=(0.5, 0.25))
    pos, vol = generate_lattice(box, (0, 0), (1, 1), 0.04)
    p = jnp.asarray(pos, jnp.float32)
    table_L = rx.half_space_gradient_table(adaptation.kernel, 2)
    res = np.asarray(_corrected_residual(p, vol, box, adaptation, grid, table_L))
    mid = (pos[:, 0] > 0.3) & (pos[:, 0] < 0.7) & (pos[:, 1] < 0.2)
    raw_scale = 20.0
    assert np.linalg.norm(res[mid], axis=-1).max() < 0.1 * raw_scale


def test_ball_relaxation_converges_and_stays_inside():
    dx = 0.05
    adaptation, grid = _setup(dx)
    ball = G.Ball(center=(0.5, 0.5), radius=0.35)
    pos0, vol = generate_lattice(ball, (0, 0), (1, 1), dx)
    relaxed = rx.relax_shape(ball, jnp.asarray(pos0, jnp.float32), vol,
                             adaptation, grid, n_iterations=300)
    relaxed_np = np.asarray(relaxed)
    assert np.isfinite(relaxed_np).all()
    # all particles inside the surface band
    sd = np.asarray(ball.signed_distance(relaxed))
    assert (sd < 0).all()
    # isotropic packing: nearest-neighbor spacing stays near dx (no clumps)
    d2 = np.sum((relaxed_np[:, None, :] - relaxed_np[None, :, :]) ** 2, axis=-1)
    np.fill_diagonal(d2, np.inf)
    min_dist = np.sqrt(d2.min(axis=1))
    assert min_dist.min() > 0.7 * dx
    # corrected residual decreased vs the lattice start
    table_L = rx.half_space_gradient_table(adaptation.kernel, 2)
    r0 = np.linalg.norm(np.asarray(_corrected_residual(
        jnp.asarray(pos0, jnp.float32), vol, ball, adaptation, grid, table_L)), axis=-1)
    r1 = np.linalg.norm(np.asarray(_corrected_residual(
        relaxed, vol, ball, adaptation, grid, table_L)), axis=-1)
    assert np.nanmean(r1) < 0.5 * np.nanmean(r0)


def test_reload_roundtrip_of_relaxed_particles(tmp_path):
    """Relax -> write reload -> read reload (the reference's two-channel
    restart/reload split, io_base.h:148-166)."""
    from sphinxsys_jax.io import restart as rst
    from sphinxsys_jax.core.state import make_fluid_state

    dx = 0.05
    adaptation, grid = _setup(dx)
    ball = G.Ball(center=(0.5, 0.5), radius=0.3)
    pos0, vol = generate_lattice(ball, (0, 0), (1, 1), dx)
    relaxed = rx.relax_shape(ball, jnp.asarray(pos0, jnp.float32), vol,
                             adaptation, grid, n_iterations=50)
    state = make_fluid_state(np.asarray(relaxed), vol, 1.0)
    rst.write_reload(str(tmp_path), "ball", state)
    pos, vols = rst.read_reload(str(tmp_path), "ball")
    np.testing.assert_allclose(pos, np.asarray(relaxed), atol=1e-7)
