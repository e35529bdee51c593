"""Target-driven optimization tests (diffusion_optimization counterpart,
implemented with autodiff through the jitted diffusion solver)."""

import jax
import jax.numpy as jnp
import numpy as np

from sphinxsys_jax.core import geometry as G
from sphinxsys_jax.core.adaptation import SPHAdaptation
from sphinxsys_jax.core.generators import generate_lattice
from sphinxsys_jax.neighbors import grid_from_bounds, build_cell_table, build_neighbor_list
from sphinxsys_jax.physics import optimization as op


def setup(dx=0.05):
    shape = G.Box(G.Transform(translation=(0.5, 0.5)), halfsize=(0.5, 0.5))
    pos, vol = generate_lattice(shape, (0, 0), (1, 1), dx)
    ad = SPHAdaptation(spacing=dx, dim=2)
    grid = grid_from_bounds((0, 0), (1, 1), ad.cutoff)
    n = len(pos)
    p = jnp.asarray(pos, jnp.float32)
    table = build_cell_table(p, jnp.int32(n), grid, cap=32)
    nl = build_neighbor_list(p, jnp.int32(n), p, jnp.int32(n), table, grid,
                             ad.cutoff, k_max=48, include_self=False)
    return p, jnp.full((n,), vol, jnp.float32), nl, ad, np.asarray(pos)


def test_gradient_through_solver_is_finite_and_informative():
    p, vol, nl, ad, pos = setup()
    n = p.shape[0]
    dirichlet = jnp.asarray((pos[:, 0] < 0.08) | (pos[:, 0] > 0.92))
    values = jnp.where(jnp.asarray(pos[:, 0] < 0.08), 1.0, 0.0)
    target = jnp.asarray(1.0 - pos[:, 0], jnp.float32)

    def loss(log_d):
        T = op.solve_steady_temperature(jnp.exp(log_d), p, vol, nl, ad.kernel,
                                        2, dirichlet, values,
                                        jnp.zeros(n), 1e-4, 50)
        return jnp.mean((T - target) ** 2)

    g = jax.grad(loss)(jnp.zeros(n))
    assert np.isfinite(np.asarray(g)).all()
    assert float(jnp.abs(g).max()) > 0.0


def test_recover_uniform_diffusivity():
    """Generate a target with D_true = 1 everywhere; starting from a wrong
    non-uniform D the optimizer must recover a uniform field and drive the
    steady-state mismatch toward zero."""
    p, vol, nl, ad, pos = setup(dx=0.0625)
    n = p.shape[0]
    dirichlet = jnp.asarray((pos[:, 0] < 0.08) | (pos[:, 0] > 0.92))
    values = jnp.where(jnp.asarray(pos[:, 0] < 0.08), 1.0, 0.0)
    dt = 1e-4
    d_true = jnp.ones(n)
    target = op.solve_steady_temperature(d_true, p, vol, nl, ad.kernel, 2,
                                         dirichlet, values, jnp.zeros(n),
                                         dt, 400)
    rng = np.random.default_rng(0)
    d0 = jnp.asarray(np.exp(rng.normal(0.5, 0.3, n)), jnp.float32)
    res = op.optimize_diffusivity(p, vol, nl, ad.kernel, 2, dirichlet, values,
                                  target, d0, dt, n_solver_steps=400,
                                  n_opt_steps=40, lr=0.15)
    losses = np.asarray(res.losses)
    assert losses[-1] < 0.05 * losses[0]  # mismatch driven down 20x+
    assert np.isfinite(np.asarray(res.diffusivity)).all()
