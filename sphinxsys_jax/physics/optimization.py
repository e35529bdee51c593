"""Target-driven (PDE-constrained) optimization.

Counterpart of /root/reference/src/shared/particle_dynamics/
diffusion_optimization_dynamics/ (diffusion_splitting_*.h: the reference
implements parameter/state splitting iterations by hand to optimize, e.g.,
a thermal-diffusivity distribution toward a target temperature field, and
drives it from tests/optimization/*).

This framework gets this nearly for free: the diffusion solver
is a pure jitted function, so the objective gradient with respect to ANY
parameter field is one jax.grad — no splitting machinery.  This module
packages that pattern:

    optimize_diffusivity: fit a per-particle diffusivity field so the
    steady temperature matches a target, by Adam on
    grad_D || T_steady(D) - T_target ||^2  differentiated THROUGH the
    diffusion relaxation loop.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from sphinxsys_jax.neighbors.neighbor_list import NeighborList, gather
from sphinxsys_jax.physics.pair import pair_geometry

TINY = 1.0e-15


def diffusion_rate_local(pos, temperature, diffusivity, vol, nl: NeighborList,
                         kernel, dim: int, box=None):
    """dT/dt with a per-particle diffusivity field (inter-particle
    coefficient = harmonic-free average 0.5 (D_i + D_j), the reference's
    LocalDiffusion convention)."""
    pg = pair_geometry(pos, pos, nl, kernel, dim, need_W=False, box=box)
    vol_j, _ = gather(vol, nl.idx)
    t_j, _ = gather(temperature, nl.idx)
    d_j, _ = gather(diffusivity, nl.idx)
    d_ij = 0.5 * (diffusivity[:, None] + d_j)
    area = 2.0 * pg.dW * vol_j / (pg.r + TINY)
    return jnp.sum(d_ij * (temperature[:, None] - t_j) * area, axis=1)


class OptimizationResult(NamedTuple):
    diffusivity: jnp.ndarray
    losses: jnp.ndarray


def solve_steady_temperature(diffusivity, pos, vol, nl, kernel, dim,
                             dirichlet_mask, dirichlet_values, t_init,
                             dt, n_steps: int, box=None):
    """Relax the temperature field to (near) steady state with fixed
    Dirichlet particles — the forward PDE solve, fully differentiable."""

    def body(_, T):
        rate = diffusion_rate_local(pos, T, diffusivity, vol, nl, kernel,
                                    dim, box)
        T = T + rate * dt
        return jnp.where(dirichlet_mask, dirichlet_values, T)

    return jax.lax.fori_loop(0, n_steps, body, t_init)


def optimize_diffusivity(pos, vol, nl, kernel, dim, dirichlet_mask,
                         dirichlet_values, target_T, d_init,
                         dt, n_solver_steps: int = 200,
                         n_opt_steps: int = 60, lr: float = 0.1,
                         d_bounds=(1e-3, 10.0), box=None) -> OptimizationResult:
    """Fit log-diffusivity by Adam on the steady-state mismatch — the
    autodiff counterpart of the reference's splitting optimization
    (tests/optimization/test_2d_*_optimization)."""
    import optax

    t0 = jnp.where(dirichlet_mask, dirichlet_values, jnp.mean(dirichlet_values))

    def loss_fn(log_d):
        D = jnp.exp(log_d)
        T = solve_steady_temperature(D, pos, vol, nl, kernel, dim,
                                     dirichlet_mask, dirichlet_values, t0,
                                     dt, n_solver_steps, box)
        return jnp.mean((T - target_T) ** 2)

    opt = optax.adam(lr)
    log_d = jnp.log(d_init)
    state = opt.init(log_d)

    @jax.jit
    def step(log_d, state):
        loss, g = jax.value_and_grad(loss_fn)(log_d)
        updates, state = opt.update(g, state)
        log_d = optax.apply_updates(log_d, updates)
        log_d = jnp.clip(log_d, jnp.log(d_bounds[0]), jnp.log(d_bounds[1]))
        return log_d, state, loss

    losses = []
    for _ in range(n_opt_steps):
        log_d, state, loss = step(log_d, state)
        losses.append(loss)
    return OptimizationResult(diffusivity=jnp.exp(log_d),
                              losses=jnp.stack(losses))
