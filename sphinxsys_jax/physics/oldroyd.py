"""Oldroyd-B viscoelastic fluid integration.

Counterpart of /root/reference/src/shared/particle_dynamics/fluid_dynamics/
non_newtonian_dynamics/non_newtonian_dynamics.cpp (Oldroyd_BIntegration
1st/2ndHalf): the weakly-compressible acoustic halves gain

  * a polymeric elastic-stress force
        F_i += m_i/rho_i sum_j (tau_i + tau_j) gradW_ij V_j e_ij    (inner)
        F_i += m_i/rho_i sum_w  2 tau_i       gradW_iw V_w e_iw    (wall)
  * an upper-convected Maxwell stress transport
        dtau/dt = gradV^T tau + tau gradV - tau/lambda
                  + mu_p/lambda (gradV + gradV^T)
    integrated with the same half-dt staggering as density
    (tau += dtau/dt * dt/2 at the start of the 1st half and at the end of
    the 2nd half, non_newtonian_dynamics.cpp:20-25,88-97).

These are separate composable ops (call around the standard acoustic
halves) rather than subclasses — the XLA fusion makes the split free.
"""

from __future__ import annotations

import jax.numpy as jnp

from sphinxsys_jax.core.state import State
from sphinxsys_jax.neighbors.neighbor_list import NeighborList, gather
from sphinxsys_jax.physics.pair import pair_geometry


def register_variables(fluid: State, dim: int) -> State:
    out = dict(fluid)
    n = fluid["Position"].shape[0]
    dtype = fluid["Position"].dtype
    out.setdefault("ElasticStress", jnp.zeros((n, dim, dim), dtype))
    out.setdefault("ElasticStressChangeRate", jnp.zeros((n, dim, dim), dtype))
    out.setdefault("VelocityGradient", jnp.zeros((n, dim, dim), dtype))
    return out


def stress_half_step(fluid: State, dt) -> State:
    """tau += dtau/dt * dt/2 (both halves' staggering)."""
    out = dict(fluid)
    out["ElasticStress"] = (fluid["ElasticStress"]
                            + fluid["ElasticStressChangeRate"] * (0.5 * dt))
    return out


def elastic_stress_force(fluid: State, nl_inner: NeighborList, kernel,
                         dim: int, wall: State | None = None,
                         nl_wall: NeighborList | None = None,
                         box=None) -> jnp.ndarray:
    """Polymeric force (per unit mass times mass, i.e. a Force increment)."""
    pos, tau = fluid["Position"], fluid["ElasticStress"]
    vol = fluid["VolumetricMeasure"]
    pg = pair_geometry(pos, pos, nl_inner, kernel, dim, need_W=False, box=box)
    tau_j, _ = gather(tau, nl_inner.idx)
    vol_j, _ = gather(vol, nl_inner.idx)
    grad = (pg.dW * vol_j)[..., None] * pg.e                     # (N,K,d)
    force = jnp.einsum("nkab,nkb->na", tau[:, None] + tau_j, grad)

    if wall is not None:
        pgw = pair_geometry(pos, wall["Position"], nl_wall, kernel, dim,
                            need_W=False, box=box)
        wvol_j, _ = gather(wall["VolumetricMeasure"], nl_wall.idx)
        gradw = (pgw.dW * wvol_j)[..., None] * pgw.e
        force = force + 2.0 * jnp.einsum(
            "nab,nb->na", tau, jnp.sum(gradw, axis=1))

    return force * (fluid["Mass"] / fluid["Density"])[:, None]


def stress_rate(fluid: State, model) -> State:
    """Upper-convected Maxwell rate from the current VelocityGradient."""
    out = dict(fluid)
    g = fluid["VelocityGradient"]
    gt = jnp.swapaxes(g, -1, -2)
    tau = fluid["ElasticStress"]
    out["ElasticStressChangeRate"] = (
        gt @ tau + tau @ g - tau / model.relaxation_time
        + (gt + g) * (model.mu_p / model.relaxation_time))
    return out
