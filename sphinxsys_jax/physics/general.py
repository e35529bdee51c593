"""General dynamics: external forces, reductions, geometric ops.

Counterpart of /root/reference/src/shared/particle_dynamics/general_dynamics/
(GravityForce external_force/, reductions general_reduce.h:46-215,
NormalDirectionFromBodyShape general_geometric.cpp:18-26).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax.numpy as jnp

from sphinxsys_jax.core.state import State, valid_mask


@dataclasses.dataclass(frozen=True)
class Gravity:
    """Constant gravity field (external_force.h class Gravity)."""

    acceleration: Tuple[float, ...]
    zero_potential_reference: Tuple[float, ...] | None = None

    def induced_acceleration(self, pos=None):
        return jnp.asarray(self.acceleration)

    def potential(self, pos):
        g = jnp.asarray(self.acceleration, dtype=pos.dtype)
        ref = jnp.zeros_like(g) if self.zero_potential_reference is None \
            else jnp.asarray(self.zero_potential_reference, dtype=pos.dtype)
        return (ref - pos) @ g


def gravity_force(state: State, gravity: Gravity) -> State:
    """SimpleDynamics<GravityForce<Gravity>>.

    The reference's GravityForce is a BaseForcePrior (force_prior.hpp):
    ForcePrior += F_new - F_prev, so per-step gravity COEXISTS with other
    prior-force producers (viscous/TVC/TKE) that fold their own deltas
    into ForcePrior.  States that carry other prior forces must seed a
    "GravityForcePrev" channel (zeros) at init to opt into the delta
    form; without it this falls back to the overwrite form
    ForcePrior = m g, which is only correct when gravity is the SOLE
    producer (plain dambreak-class cases) — an overwrite silently
    cancels any accumulated viscous force down to its per-step delta
    (the round-4 MR-cylinder 2x-drag root cause)."""
    out = dict(state)
    g = gravity.induced_acceleration().astype(state["Position"].dtype)
    force = state["Mass"][:, None] * g[None, :]
    prev = state.get("GravityForcePrev")
    if prev is None:
        out["ForcePrior"] = force
    else:
        out["ForcePrior"] = state["ForcePrior"] + force - prev
        out["GravityForcePrev"] = force
    return out


def total_kinetic_energy(state: State):
    """ReduceDynamics<TotalKineticEnergy> (general_reduce.cpp:54-64)."""
    ke = 0.5 * state["Mass"] * jnp.sum(state["Velocity"] ** 2, axis=-1)
    return jnp.sum(jnp.where(valid_mask(state), ke, 0.0))


def total_mechanical_energy(state: State, gravity: Gravity):
    """ReduceDynamics<TotalMechanicalEnergy> (general_reduce.cpp:67-78):
    sum of 0.5 m v^2 + m * potential(pos)."""
    ke = 0.5 * state["Mass"] * jnp.sum(state["Velocity"] ** 2, axis=-1)
    pe = state["Mass"] * gravity.potential(state["Position"])
    return jnp.sum(jnp.where(valid_mask(state), ke + pe, 0.0))


def maximum_speed(state: State):
    """ReduceDynamics<MaximumSpeed> (general_reduce.h)."""
    v = jnp.linalg.norm(state["Velocity"], axis=-1)
    return jnp.max(jnp.where(valid_mask(state), v, 0.0))


def velocity_bound_check(state: State, velocity_bound: float):
    """ReduceOR VelocityBoundCheck (general_reduce.h:64)."""
    v2 = jnp.sum(state["Velocity"] ** 2, axis=-1)
    return jnp.any(jnp.where(valid_mask(state), v2 > velocity_bound**2, False))


def quantity_summation(state: State, name: str):
    """ReduceDynamics<QuantitySummation<T>> — masked total of a variable."""
    arr = state[name]
    mask = valid_mask(state)
    if arr.ndim == 2:
        return jnp.sum(jnp.where(mask[:, None], arr, 0.0), axis=0)
    return jnp.sum(jnp.where(mask, arr, 0.0))


def velocity_gradient(state: State, nl, kernel, dim: int, box=None,
                      walls=(), distance_from_wall=None):
    """grad v_i = -sum_j (v_i - v_j) outer gradW_ij V_j
    (velocity_gradient.* / general gradient ops).

    `walls`: (wall_state, nl_wall) pairs add the VelocityGradient
    <Contact<Wall>> term (velocity_gradient.cpp:12-33): the pair velocity
    jump is amplified by factor = 1 - d_w.(d_w - r e)/|d_w|^2, the linear
    extrapolation of the no-slip condition from the wall SURFACE (at
    distance-from-wall vector d_w) to the dummy particle.  Pass
    `distance_from_wall` (N, dim), e.g. computed exactly from the wall
    shape's SDF — sd(pos) * normal(pos) — in place of the reference's
    particle-reconstructed DistanceFromWall (near_wall_boundary.cpp)."""
    from sphinxsys_jax.neighbors.neighbor_list import gather
    from sphinxsys_jax.physics.pair import pair_geometry

    pos, vel = state["Position"], state["Velocity"]
    pg = pair_geometry(pos, pos, nl, kernel, dim, need_W=False, box=box)
    vel_j, _ = gather(vel, nl.idx)
    vol_j, _ = gather(state["VolumetricMeasure"], nl.idx)
    grad = (pg.dW * vol_j)[..., None] * pg.e
    g = -jnp.einsum("nki,nkj->nij", vel[:, None, :] - vel_j, grad)

    for wstate, wnl in walls:
        pgw = pair_geometry(pos, wstate["Position"], wnl, kernel, dim,
                            need_W=False, box=box)
        wvol, _ = gather(wstate["VolumetricMeasure"], wnl.idx)
        wvel, _ = gather(wstate["AverageVelocity"], wnl.idx)
        gradw = (pgw.dW * wvol)[..., None] * pgw.e
        dvel = vel[:, None, :] - wvel
        if distance_from_wall is not None:
            dw = distance_from_wall
            ddiff = dw[:, None, :] - pgw.r[..., None] * pgw.e
            dw2 = jnp.sum(dw * dw, axis=-1) + 1.0e-15
            factor = 1.0 - jnp.sum(dw[:, None, :] * ddiff, axis=-1) / dw2[:, None]
            dvel = factor[..., None] * dvel
        g = g - jnp.einsum("nki,nkj->nij", dvel, gradw)
    return g


def vorticity(state: State, nl, kernel, dim: int, box=None):
    """InteractionDynamics<VorticityInner>: curl of velocity (2D scalar,
    3D vector)."""
    g = velocity_gradient(state, nl, kernel, dim, box)
    if dim == 2:
        return g[:, 1, 0] - g[:, 0, 1]
    return jnp.stack([g[:, 2, 1] - g[:, 1, 2],
                      g[:, 0, 2] - g[:, 2, 0],
                      g[:, 1, 0] - g[:, 0, 1]], axis=-1)


def normal_direction_from_shape(state: State, shape) -> State:
    """SimpleDynamics<NormalDirectionFromBodyShape>
    (general_geometric.cpp:18-26): store the shape normal and signed
    distance at each particle."""
    from sphinxsys_jax.utils.hosteval import host_eval

    out = dict(state)
    pos = state["Position"]
    dtype = pos.dtype
    n, phi = host_eval(
        lambda p: (shape.find_normal_direction(p), shape.signed_distance(p)), pos)
    n = jnp.asarray(n, dtype)
    phi = jnp.asarray(phi, dtype)
    out["NormalDirection"] = n
    out["InitialNormalDirection"] = n
    out["SignedDistance"] = phi
    out["InitialSignedDistance"] = phi
    return out
