"""Fluid-structure interaction force coupling.

Counterpart of /root/reference/src/shared/particle_dynamics/solid_dynamics/
fluid_structure_interaction.{h,cpp,hpp}: forces evaluated ON solid particles
from fluid contact neighbors, plus the time-averaged wall kinematics fed
back to the fluid's wall boundary condition.  The general ForcePrior
accumulation (general_dynamics/force_prior.hpp:22-26) is `force_prior_update`.
"""

from __future__ import annotations

import jax.numpy as jnp

from sphinxsys_jax.core.state import State
from sphinxsys_jax.neighbors.neighbor_list import NeighborList, gather
from sphinxsys_jax.physics.pair import pair_geometry

TINY = 1.0e-15


def force_prior_update(state: State, force_name: str, current_force) -> State:
    """ForcePrior: force_prior += F_new - F_prev; store F_new
    (force_prior.hpp:22-26)."""
    out = dict(state)
    prev_key = "Previous" + force_name
    prev = state.get(prev_key, jnp.zeros_like(current_force))
    out["ForcePrior"] = state["ForcePrior"] + current_force - prev
    out[force_name] = current_force
    out[prev_key] = current_force
    return out


def viscous_force_from_fluid(solid: State, fluid: State, nl_sf: NeighborList,
                             kernel, dim: int, mu: float,
                             smoothing_length: float, box=None) -> State:
    """ViscousForceFromFluid (fluid_structure_interaction.cpp):
    F_i = V_i sum_j 2 mu * 2 (v_ave_i - v_j)/(r_ij + 0.01 h) dW_ij V_j,
    accumulated into ForcePrior."""
    pos = solid["Position"]
    pg = pair_geometry(pos, fluid["Position"], nl_sf, kernel, dim,
                       need_W=False, box=box)
    vel_j, _ = gather(fluid["Velocity"], nl_sf.idx)
    vol_j, _ = gather(fluid["VolumetricMeasure"], nl_sf.idx)
    vderiv = 2.0 * (solid["AverageVelocity"][:, None, :] - vel_j) / (pg.r + 0.01 * smoothing_length)[..., None]
    force = 2.0 * mu * jnp.sum(vderiv * (pg.dW * vol_j)[..., None], axis=1)
    force = force * solid["VolumetricMeasure"][:, None]
    return force_prior_update(solid, "ViscousForceFromFluid", force)


def pressure_force_from_fluid(solid: State, fluid: State, nl_sf: NeighborList,
                              kernel, dim: int, riemann, box=None) -> State:
    """PressureForceFromFluid (fluid_structure_interaction.hpp:31-60):
    mirrors the fluid's wall-contact pressure + dissipation terms onto the
    solid.  e_ij points fluid->solid here (j = fluid)."""
    pos = solid["Position"]
    pg = pair_geometry(pos, fluid["Position"], nl_sf, kernel, dim,
                       need_W=False, box=box)
    p_j, _ = gather(fluid["Pressure"], nl_sf.idx)
    rho_j, _ = gather(fluid["Density"], nl_sf.idx)
    mass_j, _ = gather(fluid["Mass"], nl_sf.idx)
    vel_j, _ = gather(fluid["Velocity"], nl_sf.idx)
    vol_j, _ = gather(fluid["VolumetricMeasure"], nl_sf.idx)
    fp_j, _ = gather(fluid["ForcePrior"], nl_sf.idx)

    acc_ave = solid["AverageAcceleration"]
    vel_ave = solid["AverageVelocity"]
    n_i = solid["NormalDirection"]

    face_acc = jnp.sum((fp_j / jnp.maximum(mass_j, TINY)[..., None]
                        - acc_ave[:, None, :]) * pg.e, axis=-1)
    p_in_wall = p_j + rho_j * pg.r * jnp.maximum(face_acc, 0.0)
    e_dot_n = jnp.sum(pg.e * n_i[:, None, :], axis=-1)
    face_to_fluid_n = -jnp.sign(e_dot_n)[..., None] * n_i[:, None, :]
    u_jump = 2.0 * jnp.sum((vel_j - vel_ave[:, None, :]) * face_to_fluid_n, axis=-1)
    term = (riemann.dissipative_p_jump(u_jump)[..., None] * face_to_fluid_n
            + (p_in_wall + p_j)[..., None] * pg.e)
    force = -jnp.sum(term * (pg.dW * vol_j)[..., None], axis=1)
    force = force * solid["VolumetricMeasure"][:, None]
    return force_prior_update(solid, "PressureForceFromFluid", force)


def initialize_displacement(solid: State) -> State:
    """InitializeDisplacement: snapshot positions before the solid
    sub-cycling (fluid_structure_interaction.cpp)."""
    out = dict(solid)
    out["TemporaryPosition"] = solid["Position"]
    return out


def update_average_velocity_acceleration(solid: State, dt) -> State:
    """UpdateAverageVelocityAndAcceleration: time-averaged wall kinematics
    over the fluid acoustic step, fed to the fluid wall BC."""
    out = dict(solid)
    vel_ave_new = (solid["Position"] - solid["TemporaryPosition"]) / (dt + TINY)
    out["AverageAcceleration"] = (vel_ave_new - solid["AverageVelocity"]) / (dt + TINY)
    out["AverageVelocity"] = vel_ave_new
    return out


def update_elastic_normal_direction(solid: State) -> State:
    """UpdateElasticNormalDirection (elastic_dynamics.cpp): rotate the
    initial normal by the rotation of the polar decomposition of F."""
    F = solid["DeformationGradient"]
    n0 = solid["InitialNormalDirection"]
    # polar decomposition rotation via SVD: F = U S V^T, R = U V^T
    U, _, Vt = jnp.linalg.svd(F)
    R = U @ Vt
    out = dict(solid)
    out["NormalDirection"] = jnp.einsum("nij,nj->ni", R, n0)
    return out
