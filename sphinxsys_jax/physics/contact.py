"""Dynamic solid-solid contact (penalty repulsion).

Counterpart of /root/reference/src/shared/particle_dynamics/solid_dynamics/
contact_dynamics/ (repulsion_factor_summation.cpp, contact_repulsion.cpp):

  * RepulsionFactor: a density-like penetration measure
      contact: sigma_i = sum_k W_ik V_k           (other body's particles)
      self:    sigma_i = sum_j max(W_ij - W(dp), 0) V_j
  * RepulsionForce (pressure-like penalty, stiffness = rho0 c0^2,
    base_material.h:112-117):
      contact: F_i = -V_i k_ave sum_j 2 * 0.5(sigma_i + sigma_j) dW e_ij V_j
      wall:    uses only this body's factor with the wall's volume
  * PairwiseFrictionFromWall (contact_friction.h) — pairwise velocity
    damping against wall particles.

Accumulated into ForcePrior via fsi.force_prior_update.
"""

from __future__ import annotations

import math

import jax.numpy as jnp

from sphinxsys_jax.core.state import State
from sphinxsys_jax.neighbors.neighbor_list import NeighborList, gather
from sphinxsys_jax.physics.pair import pair_geometry
from sphinxsys_jax.physics.fsi import force_prior_update

TINY = 1.0e-15


def contact_stiffness(material) -> float:
    """rho0 c0^2 (base_material.h:117); for elastic solids c0=sqrt(K/rho0)
    so this equals the bulk modulus."""
    c0 = getattr(material, "sound_speed", None)
    if c0 is None:
        raise ValueError("material needs a sound_speed")
    c0 = c0 if isinstance(c0, float) else float(c0)
    return material.rho0 * c0 * c0


def repulsion_factor_contact(solid: State, other: State, nl: NeighborList,
                             kernel, dim: int) -> jnp.ndarray:
    """sigma_i = sum_j W_ij V_j over the other body's particles."""
    pg = pair_geometry(solid["Position"], other["Position"], nl, kernel, dim,
                       need_dW=False)
    vol_j, _ = gather(other["VolumetricMeasure"], nl.idx)
    return jnp.sum(pg.W * vol_j, axis=1)


def repulsion_factor_self(solid: State, nl_inner: NeighborList, kernel,
                          dim: int, spacing: float) -> jnp.ndarray:
    """Self-contact factor with the W(dp) offset so the resting lattice
    reads zero (repulsion_factor_summation.cpp:8-18)."""
    pg = pair_geometry(solid["Position"], solid["Position"], nl_inner, kernel,
                       dim, need_dW=False)
    vol_j, _ = gather(solid["VolumetricMeasure"], nl_inner.idx)
    offset = kernel.W(jnp.asarray(spacing), dim)
    w_corr = jnp.maximum(pg.W - offset, 0.0) * pg.mask
    return jnp.sum(w_corr * vol_j, axis=1)


def repulsion_force_contact(solid: State, other: State, nl: NeighborList,
                            kernel, dim: int, factor_self, factor_other,
                            stiffness_ave: float,
                            force_name: str = "RepulsionForce") -> State:
    """Cross-body penalty force (contact_repulsion.cpp:52-75)."""
    pg = pair_geometry(solid["Position"], other["Position"], nl, kernel, dim,
                       need_W=False)
    vol_j, _ = gather(other["VolumetricMeasure"], nl.idx)
    sig_j, _ = gather(factor_other, nl.idx)
    sigma_star = 0.5 * (factor_self[:, None] + sig_j)
    force = -jnp.sum((2.0 * sigma_star * pg.dW * vol_j)[..., None] * pg.e, axis=1)
    force = stiffness_ave * force * solid["VolumetricMeasure"][:, None]
    return force_prior_update(solid, force_name, force)


def repulsion_force_wall(solid: State, wall: State, nl: NeighborList, kernel,
                         dim: int, factor_self, stiffness: float,
                         impedance: float = 0.0,
                         force_name: str = "RepulsionForce") -> State:
    """Penalty force against a rigid wall (contact_repulsion.cpp Wall
    variant): p_i = sigma_i * stiffness; optional acoustic impedance
    damping rho0*c0*du (used by the self-contact variant)."""
    pg = pair_geometry(solid["Position"], wall["Position"], nl, kernel, dim,
                       need_W=False)
    vol_j, _ = gather(wall["VolumetricMeasure"], nl.idx)
    p_i = factor_self * stiffness
    term = 2.0 * p_i[:, None]
    if impedance > 0.0:
        vel_j, _ = gather(wall["Velocity"], nl.idx)
        du = jnp.sum((solid["Velocity"][:, None, :] - vel_j) * (-pg.e), axis=-1)
        term = term + 2.0 * 0.5 * impedance * du
    force = -jnp.sum((term * pg.dW * vol_j)[..., None] * pg.e, axis=1)
    force = force * solid["VolumetricMeasure"][:, None]
    return force_prior_update(solid, force_name, force)


def dynamic_contact_force_with_wall(solid: State, wall: State,
                                    nl: NeighborList, kernel, dim: int,
                                    material, spacing_solid: float,
                                    spacing_wall: float,
                                    penalty_strength: float = 1.0) -> State:
    """DynamicContactForceWithWall (high-velocity impact contact; the
    case-local class of test_3d_taylor_bar_UL/taylor_bar_UL.h:69-135):
    acoustic-impedance term 0.5 rho0 c0 (v_i - v_j)·(-n_j) plus a
    quadratic penetration penalty active once the particle comes within
    half a wall spacing of a wall particle along its normal.

    Deviation note: the reference accumulates this force into ForcePrior
    RAW every acoustic step (force_prior_ += ..., "note that prior force
    directly used here") with no previous-force subtraction — we mirror
    that exactly since the committed KE regression DB encodes it; callers
    must pass the persistent ForcePrior through the acoustic loop."""
    # ContactStiffness = rho0 c0^2 (base_material.h:117); the case then
    # uses impedance = rho0 sqrt(ContactStiffness) and reference_pressure
    # = rho0 ContactStiffness (taylor_bar_UL.h:84-85) — dimensionally odd
    # (rho0^1.5 c0 / rho0^2 c0^2) but that is what the committed DB ran.
    stiffness = material.rho0 * material.c0 ** 2
    impedance = material.rho0 * math.sqrt(stiffness)
    reference_pressure = material.rho0 * stiffness
    ratio2 = 0.1 * (spacing_wall / spacing_solid) ** 2

    pg = pair_geometry(solid["Position"], wall["Position"], nl, kernel, dim,
                       need_W=False)
    vol_j, _ = gather(wall["VolumetricMeasure"], nl.idx)
    vel_j, _ = gather(wall["Velocity"], nl.idx)
    n_j, _ = gather(wall["NormalDirection"], nl.idx)
    v_rel = solid["Velocity"][:, None, :] - vel_j
    impedance_p = 0.5 * impedance * jnp.sum(v_rel * (-n_j), axis=-1)
    e_dot_n = jnp.sum(pg.e * n_j, axis=-1)
    overlap = pg.r * e_dot_n
    delta = 2.0 * overlap / spacing_wall
    beta = jnp.where(delta < 1.0, (1.0 - delta) ** 2 * ratio2, 0.0)
    penalty_p = penalty_strength * beta * jnp.abs(overlap) * reference_pressure
    force = -jnp.sum((2.0 * (impedance_p + penalty_p) * e_dot_n
                      * pg.dW * vol_j)[..., None] * n_j, axis=1)
    out = dict(solid)
    out["ForcePrior"] = solid["ForcePrior"] + \
        force * solid["VolumetricMeasure"][:, None]
    return out


def filter_self_contact_pairs(nl: NeighborList, pos0, cutoff: float
                              ) -> NeighborList:
    """NeighborBuilderSelfContact (neighborhood.cpp:128-141): keep only
    pairs whose INITIAL separation exceeds the kernel cutoff — material
    neighbors never register as self contact, whatever the deformation.
    Filtered slots get the sentinel index."""
    n = pos0.shape[0]
    p0_j, mask = gather(pos0, nl.idx)
    d0 = jnp.linalg.norm(pos0[:, None, :] - p0_j, axis=-1)
    keep = mask & (d0 > cutoff)
    idx = jnp.where(keep, nl.idx, n)
    return NeighborList(idx=idx, count=jnp.sum(keep, axis=1).astype(
        nl.count.dtype), overflow=nl.overflow)


def repulsion_force_self(solid: State, nl_self: NeighborList, kernel,
                         dim: int, factor, rho0: float, stiffness: float,
                         force_name: str = "RepulsionForce") -> State:
    """SelfContactForce = RepulsionForce<Contact<Inner<>>>
    (contact_repulsion.cpp:17-32): symmetric pressure-like penalty over the
    self-contact pairs plus acoustic impedance damping
    Z = sqrt(rho0 * ContactStiffness) on the pair-normal velocity jump."""
    pg = pair_geometry(solid["Position"], solid["Position"], nl_self, kernel,
                       dim, need_W=False)
    vol_j, _ = gather(solid["VolumetricMeasure"], nl_self.idx)
    sig_j, _ = gather(factor, nl_self.idx)
    vel_j, _ = gather(solid["Velocity"], nl_self.idx)
    p_star = 0.5 * (factor[:, None] + sig_j) * stiffness
    z = math.sqrt(rho0 * stiffness)
    du = jnp.sum((solid["Velocity"][:, None, :] - vel_j) * (-pg.e), axis=-1)
    term = p_star + 0.5 * z * du
    force = -jnp.sum((2.0 * term * pg.dW * vol_j)[..., None] * pg.e, axis=1)
    force = force * solid["VolumetricMeasure"][:, None]
    return force_prior_update(solid, force_name, force)


def pairwise_friction_from_wall(solid: State, wall: State, nl: NeighborList,
                                kernel, dim: int, eta: float, dt) -> State:
    """PairwiseFrictionFromWall (contact_friction.h:49): implicit-flavored
    pairwise tangential damping against wall particles, applied directly to
    the velocity (Jacobi form of the reference's colored sweep)."""
    pg = pair_geometry(solid["Position"], wall["Position"], nl, kernel, dim,
                       need_W=False)
    vol_j, _ = gather(wall["VolumetricMeasure"], nl.idx)
    vel_j, _ = gather(wall["Velocity"], nl.idx)
    dvel = solid["Velocity"][:, None, :] - vel_j
    # tangential component relative to the pair direction
    normal_part = jnp.sum(dvel * pg.e, axis=-1)[..., None] * pg.e
    tangential = dvel - normal_part
    coeff = -2.0 * eta * pg.dW * vol_j * dt / jnp.maximum(
        solid["Mass"], TINY)[:, None]
    coeff = jnp.maximum(coeff, 0.0) * pg.mask
    # implicit (saturating) Jacobi form: v' = (v + sum c w)/(1 + sum c) so
    # that eta -> inf removes AT MOST the full pairwise tangential jump —
    # the reference gets the same boundedness from its sequential
    # pair-by-pair sweep (contact_friction.h parallel_exec coloring)
    denom = 1.0 + jnp.sum(coeff, axis=1)
    dv = -jnp.sum(coeff[..., None] * tangential, axis=1) / denom[:, None]
    out = dict(solid)
    out["Velocity"] = solid["Velocity"] + dv
    return out


GAUSS_3_POINTS = (0.0, 0.7745966692414834, -0.7745966692414834)
GAUSS_3_WEIGHTS = (0.8888888888888889, 0.5555555555555556, 0.5555555555555556)


def shell_contact_factor(solid: State, shell: State, nl: NeighborList,
                         kernel, dim: int, spacing: float,
                         shell_spacing: float | None = None,
                         heuristic_limiter: float = 0.1) -> jnp.ndarray:
    """ShellContactFactor (repulsion_factor_summation.cpp:52-104): the
    penetration measure against a SURFACE (shell) body.  The kernel sum is
    offset by W(dp_avg) and rescaled by a calibration factor 1/contact_max,
    where contact_max is the Gauss-integrated value a flat fully-resolved
    shell would produce at zero separation — so factor ~ 1 at touch — and
    damped by the heuristic limiter 0.1 (max contact pressure 0.1 K)."""
    import jax

    dtype = solid["Position"].dtype
    dp_shell = spacing if shell_spacing is None else shell_spacing
    dp_avg = 0.5 * (spacing + dp_shell)
    with jax.ensure_compile_time_eval():
        offset = kernel.W(jnp.asarray(dp_avg, dtype), dim)
        contact_max = jnp.zeros((), dtype)
        for gp, gw in zip(GAUSS_3_POINTS, GAUSS_3_WEIGHTS):
            t = gp * dp_avg * 0.5 + dp_avg * 0.5
            c = 2.0 * (kernel.W(jnp.asarray(t, dtype), dim) - offset) * dp_avg * 0.5 * gw
            contact_max = (contact_max + (c if dim == 2 else c * math.pi * t)).astype(dtype)
        calibration = (1.0 / (contact_max + TINY)).astype(dtype)

    pg = pair_geometry(solid["Position"], shell["Position"], nl, kernel, dim,
                       need_dW=False)
    vol_j, _ = gather(shell["VolumetricMeasure"], nl.idx)
    sigma = jnp.sum(jnp.maximum(pg.W - offset, 0.0) * vol_j * pg.mask, axis=1)
    return heuristic_limiter * sigma * calibration
