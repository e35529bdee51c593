"""Adaptive-smoothing-length WCSPH fluid ops (multi-resolution fluids).

Counterpart of the reference's *Adaptive dynamics variants
(fluid_dynamics + ParticleWithLocalRefinement, used by
test_2d_free_stream_around_cylinder_mr): the dense-neighbor-list ops of
physics/fluid.py re-derived for per-particle smoothing lengths
h_i = h_ref / SmoothingLengthRatio_i.

Kernel conventions (matching neighbors/multilevel.py and the adaptive
frozen solid pairs):
  * density summation evaluates W at the particle's OWN h (the physical
    interpolation, DensitySummationAdaptive);
  * every PAIR force/gradient evaluates dW at the pair smoothing length
    max(h_i, h_j) (= min of the ratios) — symmetric, so pairwise momentum
    exchange cancels exactly.
"""

from __future__ import annotations

import jax.numpy as jnp

from sphinxsys_jax.core.state import State
from sphinxsys_jax.physics.pair import min_image
from sphinxsys_jax.neighbors.neighbor_list import NeighborList, gather

TINY = 1.0e-15


def adaptive_pair(fluid: State, nl: NeighborList, kernel, dim: int, box=None):
    """Shared pair quantities: (r, e, dW_pair, hr_pair, vol_j, mask)."""
    pos = fluid["Position"]
    hr = fluid["SmoothingLengthRatio"]
    pos_j, mask = gather(pos, nl.idx)
    hr_j, _ = gather(hr, nl.idx)
    vol_j, _ = gather(fluid["VolumetricMeasure"], nl.idx)
    disp = pos[:, None, :] - pos_j
    if box is not None and any(b > 0 for b in box):
        disp = min_image(disp, box)
    r = jnp.sqrt(jnp.sum(disp * disp, axis=-1) + TINY)
    e = disp / (r[..., None] + TINY)
    hr_pair = jnp.minimum(hr[:, None], hr_j)       # pair h = max(h_i, h_j)
    dW = kernel.dW_adaptive(r, hr_pair, dim) * mask
    return r, e, dW, hr_pair, vol_j, mask


def density_summation_adaptive(fluid: State, nl: NeighborList, kernel,
                               dim: int, rho0: float, box=None,
                               wall: State = None,
                               nl_wall: NeighborList = None,
                               free_surface: bool = False) -> State:
    """rho_i = m_i W(0; h_i) + sum m_j W(r; h_i) (+ rho0 sum_wall W V);
    Vol = m / rho.  `free_surface` clamps rho >= rho0 (truncated supports
    at a surface otherwise read negative pressure)."""
    pos = fluid["Position"]
    hr = fluid["SmoothingLengthRatio"]
    mass = fluid["Mass"]
    pos_j, mask = gather(pos, nl.idx)
    m_j, _ = gather(mass, nl.idx)
    disp = pos[:, None, :] - pos_j
    if box is not None and any(b > 0 for b in box):
        disp = min_image(disp, box)
    r = jnp.linalg.norm(disp, axis=-1)
    W = kernel.W_adaptive(r, hr[:, None], dim) * mask
    w0 = kernel._factor_w(dim) * (hr ** dim) * kernel._w(jnp.zeros((), pos.dtype))
    rho = mass * w0 + jnp.sum(m_j * W, axis=1)
    if wall is not None:
        rho = rho + rho0 * density_wall_adaptive(fluid, wall, nl_wall,
                                                 kernel, dim, box)
    if free_surface:
        rho = jnp.maximum(rho, rho0)
    out = dict(fluid)
    out["Density"] = rho
    out["VolumetricMeasure"] = mass / jnp.maximum(rho, TINY)
    return out


def acoustic_step_1st_half_adaptive(fluid: State, nl: NeighborList, kernel,
                                    dim: int, eos, riemann, dt,
                                    box=None, wall: State = None,
                                    nl_wall: NeighborList = None) -> State:
    out = dict(fluid)
    rho = fluid["Density"] + fluid["DensityChangeRate"] * (0.5 * dt)
    p = eos.pressure(rho)
    pos = fluid["Position"] + fluid["Velocity"] * (0.5 * dt)
    vol = fluid["VolumetricMeasure"]

    f2 = dict(fluid)
    f2["Position"] = pos
    r, e, dW, _, vol_j, mask = adaptive_pair(f2, nl, kernel, dim, box)
    p_j, _ = gather(p, nl.idx)
    dWV = dW * vol_j
    force = -jnp.sum((p[:, None] + p_j)[..., None] * dWV[..., None] * e,
                     axis=1)
    rho_diss = jnp.sum(riemann.dissipative_u_jump(p[:, None] - p_j) * dWV,
                       axis=1)
    drho = rho_diss * rho
    if wall is not None:
        fw, dw = acoustic_1st_half_wall_adaptive(fluid, p, rho, pos, wall,
                                                 nl_wall, kernel, dim,
                                                 riemann, box)
        force = force + fw
        drho = drho + dw
    force_total = fluid["Force"] + force * vol[:, None]
    vel = fluid["Velocity"] + (fluid["ForcePrior"] + force_total) \
        / fluid["Mass"][:, None] * dt
    out.update({"Density": rho, "Pressure": p, "Position": pos,
                "Force": force_total, "DensityChangeRate": drho,
                "Velocity": vel})
    return out


def acoustic_step_2nd_half_adaptive(fluid: State, nl: NeighborList, kernel,
                                    dim: int, riemann, dt,
                                    box=None, wall: State = None,
                                    nl_wall: NeighborList = None) -> State:
    out = dict(fluid)
    pos = fluid["Position"] + fluid["Velocity"] * (0.5 * dt)
    vel = fluid["Velocity"]
    rho = fluid["Density"]
    vol = fluid["VolumetricMeasure"]

    f2 = dict(fluid)
    f2["Position"] = pos
    r, e, dW, _, vol_j, mask = adaptive_pair(f2, nl, kernel, dim, box)
    vel_j, _ = gather(vel, nl.idx)
    dWV = dW * vol_j
    u_jump = jnp.sum((vel[:, None, :] - vel_j) * e, axis=-1)
    # accumulate the advective term onto the 1st half's dissipation; the
    # dissipation force is ASSIGNED and consumed by the NEXT 1st half
    # (fluid_integration.hpp:195, same structure as the uniform op)
    drho_dt = fluid["DensityChangeRate"] + rho * jnp.sum(u_jump * dWV, axis=1)
    p_diss = riemann.dissipative_p_jump(u_jump) * dWV
    force = jnp.sum(p_diss[..., None] * e, axis=1)
    if wall is not None:
        fw, dw = acoustic_2nd_half_wall_adaptive(fluid, vel, rho, pos, wall,
                                                 nl_wall, kernel, dim,
                                                 riemann, box)
        force = force + fw
        drho_dt = drho_dt + dw
    force = vol[:, None] * force
    rho_new = rho + drho_dt * (0.5 * dt)
    out.update({"Position": pos, "Density": rho_new,
                "DensityChangeRate": drho_dt, "Force": force})
    return out


def viscous_force_adaptive(fluid: State, nl: NeighborList, kernel, dim: int,
                           mu: float, h_ref: float, box=None,
                           wall: State = None,
                           nl_wall: NeighborList = None) -> State:
    r, e, dW, hr_pair, vol_j, mask = adaptive_pair(fluid, nl, kernel, dim,
                                                   box)
    vel_j, _ = gather(fluid["Velocity"], nl.idx)
    h_pair = h_ref / jnp.maximum(hr_pair, TINY)
    vderiv = (fluid["Velocity"][:, None, :] - vel_j) \
        / (r + 0.01 * h_pair)[..., None]
    force = 2.0 * mu * jnp.sum(vderiv * (dW * vol_j)[..., None], axis=1)
    if wall is not None:
        force = force + viscous_wall_adaptive(fluid, wall, nl_wall, kernel,
                                              dim, mu, h_ref, box)
    out = dict(fluid)
    vf = force * fluid["VolumetricMeasure"][:, None]
    out["ViscousForce"] = vf
    out["ForcePrior"] = fluid["ForcePrior"] + vf - fluid.get(
        "ViscousForcePrev", jnp.zeros_like(vf))
    out["ViscousForcePrev"] = vf
    return out


def transport_velocity_correction_adaptive(fluid: State, nl: NeighborList,
                                           kernel, dim: int, h_ref: float,
                                           coefficient: float = 0.2,
                                           limiter_slope: float = 100.0,
                                           box=None, walls=(),
                                           scope_mask=None) -> State:
    """Shift with the particle's OWN h^2 scale (the adaptive TVC uses the
    local resolution).  `walls`: (state, nl) wall-type contacts
    (TransportVelocityCorrectionComplexAdaptive); `scope_mask` restricts
    the shift (BulkParticles scope: only Indicator == 0)."""
    r, e, dW, _, vol_j, mask = adaptive_pair(fluid, nl, kernel, dim, box)
    inconsistency = -jnp.sum((2.0 * dW * vol_j)[..., None] * e, axis=1)
    pos = fluid["Position"]
    hr = fluid["SmoothingLengthRatio"]
    for wstate, nl_w in walls:
        rw, ew, dWw, _, volw, mw = _wall_pair(pos, hr, wstate, nl_w, kernel,
                                              dim, box)
        inconsistency = inconsistency - jnp.sum(
            (2.0 * dWw * volw)[..., None] * ew, axis=1)
    h_own = h_ref / jnp.maximum(fluid["SmoothingLengthRatio"], TINY)
    h2 = h_own * h_own
    sq = jnp.sum(inconsistency ** 2, axis=-1)
    lim = jnp.minimum(limiter_slope * h2 * sq, 1.0)
    shift = (coefficient * h2 * lim)[:, None] * inconsistency
    if scope_mask is not None:
        shift = jnp.where(scope_mask[:, None], shift, 0.0)
    out = dict(fluid)
    out["Position"] = fluid["Position"] + shift
    return out


def free_surface_indication_adaptive(fluid: State, nl: NeighborList, kernel,
                                     dim: int, walls=(),
                                     spatial_temporal: bool = False,
                                     box=None) -> State:
    """Adaptive-h variant of fluid.free_surface_indication
    (SpatialTemporalFreeSurfaceIndicationComplex over an
    AdaptiveInnerRelation): position divergence with pair-h kernels, the
    one-layer smear at the particle's OWN h."""
    pos = fluid["Position"]
    hr = fluid["SmoothingLengthRatio"]
    threshold = 0.75 * dim
    r, e, dW, _, vol_j, mask = adaptive_pair(fluid, nl, kernel, dim, box)
    pos_div = -jnp.sum(dW * vol_j * r, axis=1)
    for wstate, nl_w in walls:
        rw, ew, dWw, _, volw, mw = _wall_pair(pos, hr, wstate, nl_w, kernel,
                                              dim, box)
        pos_div = pos_div - jnp.sum(dWw * volw * rw, axis=1)

    out = dict(fluid)
    if spatial_temporal and "PreviousSurfaceIndicator" in fluid:
        prev = fluid["PreviousSurfaceIndicator"]
        prev_j, mj = gather(prev, nl.idx)
        near_prev = jnp.any((prev_j == 1) & mj, axis=1)
        suppress = (pos_div < threshold) & (prev != 1) & ~near_prev
        pos_div = jnp.where(suppress, 2.0 * threshold, pos_div)

    is_surface = pos_div < threshold
    surf_j, mj = gather(is_surface, nl.idx)
    h_own = (kernel.h / jnp.maximum(hr, TINY))[:, None]
    near_surface = jnp.any(surf_j & mj & (r < h_own), axis=1)
    indicator = jnp.where(is_surface | near_surface, 1, 0).astype(jnp.int32)
    out["Indicator"] = indicator
    out["PositionDivergence"] = pos_div
    out["PreviousSurfaceIndicator"] = indicator
    return out


def density_summation_freestream_adaptive(fluid: State, nl: NeighborList,
                                          kernel, dim: int, rho0: float,
                                          box=None, wall: State = None,
                                          nl_wall: NeighborList = None
                                          ) -> State:
    """DensitySummationFreeStreamComplexAdaptive: adaptive summation, then
    the NearFreeStream blend rho_sum + (rho - rho_sum) rho0 / rho for
    particles with a surface-indicated neighbor (density_summation.h:
    141-147)."""
    rho_old = fluid["Density"]
    out = density_summation_adaptive(fluid, nl, kernel, dim, rho0, box=box,
                                     wall=wall, nl_wall=nl_wall,
                                     free_surface=False)
    rho_sum = out["Density"]
    ind_j, mj = gather(fluid["Indicator"], nl.idx)
    near_surface = jnp.any((ind_j == 1) & mj, axis=1)
    blended = jnp.where(rho_sum < rho_old,
                        rho_sum + (rho_old - rho_sum) * rho0 / rho_old,
                        rho_sum)
    rho = jnp.where(near_surface, blended, rho_sum)
    out["Density"] = rho
    out["DensitySummation"] = rho_sum   # free-stream correction weight
    out["VolumetricMeasure"] = fluid["Mass"] / jnp.maximum(rho, TINY)
    return out


# ---------------------------------------------------------------------------
# Wall-contact terms (adaptive variants of the fluid.py wall sections)
# ---------------------------------------------------------------------------

def _wall_pair(pos, hr, wall, nl_w, kernel, dim, box):
    pos_j, mask = gather(wall["Position"], nl_w.idx)
    hrw_j, _ = gather(wall["SmoothingLengthRatio"], nl_w.idx)
    vol_j, _ = gather(wall["VolumetricMeasure"], nl_w.idx)
    disp = pos[:, None, :] - pos_j
    if box is not None and any(b > 0 for b in box):
        disp = min_image(disp, box)
    r = jnp.sqrt(jnp.sum(disp * disp, axis=-1) + TINY)
    e = disp / (r[..., None] + TINY)
    hr_pair = jnp.minimum(hr[:, None], hrw_j)
    dW = kernel.dW_adaptive(r, hr_pair, dim) * mask
    return r, e, dW, hr_pair, vol_j, mask


def density_wall_adaptive(fluid: State, wall: State, nl_w: NeighborList,
                          kernel, dim: int, box=None):
    """Wall contribution to the adaptive density summation: the wall dummy
    particles' W V at the fluid particle's own h."""
    pos = fluid["Position"]
    hr = fluid["SmoothingLengthRatio"]
    pos_j, mask = gather(wall["Position"], nl_w.idx)
    vol_j, _ = gather(wall["VolumetricMeasure"], nl_w.idx)
    disp = pos[:, None, :] - pos_j
    if box is not None and any(b > 0 for b in box):
        disp = min_image(disp, box)
    r = jnp.linalg.norm(disp, axis=-1)
    W = kernel.W_adaptive(r, hr[:, None], dim) * mask
    return jnp.sum(W * vol_j, axis=1)              # sum W V over the wall


def acoustic_1st_half_wall_adaptive(fluid: State, p, rho, pos, wall: State,
                                    nl_w: NeighborList, kernel, dim: int,
                                    riemann, box=None):
    """(force, drho_dt) wall contributions for the adaptive 1st half
    (fluid_integration.hpp:89-113 with the adaptive pair kernel)."""
    hr = fluid["SmoothingLengthRatio"]
    r, e, dW, _, vol_j, mask = _wall_pair(pos, hr, wall, nl_w, kernel, dim,
                                          box)
    acc_prior = fluid["ForcePrior"] / jnp.maximum(fluid["Mass"], TINY)[:, None]
    wall_acc, _ = gather(wall["AverageAcceleration"], nl_w.idx)
    dWV = dW * vol_j
    face_acc = jnp.sum((acc_prior[:, None, :] - wall_acc) * (-e), axis=-1)
    p_in_wall = p[:, None] + rho[:, None] * r * jnp.maximum(face_acc, 0.0)
    force = -jnp.sum((p[:, None] + p_in_wall)[..., None] * dWV[..., None] * e,
                     axis=1)
    drho = jnp.sum(riemann.dissipative_u_jump(p[:, None] - p_in_wall) * dWV,
                   axis=1) * rho
    return force, drho


def acoustic_2nd_half_wall_adaptive(fluid: State, vel, rho, pos, wall: State,
                                    nl_w: NeighborList, kernel, dim: int,
                                    riemann, box=None):
    """(force, drho_dt) wall contributions for the adaptive 2nd half
    (fluid_integration.hpp:205-231)."""
    hr = fluid["SmoothingLengthRatio"]
    r, e, dW, _, vol_j, mask = _wall_pair(pos, hr, wall, nl_w, kernel, dim,
                                          box)
    vel_ave, _ = gather(wall["AverageVelocity"], nl_w.idx)
    n_k, _ = gather(wall["NormalDirection"], nl_w.idx)
    dWV = dW * vol_j
    e_dot_n = jnp.sum(e * n_k, axis=-1)
    face_n = jnp.sign(e_dot_n)[..., None] * n_k
    vel_in_wall = 2.0 * vel_ave - vel[:, None, :]
    dcr = jnp.sum(jnp.sum((vel[:, None, :] - vel_in_wall) * e, axis=-1)
                  * dWV, axis=1) * rho
    u_jump = 2.0 * jnp.sum((vel[:, None, :] - vel_ave) * face_n, axis=-1)
    force = jnp.sum((riemann.dissipative_p_jump(u_jump) * dWV)[..., None]
                    * face_n, axis=1)
    return force, dcr


def viscous_wall_adaptive(fluid: State, wall: State, nl_w: NeighborList,
                          kernel, dim: int, mu: float, h_ref: float,
                          box=None):
    """Wall shear for the adaptive viscous force (doubled jump against the
    averaged wall velocity)."""
    hr = fluid["SmoothingLengthRatio"]
    r, e, dW, hr_pair, vol_j, mask = _wall_pair(fluid["Position"], hr, wall,
                                                nl_w, kernel, dim, box)
    vel_ave, _ = gather(wall["AverageVelocity"], nl_w.idx)
    h_pair = h_ref / jnp.maximum(hr_pair, TINY)
    vderiv = 2.0 * (fluid["Velocity"][:, None, :] - vel_ave) \
        / (r + 0.01 * h_pair)[..., None]
    return 2.0 * mu * jnp.sum(vderiv * (dW * vol_j)[..., None], axis=1)
