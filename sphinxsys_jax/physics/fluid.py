"""Weakly-compressible SPH fluid dynamics.

Counterpart of /root/reference/src/shared/particle_dynamics/fluid_dynamics/
(the legacy stack) and shared_ck/particle_dynamics/fluid_dynamics (CK).
Every op is a pure function: (states, neighbor lists, dt) -> new arrays.
The reference's Dynamics1Level {initialization, interaction, update} POD
kernels become three fused array stages inside one jitted function; the
per-i scatter-free gather formulation replaces its i/j atomic writes.

Scheme (dual half-step "Verlet" pressure/density relaxation,
fluid_integration.hpp):

  1st half (pressure relaxation), dt = acoustic dt:
    init:     rho += drho_dt * dt/2 ; p = EoS(rho) ; x += v * dt/2
    interact: F_i = -V_i * sum_j (p_i + p_j) dW_ij V_j e_ij
              drho_dt_i = rho_i * sum_j UJump(p_i - p_j) dW_ij V_j
              (+ wall terms with p reconstructed in the wall,
               fluid_integration.hpp:89-113)
    update:   v += (F + F_prior) / m * dt

  2nd half (density relaxation):
    init:     x += v * dt/2
    interact: drho_dt_i += rho_i * sum_j (v_i - v_j).e_ij dW_ij V_j
              F_i = V_i * sum_j PJump(u_jump) dW_ij V_j e_ij
              (+ wall terms with mirrored wall velocity,
               fluid_integration.hpp:205-231)
    update:   rho += drho_dt * dt/2
"""

from __future__ import annotations

from typing import Sequence

import jax.numpy as jnp

from sphinxsys_jax.core.state import State
from sphinxsys_jax.neighbors.neighbor_list import NeighborList, gather
from sphinxsys_jax.physics.pair import pair_geometry

TINY = 1.0e-15


# ---------------------------------------------------------------------------
# Density by summation (density_summation.cpp)
# ---------------------------------------------------------------------------

def density_summation(fluid: State, nl_inner: NeighborList, kernel, dim: int,
                      rho0: float, sigma0: float,
                      contacts: Sequence[tuple] = (),
                      free_surface: bool = True, box=None,
                      shell_contacts: Sequence[tuple] = (),
                      levelsets: Sequence = ()) -> State:
    """DensitySummationComplex(FreeSurface): inner + contact summation, then
    rho update.  `contacts` is a sequence of (contact_state, nl_contact,
    contact_rho0) for wall/solid bodies seen as contact.

    inner:   sigma = W0 + sum W_ij ;  rho_sum = sigma * rho0 / sigma0
    contact: rho_sum += [sum W_ik m_k / rho0_k] * rho0^2 / sigma0 / m_i
    update:  free surface: rho = max(rho_sum, rho0)  (density_summation.hpp:29-32)
             otherwise:    rho = rho_sum ; Vol = m / rho
    """
    pos = fluid["Position"]
    pg = pair_geometry(pos, pos, nl_inner, kernel, dim, need_dW=False, box=box)
    w0 = kernel.w0(dim)
    sigma = w0 + jnp.sum(pg.W, axis=1)
    rho_sum = sigma * rho0 / sigma0

    for c_state, nl_c, c_rho0 in contacts:
        pgc = pair_geometry(pos, c_state["Position"], nl_c, kernel, dim,
                            need_dW=False, box=box)
        mass_k, _ = gather(c_state["Mass"], nl_c.idx)
        sigma_c = jnp.sum(pgc.W * mass_k / c_rho0, axis=1)
        rho_sum = rho_sum + sigma_c * rho0 * rho0 / sigma0 / fluid["Mass"]

    # shell contacts: frozen curvature-corrected pair kernels
    # (physics/shell_fluid.py; neighborhood.cpp FromShellToFluid)
    for s_state, nl_s, s_pairs, s_rho0 in shell_contacts:
        from sphinxsys_jax.physics.shell_fluid import density_summation_shell_term

        rho_sum = rho_sum + density_summation_shell_term(
            fluid, s_state, s_pairs, nl_s, rho0, sigma0, s_rho0)

    # level-set confinement term (StaticConfinementDensity,
    # shape_confinement.cpp:20-25): the wall region's kernel integral stands
    # in for the missing wall-particle sum
    for ls in levelsets:
        ki = ls.compute_kernel_integral(pos)
        rho_sum = rho_sum + ki * rho0 * rho0 / sigma0 / fluid["Mass"]

    out = dict(fluid)
    out["DensitySummation"] = rho_sum
    if free_surface:
        out["Density"] = jnp.maximum(rho_sum, rho0)
    else:
        out["Density"] = rho_sum
        out["VolumetricMeasure"] = fluid["Mass"] / rho_sum
    return out


# ---------------------------------------------------------------------------
# Acoustic step, 1st half — pressure relaxation (fluid_integration.hpp:50-113)
# ---------------------------------------------------------------------------

def kernel_correction_matrix(fluid: State, nl_inner: NeighborList, kernel,
                             dim: int, wall: State | None = None,
                             nl_wall: NeighborList | None = None,
                             alpha: float = 0.0, box=None,
                             out_key: str = "LinearGradientCorrectionMatrix"
                             ) -> State:
    """LinearGradientCorrectionMatrix[Complex] (kernel_correction.h +
    general_gradient.*): local configuration A = -sum r_ji (dW V_j e)^T over
    inner (+ wall contact) neighbors, then the determinant-weighted blend
    B = w1 inv(A) + w2 I with w2 ~ max(alpha - det A, 0) that falls back to
    identity for deficient supports."""
    pos, vol = fluid["Position"], fluid["VolumetricMeasure"]
    pg = pair_geometry(pos, pos, nl_inner, kernel, dim, need_W=False, box=box)
    vol_j, _ = gather(vol, nl_inner.idx)
    gradw = (pg.dW * vol_j)[..., None] * pg.e
    r_ji = pg.r[..., None] * pg.e
    A = -jnp.sum(r_ji[..., :, None] * gradw[..., None, :], axis=1)
    if wall is not None:
        pgw = pair_geometry(pos, wall["Position"], nl_wall, kernel, dim,
                            need_W=False, box=box)
        wvol_j, _ = gather(wall["VolumetricMeasure"], nl_wall.idx)
        gradww = (pgw.dW * wvol_j)[..., None] * pgw.e
        r_jiw = pgw.r[..., None] * pgw.e
        A = A - jnp.sum(r_jiw[..., :, None] * gradww[..., None, :], axis=1)
    A = A + 1.0e-6 * jnp.eye(dim, dtype=pos.dtype)
    det = jnp.linalg.det(A)
    det_sqr = jnp.maximum(alpha - det, 0.0)
    w1 = det / (det + det_sqr + TINY)
    w2 = det_sqr / (det + det_sqr + TINY)
    out = dict(fluid)
    out[out_key] = (w1[:, None, None] * jnp.linalg.inv(A)
                    + w2[:, None, None] * jnp.eye(dim, dtype=pos.dtype))
    return out


def acoustic_step_1st_half(fluid: State, nl_inner: NeighborList, kernel, dim: int,
                           eos, riemann, dt,
                           wall: State | None = None,
                           nl_wall: NeighborList | None = None,
                           wall_riemann=None, box=None,
                           walls: Sequence[tuple] = (),
                           contacts: Sequence[tuple] = (),
                           correction: bool = False,
                           shell_walls: Sequence[tuple] = (),
                           levelsets: Sequence = (),
                           extra_force=None) -> State:
    """`shell_walls`: shell bodies seen as wall contacts, as (shell_state,
    neighbor_list, ShellContactPairs) triples — the corrected pair kernels
    are FROZEN per advection step (physics/shell_fluid.py).

    `walls`: additional wall-type contacts as (state, neighbor_list)
    pairs (e.g. rigid wall + elastic insert in fsi2.cpp:135-137); the
    single wall/nl_wall pair is kept for convenience.

    `contacts`: fluid-fluid (multi-phase) contacts as (other_state,
    neighbor_list, cross_riemann) triples — the Integration1stHalf
    <Contact<>> terms (fluid_integration.hpp:116-157): impedance-weighted
    interface pressure and cross-phase density dissipation.

    `correction`: use the reverse-kernel-gradient-corrected pressure force
    -(p_i B_j + p_j B_i) dW V_j e_ij (Integration1stHalfCorrection...,
    fluid_integration.hpp:75 with LinearGradientCorrection) reading
    fluid["LinearGradientCorrectionMatrix"]."""
    out = dict(fluid)
    # --- initialization -----------------------------------------------
    rho = fluid["Density"] + fluid["DensityChangeRate"] * (0.5 * dt)
    p = eos.pressure(rho)
    pos = fluid["Position"] + fluid["Velocity"] * (0.5 * dt)
    vol = fluid["VolumetricMeasure"]

    # --- interaction: inner ---------------------------------------------
    pg = pair_geometry(pos, pos, nl_inner, kernel, dim, need_W=False, box=box)
    p_j, _ = gather(p, nl_inner.idx)
    vol_j, _ = gather(vol, nl_inner.idx)
    dWV = pg.dW * vol_j
    if correction:
        B = fluid["LinearGradientCorrectionMatrix"]
        B_j, _ = gather(B, nl_inner.idx)
        Be_i = jnp.einsum("nab,nkb->nka", B, pg.e)
        Be_j = jnp.einsum("nkab,nkb->nka", B_j, pg.e)
        force = -jnp.sum((p[:, None, None] * Be_j + p_j[..., None] * Be_i)
                         * dWV[..., None], axis=1)
    else:
        force = -jnp.sum((p[:, None] + p_j)[..., None] * dWV[..., None] * pg.e, axis=1)
    rho_dissipation = jnp.sum(riemann.dissipative_u_jump(p[:, None] - p_j) * dWV, axis=1)

    drho_dt = rho_dissipation * rho
    force_total = fluid["Force"] + force * vol[:, None]

    # --- interaction: wall contacts (hpp:89-113) --------------------------
    wall_list = list(walls)
    if wall is not None:
        wall_list.append((wall, nl_wall))
    wr = wall_riemann or riemann
    for wstate, wnl in wall_list:
        pgw = pair_geometry(pos, wstate["Position"], wnl, kernel, dim,
                            need_W=False, box=box)
        wall_vol, _ = gather(wstate["VolumetricMeasure"], wnl.idx)
        wall_acc_ave, _ = gather(wstate["AverageAcceleration"], wnl.idx)
        dWV_w = pgw.dW * wall_vol
        acc_prior = fluid["ForcePrior"] / fluid["Mass"][:, None]
        # pressure reconstructed in the wall from the hydrostatic projection
        face_acc = jnp.sum((acc_prior[:, None, :] - wall_acc_ave) * (-pgw.e), axis=-1)
        p_in_wall = p[:, None] + rho[:, None] * pgw.r * jnp.maximum(face_acc, 0.0)
        if correction:
            Be_iw = jnp.einsum("nab,nkb->nka",
                               fluid["LinearGradientCorrectionMatrix"], pgw.e)
            force_w = -jnp.sum((p[:, None] + p_in_wall)[..., None]
                               * dWV_w[..., None] * Be_iw, axis=1)
        else:
            force_w = -jnp.sum((p[:, None] + p_in_wall)[..., None] * dWV_w[..., None] * pgw.e, axis=1)
        rho_diss_w = jnp.sum(wr.dissipative_u_jump(p[:, None] - p_in_wall) * dWV_w, axis=1)
        force_total = force_total + force_w * vol[:, None]
        drho_dt = drho_dt + rho_diss_w * rho

    for sstate, snl, spairs in shell_walls:
        from sphinxsys_jax.physics.shell_fluid import acoustic_1st_half_shell_term

        force_s, rho_diss_s = acoustic_1st_half_shell_term(
            p, rho, fluid, sstate, spairs, snl, wr)
        force_total = force_total + force_s * vol[:, None]
        drho_dt = drho_dt + rho_diss_s * rho

    # level-set confinement pressure force (StaticConfinementIntegration
    # 1stHalf, shape_confinement.cpp:39-43): F -= 2 V_i p_i * KGI(pos)
    for ls in levelsets:
        kgi = ls.compute_kernel_gradient_integral(pos)
        force_total = force_total - 2.0 * (p * vol)[:, None] * kgi

    # --- interaction: fluid-fluid contacts (hpp:132-157) -------------------
    for cstate, cnl, crs in contacts:
        pgc = pair_geometry(pos, cstate["Position"], cnl, kernel, dim,
                            need_W=False, box=box)
        vol_k, _ = gather(cstate["VolumetricMeasure"], cnl.idx)
        p_k, _ = gather(cstate["Pressure"], cnl.idx)
        dWV_c = pgc.dW * vol_k
        p_star = crs.average_p(p[:, None], p_k)
        force_c = -jnp.sum((2.0 * p_star * dWV_c)[..., None] * pgc.e, axis=1)
        rho_diss_c = jnp.sum(crs.dissipative_u_jump(p[:, None] - p_k) * dWV_c,
                             axis=1)
        force_total = force_total + force_c * vol[:, None]
        drho_dt = drho_dt + rho_diss_c * rho

    # --- update -----------------------------------------------------------
    if extra_force is not None:
        # composed force term (e.g. the Oldroyd-B polymeric stress force,
        # physics/oldroyd.py) folded into this half's velocity update
        force_total = force_total + extra_force
    vel = fluid["Velocity"] + (fluid["ForcePrior"] + force_total) / fluid["Mass"][:, None] * dt

    out.update({
        "Density": rho, "Pressure": p, "Position": pos,
        "Force": force_total, "DensityChangeRate": drho_dt, "Velocity": vel,
    })
    return out


# ---------------------------------------------------------------------------
# Acoustic step, 2nd half — density relaxation (fluid_integration.hpp:159-231)
# ---------------------------------------------------------------------------

def acoustic_step_2nd_half(fluid: State, nl_inner: NeighborList, kernel, dim: int,
                           riemann, dt,
                           wall: State | None = None,
                           nl_wall: NeighborList | None = None,
                           wall_riemann=None, box=None,
                           walls: Sequence[tuple] = (),
                           contacts: Sequence[tuple] = (),
                           shell_walls: Sequence[tuple] = (),
                           levelsets: Sequence = ()) -> State:
    out = dict(fluid)
    # --- initialization ---------------------------------------------------
    pos = fluid["Position"] + fluid["Velocity"] * (0.5 * dt)
    vel = fluid["Velocity"]
    rho = fluid["Density"]
    vol = fluid["VolumetricMeasure"]

    # --- interaction: inner -------------------------------------------------
    pg = pair_geometry(pos, pos, nl_inner, kernel, dim, need_W=False, box=box)
    vel_j, _ = gather(vel, nl_inner.idx)
    vol_j, _ = gather(vol, nl_inner.idx)
    dWV = pg.dW * vol_j
    u_jump = jnp.sum((vel[:, None, :] - vel_j) * pg.e, axis=-1)
    density_change_rate = jnp.sum(u_jump * dWV, axis=1)
    p_dissipation = jnp.sum((riemann.dissipative_p_jump(u_jump) * dWV)[..., None] * pg.e, axis=1)

    drho_dt = fluid["DensityChangeRate"] + density_change_rate * rho
    force = p_dissipation * vol[:, None]  # assignment, not += (hpp:195)

    # --- interaction: wall contacts (hpp:205-231) ----------------------------
    wall_list = list(walls)
    if wall is not None:
        wall_list.append((wall, nl_wall))
    wr = wall_riemann or riemann
    for wstate, wnl in wall_list:
        pgw = pair_geometry(pos, wstate["Position"], wnl, kernel, dim,
                            need_W=False, box=box)
        wall_vol, _ = gather(wstate["VolumetricMeasure"], wnl.idx)
        vel_ave_k, _ = gather(wstate["AverageVelocity"], wnl.idx)
        n_k, _ = gather(wstate["NormalDirection"], wnl.idx)
        dWV_w = pgw.dW * wall_vol
        e_dot_n = jnp.sum(pgw.e * n_k, axis=-1)
        face_to_fluid_n = jnp.sign(e_dot_n)[..., None] * n_k
        vel_in_wall = 2.0 * vel_ave_k - vel[:, None, :]
        dcr_w = jnp.sum(jnp.sum((vel[:, None, :] - vel_in_wall) * pgw.e, axis=-1) * dWV_w, axis=1)
        u_jump_w = 2.0 * jnp.sum((vel[:, None, :] - vel_ave_k) * face_to_fluid_n, axis=-1)
        p_diss_w = jnp.sum((wr.dissipative_p_jump(u_jump_w) * dWV_w)[..., None] * face_to_fluid_n, axis=1)
        drho_dt = drho_dt + dcr_w * rho
        force = force + p_diss_w * vol[:, None]

    for sstate, snl, spairs in shell_walls:
        from sphinxsys_jax.physics.shell_fluid import acoustic_2nd_half_shell_term

        p_diss_s, dcr_s = acoustic_2nd_half_shell_term(
            vel, fluid, sstate, spairs, snl, wr)
        drho_dt = drho_dt + dcr_s * rho
        force = force + p_diss_s * vol[:, None]

    # level-set confinement density relaxation (StaticConfinementIntegration
    # 2ndHalf, shape_confinement.cpp:57-62): the wall mirror velocity is
    # -v_i, so drho/dt += rho * 2 v_i . KGI(pos)
    for ls in levelsets:
        kgi = ls.compute_kernel_gradient_integral(pos)
        drho_dt = drho_dt + 2.0 * rho * jnp.sum(vel * kgi, axis=-1)

    # --- interaction: fluid-fluid contacts (hpp:248-272) ---------------------
    for cstate, cnl, crs in contacts:
        pgc = pair_geometry(pos, cstate["Position"], cnl, kernel, dim,
                            need_W=False, box=box)
        vol_k, _ = gather(cstate["VolumetricMeasure"], cnl.idx)
        vel_k, _ = gather(cstate["Velocity"], cnl.idx)
        dWV_c = pgc.dW * vol_k
        vel_ave = crs.average_v(vel[:, None, :], vel_k)
        dcr_c = jnp.sum(2.0 * jnp.sum((vel[:, None, :] - vel_ave) * pgc.e,
                                      axis=-1) * dWV_c, axis=1)
        u_jump_c = jnp.sum((vel[:, None, :] - vel_k) * pgc.e, axis=-1)
        p_diss_c = jnp.sum((crs.dissipative_p_jump(u_jump_c)
                            * dWV_c)[..., None] * pgc.e, axis=1)
        drho_dt = drho_dt + dcr_c * rho
        force = force + p_diss_c * vol[:, None]

    # --- update --------------------------------------------------------------
    rho_new = rho + drho_dt * (0.5 * dt)

    out.update({
        "Position": pos, "DensityChangeRate": drho_dt,
        "Force": force, "Density": rho_new,
    })
    return out


# ---------------------------------------------------------------------------
# Time-step criteria (fluid_time_step.cpp)
# ---------------------------------------------------------------------------

def acoustic_time_step(fluid: State, eos, h_min: float, cfl: float = 0.6):
    """dt = CFL * h / max(c + |v|)  (fluid_time_step.cpp:21-32)."""
    c = eos.sound_speed(fluid["Pressure"], fluid["Density"])
    speed = jnp.linalg.norm(fluid["Velocity"], axis=-1)
    n = fluid["Position"].shape[0]
    valid = jnp.arange(n) < fluid["NReal"]
    reduced = jnp.max(jnp.where(valid, c + speed, 0.0))
    return cfl * h_min / (reduced + TINY)


def advection_time_step(fluid: State, h_min: float, speed_ref: float,
                        cfl: float = 0.25):
    """dt = CFL * h / max(speed_max, U_ref), with the acceleration scale
    folded into speed_max (fluid_time_step.cpp:44-66)."""
    n = fluid["Position"].shape[0]
    valid = jnp.arange(n) < fluid["NReal"]
    accel_scale = 4.0 * h_min * jnp.linalg.norm(
        fluid["Force"] + fluid["ForcePrior"], axis=-1) / fluid["Mass"]
    v2 = jnp.sum(fluid["Velocity"] ** 2, axis=-1)
    reduced = jnp.max(jnp.where(valid, jnp.maximum(v2, accel_scale), 0.0))
    speed_max = jnp.sqrt(reduced)
    return cfl * h_min / (jnp.maximum(speed_max, speed_ref) + TINY)


def advection_viscous_time_step(fluid: State, h_min: float, speed_ref: float,
                                rho0: float, mu: float, cfl: float = 0.25):
    """AdvectionViscousTimeStep: fold the viscous diffusion speed into U_ref."""
    viscous_speed = mu / rho0 / h_min
    return advection_time_step(fluid, h_min, max(viscous_speed, speed_ref), cfl)


# ---------------------------------------------------------------------------
# Viscous force (viscous_dynamics.hpp, Newtonian inner + wall)
# ---------------------------------------------------------------------------

def viscous_force(fluid: State, nl_inner: NeighborList, kernel, dim: int,
                  mu: float, smoothing_length: float,
                  wall: State | None = None, nl_wall: NeighborList | None = None,
                  box=None, walls: Sequence[tuple] = (),
                  contacts: Sequence[tuple] = (),
                  shell_walls: Sequence[tuple] = ()) -> State:
    """F_i += 2 mu V_i sum_j (v_i - v_j) / (r_ij + 0.01 h) dW_ij V_j
    (legacy ViscousForce<Inner<>>, viscous_dynamics.hpp; wall variant
    doubles the jump against the averaged wall velocity).  Accumulated
    into ForcePrior via force_prior update.

    `contacts` (other-phase fluid bodies) are ViscousForce<Contact<>>
    (viscous_dynamics.hpp:151-190): same form as inner but against the
    contact body's ACTUAL velocity with the PAIR-HARMONIC viscosity
    2 mu_1 mu_2/(mu_1 + mu_2) (FixedViscosity -> PairGeomAverageFixed,
    particle_functors.h:164-177); entries are (state, nl, mu_pair)."""
    pos, vel, vol = fluid["Position"], fluid["Velocity"], fluid["VolumetricMeasure"]
    eps_r = 0.01 * smoothing_length

    pg = pair_geometry(pos, pos, nl_inner, kernel, dim, need_W=False, box=box)
    vel_j, _ = gather(vel, nl_inner.idx)
    vol_j, _ = gather(vol, nl_inner.idx)
    vderiv = (vel[:, None, :] - vel_j) / (pg.r + eps_r)[..., None]
    force = 2.0 * mu * jnp.sum(vderiv * (pg.dW * vol_j)[..., None], axis=1)

    wall_list = list(walls)
    if wall is not None:
        wall_list.append((wall, nl_wall))
    for wstate, wnl in wall_list:
        pgw = pair_geometry(pos, wstate["Position"], wnl, kernel, dim,
                            need_W=False, box=box)
        wall_vol, _ = gather(wstate["VolumetricMeasure"], wnl.idx)
        vel_ave_k, _ = gather(wstate["AverageVelocity"], wnl.idx)
        vderiv_w = 2.0 * (vel[:, None, :] - vel_ave_k) / (pgw.r + eps_r)[..., None]
        force = force + 2.0 * mu * jnp.sum(vderiv_w * (pgw.dW * wall_vol)[..., None], axis=1)

    for cstate, cnl, mu_pair in contacts:
        pgc = pair_geometry(pos, cstate["Position"], cnl, kernel, dim,
                            need_W=False, box=box)
        c_vol, _ = gather(cstate["VolumetricMeasure"], cnl.idx)
        c_vel, _ = gather(cstate["Velocity"], cnl.idx)
        vderiv_c = (vel[:, None, :] - c_vel) / (pgc.r + eps_r)[..., None]
        force = force + 2.0 * mu_pair * jnp.sum(
            vderiv_c * (pgc.dW * c_vol)[..., None], axis=1)

    # shell bodies seen as wall contacts through curvature-corrected pairs
    # (ViscousForce<Contact<Wall>> over a ContactRelationFromShellToFluid);
    # entries are (shell_state, nl, ShellContactPairs)
    for sstate, snl, spairs in shell_walls:
        area_k, _ = gather(sstate["VolumetricMeasure"], snl.idx)
        vel_ave_k, _ = gather(sstate["AverageVelocity"], snl.idx)
        vderiv_s = 2.0 * (vel[:, None, :] - vel_ave_k) / (
            spairs.r + eps_r)[..., None]
        force = force + 2.0 * mu * jnp.sum(
            vderiv_s * (spairs.dWV * area_k
                        * spairs.mask.astype(force.dtype))[..., None], axis=1)

    out = dict(fluid)
    out["ViscousForce"] = force * vol[:, None]
    out["ForcePrior"] = fluid["ForcePrior"] + out["ViscousForce"] - fluid.get(
        "ViscousForcePrev", jnp.zeros_like(force))
    out["ViscousForcePrev"] = out["ViscousForce"]
    return out


# ---------------------------------------------------------------------------
# Transport-velocity correction (transport_velocity_correction.h)
# ---------------------------------------------------------------------------

def transport_velocity_correction(fluid: State, nl_inner: NeighborList, kernel,
                                  dim: int, h_ref: float, coefficient: float = 0.2,
                                  limiter_slope: float | None = None,
                                  wall: State | None = None,
                                  nl_wall: NeighborList | None = None,
                                  box=None, walls: Sequence[tuple] = (),
                                  shell_walls: Sequence[tuple] = (),
                                  scope_mask=None,
                                  surface_projection: bool = False) -> State:
    """Shift positions down the kernel-gradient-integral "inconsistency" to
    keep particle distributions uniform (transport_velocity_correction.hpp:
    37-67):
        I_i  = -sum_j 2 dW_ij V_j e_ij      (+ wall contact term)
        x_i += coef h^2 * limiter(h^2 |I|^2) * I_i
    limiter = TruncatedLinear(slope) (min(slope*x, 1), default slope 100) or
    1 when limiter_slope is None (NoLimiter)."""
    pos, vol = fluid["Position"], fluid["VolumetricMeasure"]
    pg = pair_geometry(pos, pos, nl_inner, kernel, dim, need_W=False, box=box)
    vol_j, _ = gather(vol, nl_inner.idx)
    inconsistency = -jnp.sum((2.0 * pg.dW * vol_j)[..., None] * pg.e, axis=1)
    wall_list = list(walls)
    if wall is not None:
        wall_list.append((wall, nl_wall))
    for wstate, wnl in wall_list:
        pgw = pair_geometry(pos, wstate["Position"], wnl, kernel, dim,
                            need_W=False, box=box)
        wall_vol, _ = gather(wstate["VolumetricMeasure"], wnl.idx)
        inconsistency = inconsistency - jnp.sum(
            (2.0 * pgw.dW * wall_vol)[..., None] * pgw.e, axis=1)
    # shell-wall contacts through curvature-corrected pairs
    for sstate, snl, spairs in shell_walls:
        area_k, _ = gather(sstate["VolumetricMeasure"], snl.idx)
        inconsistency = inconsistency - jnp.sum(
            (2.0 * spairs.dWV * area_k
             * spairs.mask.astype(pos.dtype))[..., None] * spairs.e, axis=1)
    h2 = h_ref * h_ref
    sq = jnp.sum(inconsistency**2, axis=-1)
    lim = jnp.minimum(limiter_slope * h2 * sq, 1.0) if limiter_slope is not None else 1.0
    out = dict(fluid)
    shift = coefficient * h2 * (lim[..., None] if limiter_slope is not None else 1.0) * inconsistency
    if scope_mask is not None:  # e.g. BulkParticles: Indicator == 0
        shift = jnp.where(scope_mask[:, None], shift, 0.0)
    if surface_projection:
        # the cohesive-soil unified TVC (cohesive_soil_failure.h:128-143):
        # surface-indicated particles only shift TANGENTIALLY to the free
        # surface, and not at all where the support is strongly deficient
        # (pos_div < 0.6*dim) — otherwise the correction pumps the surface
        # outward along its own deficiency direction.  The projection
        # direction is the normalized kernel-gradient integral, which at a
        # free surface IS the (inward) surface normal (the reference reads
        # the separately stored FreeSurfaceNormal; same vector there).
        nrm = inconsistency / (jnp.linalg.norm(inconsistency, axis=-1,
                                               keepdims=True) + TINY)
        tangential = shift - jnp.sum(shift * nrm, axis=-1, keepdims=True) * nrm
        at_surface = fluid["Indicator"] == 1
        shift = jnp.where(at_surface[:, None], tangential, shift)
        deficient = fluid["PositionDivergence"] < 0.6 * dim
        shift = jnp.where((at_surface & deficient)[:, None], 0.0, shift)
    out["Position"] = pos + shift
    return out


# ---------------------------------------------------------------------------
# Free-surface indication + free-stream boundary (surface_indication.cpp,
# fluid_boundary.h:123-166, density_summation.h:141-183)
# ---------------------------------------------------------------------------

def free_surface_indication(fluid: State, nl_inner: NeighborList, kernel,
                            dim: int, contacts: Sequence[tuple] = (),
                            spatial_temporal: bool = False,
                            box=None,
                            shell_walls: Sequence[tuple] = ()) -> State:
    """FreeSurfaceIndication(SpatialTemporal): Indicator = 1 where the
    position divergence  -sum dW V r  falls below 0.75*dim, smeared one
    layer inward (a bulk particle within h of a surface one is also
    tagged).  The SpatialTemporal variant suppresses NEW surface particles
    that were bulk last step and have no previous-surface neighbor
    (surface_indication.cpp:57-90)."""
    pos = fluid["Position"]
    threshold = 0.75 * dim
    h = kernel.h
    pg = pair_geometry(pos, pos, nl_inner, kernel, dim, need_W=False, box=box)
    vol_j, _ = gather(fluid["VolumetricMeasure"], nl_inner.idx)
    pos_div = -jnp.sum(pg.dW * vol_j * pg.r, axis=1)
    for c_state, nl_c, _rho0 in contacts:
        pgc = pair_geometry(pos, c_state["Position"], nl_c, kernel, dim,
                            need_W=False, box=box)
        vol_k, _ = gather(c_state["VolumetricMeasure"], nl_c.idx)
        pos_div = pos_div - jnp.sum(pgc.dW * vol_k * pgc.r, axis=1)
    for sstate, snl, spairs in shell_walls:
        area_k, _ = gather(sstate["VolumetricMeasure"], snl.idx)
        pos_div = pos_div - jnp.sum(spairs.dWV * area_k
                                    * spairs.mask.astype(pos_div.dtype)
                                    * spairs.r, axis=1)

    out = dict(fluid)
    if spatial_temporal and "PreviousSurfaceIndicator" in fluid:
        prev = fluid["PreviousSurfaceIndicator"]
        prev_j, mj = gather(prev, nl_inner.idx)
        near_prev_surface = jnp.any((prev_j == 1) & mj, axis=1)
        # a would-be surface particle that was bulk and is not adjacent to
        # the previous surface keeps its bulk status this step
        suppress = (pos_div < threshold) & (prev != 1) & ~near_prev_surface
        pos_div = jnp.where(suppress, 2.0 * threshold, pos_div)

    is_surface = pos_div < threshold
    surf_j, mj = gather(is_surface, nl_inner.idx)
    near_surface = jnp.any(surf_j & mj & (pg.r < h), axis=1)
    indicator = jnp.where(is_surface | near_surface, 1, 0).astype(jnp.int32)
    out["Indicator"] = indicator
    out["PositionDivergence"] = pos_div
    out["PreviousSurfaceIndicator"] = indicator
    return out


def density_summation_freestream(fluid: State, nl_inner: NeighborList, kernel,
                                 dim: int, rho0: float, sigma0: float,
                                 contacts: Sequence[tuple] = (),
                                 box=None,
                                 shell_contacts: Sequence[tuple] = ()) -> State:
    """DensitySummationFreeStreamComplex: plain summation for bulk
    particles; particles with a surface-indicated neighbor get the
    NearFreeStream blend  rho_sum + (rho - rho_sum) rho0 / rho  when
    rho_sum < rho (density_summation.h:141-147)."""
    out = density_summation(fluid, nl_inner, kernel, dim, rho0, sigma0,
                            contacts=contacts, free_surface=False, box=box,
                            shell_contacts=shell_contacts)
    rho_sum = out["DensitySummation"]
    rho_old = fluid["Density"]
    ind_j, mj = gather(fluid["Indicator"], nl_inner.idx)
    near_surface = jnp.any((ind_j == 1) & mj, axis=1)
    blended = jnp.where(rho_sum < rho_old,
                        rho_sum + (rho_old - rho_sum) * rho0 / rho_old,
                        rho_sum)
    rho = jnp.where(near_surface, blended, rho_sum)
    out["Density"] = rho
    out["VolumetricMeasure"] = fluid["Mass"] / jnp.maximum(rho, TINY)
    return out


def free_stream_velocity_correction(fluid: State, u_target, t,
                                    rho0: float) -> State:
    """FreeStreamVelocityCorrection (fluid_boundary.h:129-166): surface-
    indicated particles blend their streamwise velocity toward the
    free-stream target, weighted by min(rho_sum, rho0)/rho0."""
    out = dict(fluid)
    vel = fluid["Velocity"]
    u_free = u_target(fluid["Position"], vel, t)
    w = jnp.minimum(fluid["DensitySummation"], rho0) / rho0
    vx = u_free + (vel[:, 0] - u_free) * w
    vx = jnp.where(fluid["Indicator"] == 1, vx, vel[:, 0])
    out["Velocity"] = jnp.concatenate([vx[:, None], vel[:, 1:]], axis=-1)
    return out
