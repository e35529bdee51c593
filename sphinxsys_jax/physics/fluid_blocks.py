"""WCSPH fluid ops in cell-block layout — the fluid hot path.

Same physics as physics/fluid.py (fluid_integration.hpp — see that module
for the scheme and reference citations), reformulated on the cell-block
engine (neighbors/cell_blocks.py): state arrays live in occupied-cell
blocks (C+1, cap, ...) and every pair sweep is a loop over the 3^dim
window offsets of dense (C, cap_i, cap_j) broadcast ops — no per-pair
gathers.

Layout notes:
  * all per-window source data is packed into ONE (C+1, cap, ch) tensor so
    each window costs a single row gather instead of one per field;
  * padding slots are masked explicitly (their positions are parked FAR,
    but a periodic minimum-image wrap would fold FAR back into range).

A "block state" is a dict with the usual variable names holding block
arrays, plus the key "SlotMask" ((C+1, cap) bool).
"""

from __future__ import annotations

import itertools
from typing import Sequence

import jax.numpy as jnp

from sphinxsys_jax.neighbors.cell_list import CellGrid
from sphinxsys_jax.neighbors.cell_blocks import BlockMap

TINY = 1.0e-15


def _window_offsets(dim: int):
    return list(itertools.product(*([(-1, 0, 1)] * dim)))


def _center_index(dim: int) -> int:
    return _window_offsets(dim).index((0,) * dim)


def _min_image(disp, box):
    if box is None or not any(b > 0 for b in box):
        return disp
    L = jnp.asarray(box, dtype=disp.dtype)
    safe_L = jnp.where(L > 0, L, 1.0)
    return jnp.where(L > 0, disp - L * jnp.round(disp / safe_L), disp)


def pack_channels(*arrays):
    """Pack (C+1, cap) / (C+1, cap, d) arrays into one (C+1, cap, ch)."""
    cols = [a if a.ndim == 3 else a[..., None] for a in arrays]
    return jnp.concatenate(cols, axis=-1)


def _pair_geom(pos_i, mask_i, pos_j, mask_j, w, kernel, dim, box, exclude_self):
    """(C, capi, capj) pair geometry given gathered j positions."""
    c = pos_j.shape[0]
    disp = pos_i[:c, :, None, :] - pos_j[:, None, :, :]
    disp = _min_image(disp, box)
    r2 = jnp.sum(disp * disp, axis=-1)
    r = jnp.sqrt(r2 + TINY)
    e = disp / (r[..., None] + TINY)
    mask = mask_i[:c, :, None] & mask_j[:, None, :]
    if exclude_self and w == _center_index(dim):
        capi = pos_i.shape[1]
        eye = jnp.eye(capi, dtype=bool)
        mask = mask & ~eye[None, :, :]
    return r, e, mask


# ---------------------------------------------------------------------------
# reduces over block arrays
# ---------------------------------------------------------------------------

def _masked(x, mask, fill):
    return jnp.where(mask, x, fill)


def acoustic_time_step_b(fb, eos, h_min: float, cfl: float = 0.6):
    c = eos.sound_speed(fb["Pressure"], fb["Density"])
    speed = jnp.linalg.norm(fb["Velocity"], axis=-1)
    reduced = jnp.max(_masked(c + speed, fb["SlotMask"], 0.0))
    return cfl * h_min / (reduced + TINY)


def advection_time_step_b(fb, h_min: float, speed_ref: float, cfl: float = 0.25):
    accel_scale = 4.0 * h_min * jnp.linalg.norm(
        fb["Force"] + fb["ForcePrior"], axis=-1) / jnp.maximum(fb["Mass"], TINY)
    v2 = jnp.sum(fb["Velocity"] ** 2, axis=-1)
    reduced = jnp.max(_masked(jnp.maximum(v2, accel_scale), fb["SlotMask"], 0.0))
    return cfl * h_min / (jnp.maximum(jnp.sqrt(reduced), speed_ref) + TINY)


# ---------------------------------------------------------------------------
# density summation (block form)
# ---------------------------------------------------------------------------

def density_summation_b(fb, nbr_inner, kernel, dim: int, rho0: float,
                        sigma0: float, contacts: Sequence[tuple] = (),
                        free_surface: bool = True, box=None):
    """contacts: sequence of (contact_block_state, nbr_block_contact,
    contact_rho0)."""
    pos, mask = fb["Position"], fb["SlotMask"]
    c = nbr_inner.shape[0]
    n_w = len(_window_offsets(dim))
    sigma = jnp.full(pos.shape[:2], kernel.w0(dim), dtype=pos.dtype)[:c]
    fmaskd = mask.astype(pos.dtype)
    for w in range(n_w):
        j = nbr_inner[:, w]
        r, e, m = _pair_geom(pos, mask, pos[j], mask[j], w, kernel, dim, box, True)
        W = kernel.W(r, dim) * m.astype(r.dtype)
        sigma = sigma + jnp.sum(W, axis=2)
    rho_sum = sigma * rho0 / sigma0

    for cb, nbr_c, c_rho0 in contacts:
        packed = pack_channels(cb["Position"], cb["Mass"])
        contact_sum = jnp.zeros_like(rho_sum)
        for w in range(n_w):
            j = nbr_c[:, w]
            pj = packed[j]
            r, e, m = _pair_geom(pos, mask, pj[..., :dim], cb["SlotMask"][j],
                                 w, kernel, dim, box, False)
            W = kernel.W(r, dim) * m.astype(r.dtype)
            contact_sum = contact_sum + jnp.sum(
                W * pj[..., dim][:, None, :] / c_rho0, axis=2)
        rho_sum = rho_sum + contact_sum * rho0 * rho0 / sigma0 / jnp.maximum(
            fb["Mass"][:c], TINY)

    out = dict(fb)
    pad = fb["Density"][c:]
    if free_surface:
        out["Density"] = jnp.concatenate([jnp.maximum(rho_sum, rho0), pad], axis=0)
    else:
        out["Density"] = jnp.concatenate([rho_sum, pad], axis=0)
        out["VolumetricMeasure"] = jnp.where(
            fb["SlotMask"], fb["Mass"] / jnp.maximum(out["Density"], TINY),
            fb["VolumetricMeasure"])
    out["DensitySummation"] = jnp.concatenate([rho_sum, pad], axis=0)
    return out


# ---------------------------------------------------------------------------
# acoustic steps (block form, channel-packed window gathers)
# ---------------------------------------------------------------------------

def acoustic_step_1st_half_b(fb, nbr_inner, kernel, dim: int, eos, riemann, dt,
                             wall_b=None, nbr_wall=None, wall_riemann=None,
                             box=None):
    out = dict(fb)
    mask = fb["SlotMask"]
    rho = jnp.where(mask, fb["Density"] + fb["DensityChangeRate"] * (0.5 * dt),
                    fb["Density"])
    p = eos.pressure(rho)
    pos = fb["Position"] + jnp.where(mask[..., None], fb["Velocity"] * (0.5 * dt), 0.0)
    vol = fb["VolumetricMeasure"]
    c = nbr_inner.shape[0]
    n_w = len(_window_offsets(dim))

    packed = pack_channels(pos, p, vol)  # (C+1, cap, dim+2)
    force = jnp.zeros_like(fb["Velocity"][:c])
    rho_diss = jnp.zeros(p.shape[:2], dtype=p.dtype)[:c]
    for w in range(n_w):
        j = nbr_inner[:, w]
        pj = packed[j]
        r, e, m = _pair_geom(pos, mask, pj[..., :dim], mask[j], w, kernel,
                             dim, box, True)
        fm = m.astype(r.dtype)
        dW = kernel.dW(r, dim) * fm
        p_j = pj[..., dim][:, None, :]
        vol_j = pj[..., dim + 1][:, None, :]
        dWV = dW * vol_j
        force = force - jnp.sum(
            (p[:c, :, None] + p_j)[..., None] * dWV[..., None] * e, axis=2)
        rho_diss = rho_diss + jnp.sum(
            riemann.dissipative_u_jump(p[:c, :, None] - p_j) * dWV, axis=2)

    if wall_b is not None:
        wr = wall_riemann or riemann
        acc_prior = fb["ForcePrior"] / jnp.maximum(fb["Mass"], TINY)[..., None]
        wpacked = pack_channels(wall_b["Position"], wall_b["VolumetricMeasure"],
                                wall_b["AverageAcceleration"])
        for w in range(n_w):
            j = nbr_wall[:, w]
            pj = wpacked[j]
            r, e, m = _pair_geom(pos, mask, pj[..., :dim], wall_b["SlotMask"][j],
                                 w, kernel, dim, box, False)
            fm = m.astype(r.dtype)
            dW = kernel.dW(r, dim) * fm
            wall_vol = pj[..., dim][:, None, :]
            wall_acc = pj[..., dim + 1:2 * dim + 1][:, None, :, :]
            dWV = dW * wall_vol
            face_acc = jnp.sum(
                (acc_prior[:c, :, None, :] - wall_acc) * (-e), axis=-1)
            p_in_wall = p[:c, :, None] + rho[:c, :, None] * r * jnp.maximum(face_acc, 0.0)
            force = force - jnp.sum(
                (p[:c, :, None] + p_in_wall)[..., None] * dWV[..., None] * e, axis=2)
            rho_diss = rho_diss + jnp.sum(
                wr.dissipative_u_jump(p[:c, :, None] - p_in_wall) * dWV, axis=2)

    pad_v = fb["Force"][c:]
    force_total = fb["Force"] + jnp.concatenate(
        [force * vol[:c][..., None], jnp.zeros_like(pad_v)], axis=0)
    drho_dt = jnp.concatenate(
        [rho_diss * rho[:c], fb["DensityChangeRate"][c:]], axis=0)
    vel = fb["Velocity"] + jnp.where(
        mask[..., None],
        (fb["ForcePrior"] + force_total) / jnp.maximum(fb["Mass"], TINY)[..., None] * dt,
        0.0)
    out.update({"Density": rho, "Pressure": p, "Position": pos,
                "Force": force_total, "DensityChangeRate": drho_dt, "Velocity": vel})
    return out


def acoustic_step_2nd_half_b(fb, nbr_inner, kernel, dim: int, riemann, dt,
                             wall_b=None, nbr_wall=None, wall_riemann=None,
                             box=None):
    out = dict(fb)
    mask = fb["SlotMask"]
    pos = fb["Position"] + jnp.where(mask[..., None], fb["Velocity"] * (0.5 * dt), 0.0)
    vel = fb["Velocity"]
    rho = fb["Density"]
    vol = fb["VolumetricMeasure"]
    c = nbr_inner.shape[0]
    n_w = len(_window_offsets(dim))

    packed = pack_channels(pos, vel, vol)  # (C+1, cap, 2 dim + 1)
    dcr = jnp.zeros(rho.shape[:2], dtype=rho.dtype)[:c]
    p_diss = jnp.zeros_like(vel[:c])
    for w in range(n_w):
        j = nbr_inner[:, w]
        pj = packed[j]
        r, e, m = _pair_geom(pos, mask, pj[..., :dim], mask[j], w, kernel,
                             dim, box, True)
        fm = m.astype(r.dtype)
        dW = kernel.dW(r, dim) * fm
        vel_j = pj[..., dim:2 * dim][:, None, :, :]
        vol_j = pj[..., 2 * dim][:, None, :]
        dWV = dW * vol_j
        u_jump = jnp.sum((vel[:c, :, None, :] - vel_j) * e, axis=-1)
        dcr = dcr + jnp.sum(u_jump * dWV, axis=2)
        p_diss = p_diss + jnp.sum(
            (riemann.dissipative_p_jump(u_jump) * dWV)[..., None] * e, axis=2)

    force = p_diss * vol[:c][..., None]

    if wall_b is not None:
        wr = wall_riemann or riemann
        wpacked = pack_channels(wall_b["Position"], wall_b["VolumetricMeasure"],
                                wall_b["AverageVelocity"], wall_b["NormalDirection"])
        for w in range(n_w):
            j = nbr_wall[:, w]
            pj = wpacked[j]
            r, e, m = _pair_geom(pos, mask, pj[..., :dim], wall_b["SlotMask"][j],
                                 w, kernel, dim, box, False)
            fm = m.astype(r.dtype)
            dW = kernel.dW(r, dim) * fm
            wall_vol = pj[..., dim][:, None, :]
            vel_ave = pj[..., dim + 1:2 * dim + 1][:, None, :, :]
            n_k = pj[..., 2 * dim + 1:3 * dim + 1][:, None, :, :]
            dWV = dW * wall_vol
            e_dot_n = jnp.sum(e * n_k, axis=-1)
            face_n = jnp.sign(e_dot_n)[..., None] * n_k
            vel_in_wall = 2.0 * vel_ave - vel[:c, :, None, :]
            dcr = dcr + jnp.sum(jnp.sum(
                (vel[:c, :, None, :] - vel_in_wall) * e, axis=-1) * dWV, axis=2)
            u_jump_w = 2.0 * jnp.sum(
                (vel[:c, :, None, :] - vel_ave) * face_n, axis=-1)
            force = force + jnp.sum(
                (wr.dissipative_p_jump(u_jump_w) * dWV)[..., None] * face_n,
                axis=2) * vol[:c][..., None]

    drho_dt = fb["DensityChangeRate"] + jnp.concatenate(
        [dcr * rho[:c], jnp.zeros_like(rho[c:])], axis=0)
    force_full = jnp.concatenate([force, jnp.zeros_like(vel[c:])], axis=0)
    rho_new = jnp.where(mask, rho + drho_dt * (0.5 * dt), rho)
    out.update({"Position": pos, "DensityChangeRate": drho_dt,
                "Force": force_full, "Density": rho_new})
    return out


def advection_viscous_time_step_b(fb, h_min: float, speed_ref: float,
                                  rho0: float, mu: float, cfl: float = 0.25):
    """AdvectionViscousTimeStep (block form): fold the viscous diffusion
    speed into U_ref (fluid_time_step.cpp)."""
    viscous_speed = mu / rho0 / h_min
    return advection_time_step_b(fb, h_min, max(viscous_speed, speed_ref), cfl)


# ---------------------------------------------------------------------------
# viscous force + transport-velocity correction (block forms)
# ---------------------------------------------------------------------------

def viscous_force_b(fb, nbr_inner, kernel, dim: int, mu: float,
                    smoothing_length: float, walls: Sequence[tuple] = (),
                    box=None):
    """Block twin of physics/fluid.viscous_force (viscous_dynamics.hpp):
    F_i = 2 mu V_i sum_j (v_i - v_j)/(r + 0.01 h) dW V_j, wall jump doubled
    against the averaged wall velocity; ForcePrior accumulation included.
    `walls`: (wall_block_state, nbr_wall_windows) pairs."""
    pos, vel, mask = fb["Position"], fb["Velocity"], fb["SlotMask"]
    vol = fb["VolumetricMeasure"]
    eps_r = 0.01 * smoothing_length
    c = nbr_inner.shape[0]
    n_w = len(_window_offsets(dim))

    packed = pack_channels(pos, vel, vol)
    force = jnp.zeros_like(vel[:c])
    for w in range(n_w):
        j = nbr_inner[:, w]
        pj = packed[j]
        r, e, m = _pair_geom(pos, mask, pj[..., :dim], mask[j], w, kernel,
                             dim, box, True)
        dWV = kernel.dW(r, dim) * m.astype(r.dtype) * pj[..., 2 * dim][:, None, :]
        vel_j = pj[..., dim:2 * dim][:, None, :, :]
        vderiv = (vel[:c, :, None, :] - vel_j) / (r + eps_r)[..., None]
        force = force + jnp.sum(vderiv * dWV[..., None], axis=2)

    for wall_b, nbr_wall in walls:
        wpacked = pack_channels(wall_b["Position"], wall_b["VolumetricMeasure"],
                                wall_b["AverageVelocity"])
        for w in range(n_w):
            j = nbr_wall[:, w]
            pj = wpacked[j]
            r, e, m = _pair_geom(pos, mask, pj[..., :dim], wall_b["SlotMask"][j],
                                 w, kernel, dim, box, False)
            dWV = kernel.dW(r, dim) * m.astype(r.dtype) * pj[..., dim][:, None, :]
            vel_ave = pj[..., dim + 1:2 * dim + 1][:, None, :, :]
            vderiv = 2.0 * (vel[:c, :, None, :] - vel_ave) / (r + eps_r)[..., None]
            force = force + jnp.sum(vderiv * dWV[..., None], axis=2)

    force = 2.0 * mu * force * vol[:c][..., None]
    pad = jnp.zeros_like(vel[c:])
    force_full = jnp.concatenate([force, pad], axis=0)
    out = dict(fb)
    prev = fb.get("ViscousForcePrev", jnp.zeros_like(force_full))
    out["ForcePrior"] = fb["ForcePrior"] + force_full - prev
    out["ViscousForcePrev"] = force_full
    return out


def transport_velocity_correction_b(fb, nbr_inner, kernel, dim: int,
                                    h_ref: float, coefficient: float = 0.2,
                                    limiter_slope: float | None = None,
                                    walls: Sequence[tuple] = (), box=None):
    """Block twin of physics/fluid.transport_velocity_correction
    (transport_velocity_correction.hpp:37-67):
        I_i  = -sum_j 2 dW V_j e_ij  (+ wall terms)
        x_i += coef h^2 limiter(h^2 |I|^2) I_i."""
    pos, mask = fb["Position"], fb["SlotMask"]
    c = nbr_inner.shape[0]
    n_w = len(_window_offsets(dim))

    packed = pack_channels(pos, fb["VolumetricMeasure"])
    incon = jnp.zeros_like(pos[:c])
    for w in range(n_w):
        j = nbr_inner[:, w]
        pj = packed[j]
        r, e, m = _pair_geom(pos, mask, pj[..., :dim], mask[j], w, kernel,
                             dim, box, True)
        dWV = kernel.dW(r, dim) * m.astype(r.dtype) * pj[..., dim][:, None, :]
        incon = incon - jnp.sum((2.0 * dWV)[..., None] * e, axis=2)

    for wall_b, nbr_wall in walls:
        wpacked = pack_channels(wall_b["Position"], wall_b["VolumetricMeasure"])
        for w in range(n_w):
            j = nbr_wall[:, w]
            pj = wpacked[j]
            r, e, m = _pair_geom(pos, mask, pj[..., :dim], wall_b["SlotMask"][j],
                                 w, kernel, dim, box, False)
            dWV = kernel.dW(r, dim) * m.astype(r.dtype) * pj[..., dim][:, None, :]
            incon = incon - jnp.sum((2.0 * dWV)[..., None] * e, axis=2)

    h2 = h_ref * h_ref
    if limiter_slope is not None:
        sq = jnp.sum(incon ** 2, axis=-1)
        lim = jnp.minimum(limiter_slope * h2 * sq, 1.0)[..., None]
    else:
        lim = 1.0
    shift = coefficient * h2 * lim * incon
    shift_full = jnp.concatenate([shift, jnp.zeros_like(pos[c:])], axis=0)
    out = dict(fb)
    out["Position"] = jnp.where(mask[..., None], pos + shift_full, pos)
    return out
