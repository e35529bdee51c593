"""Eulerian (mesh-free finite-volume) weakly-compressible SPH.

Counterpart of /root/reference/src/shared/particle_dynamics/fluid_dynamics/
eulerian_fluid_dynamics/eulerian_fluid_integration.{h,hpp}: particles are
STATIC control volumes; fluxes between particle pairs use the acoustic
Riemann interface state (riemann_solver.h:102-116):

  1st half:  dmom/dt_i = -2 V_i sum_j (rho* v* v*^T + p* I) e_ij dW_ij V_j
             mom += (dmom/dt + F_prior) dt ;  v = mom/mass
  2nd half:  dmass/dt_i = -2 V_i sum_j (rho* v*).e_ij dW_ij V_j
             mass += dmass/dt dt ;  rho = mass/V ;  p = EoS(rho)

Wall contact mirrors the state with vel_in_wall = 2 v_ave - v_i and the
interface evaluated along the wall normal.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from sphinxsys_jax.core.state import State
from sphinxsys_jax.neighbors.neighbor_list import NeighborList, gather
from sphinxsys_jax.physics.pair import pair_geometry

TINY = 1.0e-15


def interface_state(riemann, rho_i, vel_i, p_i, rho_j, vel_j, p_j, e_ij):
    """AcousticRiemannSolver::InterfaceState (riemann_solver.h:102-116),
    vectorized over (..., K) pair slots; e_ij points j -> i."""
    rc_i, rc_j = riemann.rho0c0_i, riemann.rho0c0_j
    inv_sum = riemann.inv_rho0c0_sum
    rho_star = (rho_i * rc_i + rho_j * rc_j) * inv_sum
    p_avg = (p_i * rc_j + p_j * rc_i) * inv_sum
    v_avg = (vel_i * rc_i + vel_j * rc_j) * inv_sum
    ul = -jnp.sum(e_ij * vel_i, axis=-1)
    ur = -jnp.sum(e_ij * vel_j, axis=-1)
    u_jump = ul - ur
    if hasattr(riemann, "_limiter"):
        lim = riemann._limiter(riemann.inv_c0_ave * jnp.maximum(u_jump, 0.0))
    else:
        lim = jnp.zeros_like(u_jump)
    p_star = p_avg + 0.5 * riemann.rho0c0_geo_ave * u_jump * lim
    u_diss = 0.5 * (p_i - p_j) * riemann.inv_rho0c0_ave * lim * lim
    v_star = v_avg - e_ij * u_diss[..., None]
    return rho_star, v_star, p_star


def make_eulerian_state(pos, volume, material, dtype=jnp.float32) -> State:
    from sphinxsys_jax.core.state import make_base_state

    state = dict(make_base_state(pos, volume, material.rho0, dtype=dtype))
    n, dim = state["Position"].shape
    state["Velocity"] = jnp.zeros((n, dim), dtype=dtype)
    state["Momentum"] = jnp.zeros((n, dim), dtype=dtype)
    state["Pressure"] = jnp.zeros((n,), dtype=dtype)
    state["ForcePrior"] = jnp.zeros((n, dim), dtype=dtype)
    return state


def _pair_states(state, nl, kernel, dim, box):
    pg = pair_geometry(state["Position"], state["Position"], nl, kernel, dim,
                       need_W=False, box=box)
    rho_j, _ = gather(state["Density"], nl.idx)
    vel_j, _ = gather(state["Velocity"], nl.idx)
    p_j, _ = gather(state["Pressure"], nl.idx)
    vol_j, _ = gather(state["VolumetricMeasure"], nl.idx)
    return pg, rho_j, vel_j, p_j, vol_j


def eulerian_integration_1st_half(state: State, nl: NeighborList, kernel,
                                  dim: int, riemann, dt,
                                  wall: State | None = None,
                                  nl_wall: NeighborList | None = None,
                                  box=None) -> State:
    out = dict(state)
    pg, rho_j, vel_j, p_j, vol_j = _pair_states(state, nl, kernel, dim, box)
    rho_i = state["Density"][:, None]
    p_i = state["Pressure"][:, None]
    vel_i = state["Velocity"][:, None, :]
    vol_i = state["VolumetricMeasure"]

    rho_s, v_s, p_s = interface_state(riemann, rho_i, vel_i, p_i,
                                      rho_j, vel_j, p_j, pg.e)
    dWV = pg.dW * vol_j
    # (rho* v* v*^T + p* I) e = rho* v* (v*.e) + p* e
    flux = (rho_s * jnp.sum(v_s * pg.e, axis=-1))[..., None] * v_s + \
        p_s[..., None] * pg.e
    dmom_dt = -2.0 * vol_i[:, None] * jnp.sum(flux * dWV[..., None], axis=1)

    if wall is not None:
        pgw = pair_geometry(state["Position"], wall["Position"], nl_wall,
                            kernel, dim, need_W=False, box=box)
        wall_vol, _ = gather(wall["VolumetricMeasure"], nl_wall.idx)
        vel_ave, _ = gather(wall["AverageVelocity"], nl_wall.idx)
        n_k, _ = gather(wall["NormalDirection"], nl_wall.idx)
        vel_in_wall = 2.0 * vel_ave - vel_i
        rho_s, v_s, p_s = interface_state(riemann, rho_i, vel_i, p_i,
                                          rho_i, vel_in_wall, p_i, n_k)
        dWV_w = pgw.dW * wall_vol
        flux = (rho_s * jnp.sum(v_s * pgw.e, axis=-1))[..., None] * v_s + \
            p_s[..., None] * pgw.e
        dmom_dt = dmom_dt - 2.0 * vol_i[:, None] * jnp.sum(
            flux * dWV_w[..., None], axis=1)

    mom = state["Momentum"] + (dmom_dt + state["ForcePrior"]) * dt
    out["Momentum"] = mom
    out["Velocity"] = mom / state["Mass"][:, None]
    return out


def eulerian_integration_2nd_half(state: State, nl: NeighborList, kernel,
                                  dim: int, riemann, eos, dt,
                                  wall: State | None = None,
                                  nl_wall: NeighborList | None = None,
                                  box=None) -> State:
    out = dict(state)
    pg, rho_j, vel_j, p_j, vol_j = _pair_states(state, nl, kernel, dim, box)
    rho_i = state["Density"][:, None]
    p_i = state["Pressure"][:, None]
    vel_i = state["Velocity"][:, None, :]
    vol_i = state["VolumetricMeasure"]

    rho_s, v_s, p_s = interface_state(riemann, rho_i, vel_i, p_i,
                                      rho_j, vel_j, p_j, pg.e)
    dWV = pg.dW * vol_j
    dmass_dt = -2.0 * vol_i * jnp.sum(
        rho_s * jnp.sum(v_s * pg.e, axis=-1) * dWV, axis=1)

    if wall is not None:
        pgw = pair_geometry(state["Position"], wall["Position"], nl_wall,
                            kernel, dim, need_W=False, box=box)
        wall_vol, _ = gather(wall["VolumetricMeasure"], nl_wall.idx)
        vel_ave, _ = gather(wall["AverageVelocity"], nl_wall.idx)
        n_k, _ = gather(wall["NormalDirection"], nl_wall.idx)
        vel_in_wall = 2.0 * vel_ave - vel_i
        rho_s, v_s, p_s = interface_state(riemann, rho_i, vel_i, p_i,
                                          rho_i, vel_in_wall, p_i, n_k)
        dWV_w = pgw.dW * wall_vol
        dmass_dt = dmass_dt - 2.0 * vol_i * jnp.sum(
            rho_s * jnp.sum(v_s * pgw.e, axis=-1) * dWV_w, axis=1)

    mass = state["Mass"] + dmass_dt * dt
    out["Mass"] = mass
    out["Density"] = mass / vol_i
    out["Pressure"] = eos.pressure(out["Density"])
    return out


def eulerian_time_step(state: State, eos, h_min: float, cfl: float = 0.6):
    from sphinxsys_jax.core.state import valid_mask

    c = eos.sound_speed(state["Pressure"], state["Density"])
    speed = jnp.linalg.norm(state["Velocity"], axis=-1)
    reduced = jnp.max(jnp.where(valid_mask(state), c + speed, 0.0))
    return cfl * h_min / (reduced + TINY)


# ---------------------------------------------------------------------------
# Compressible Eulerian SPH with HLLC Riemann fluxes
# (eulerian_compressible_fluid_integration.{h,hpp} +
#  eulerian_riemann_solver.cpp HLLCRiemannSolver)
# ---------------------------------------------------------------------------

def hllc_interface_state(gas, rho_i, vel_i, p_i, E_i, rho_j, vel_j, p_j, E_j,
                         e_ij, limiter: float | None = None):
    """HLLCRiemannSolver::getInterfaceState (eulerian_riemann_solver.cpp:
    26-90), vectorized: classic three-wave HLLC star state for an ideal
    gas.  E is energy per volume; e_ij points j -> i.

    `limiter`: HLLCWithLimiterRiemannSolver (eulerian_riemann_solver.cpp:
    89-170) — the pressure-difference contributions to the contact speed
    and star pressure are scaled by min(limiter * max((ul-ur)/c_lr, 0), 1)
    (squared for s_star), which switches the scheme's pressure-jump
    dissipation off in smooth low-Mach regions; required for the
    effectively incompressible Eulerian cases (taylor_green_LG).
    Deviation: the plain Davis wave-speed estimates are kept instead of
    the reference's Roe-average tilde speeds — the limiter, not the wave
    speed bound, is what controls the low-Mach behavior."""
    ul = -jnp.sum(e_ij * vel_i, axis=-1)
    ur = -jnp.sum(e_ij * vel_j, axis=-1)
    c_l = gas.sound_speed(p_i, rho_i)
    c_r = gas.sound_speed(p_j, rho_j)
    s_l = ul - c_l
    s_r = ur + c_r
    denom = rho_j * (s_r - ur) + rho_i * (ul - s_l)
    if limiter is not None:
        clr = (rho_i * c_l + rho_j * c_r) / (rho_i + rho_j)
        lim = jnp.minimum(limiter * jnp.maximum((ul - ur) / clr, 0.0), 1.0)
        dp_scale = lim * lim
    else:
        lim = None
        dp_scale = 1.0
    s_star_raw = (rho_j * ur * (s_r - ur) + rho_i * ul * (ul - s_l)
                  + (p_i - p_j) * dp_scale) / jnp.where(
                      jnp.abs(denom) < 1e-14, 1.0, denom)
    s_avg = 0.5 * (ul + ur)
    s_star = jnp.where(
        (jnp.abs(denom) < 1e-14) | (s_star_raw < s_l - 1000.0)
        | (s_star_raw > s_r + 1000.0), s_avg, s_star_raw)

    # left/right star states; every denominator is guarded because BOTH
    # branches of the selects are evaluated (NaN * 0 = NaN otherwise)
    def safe(x):
        return jnp.where(jnp.abs(x) < 1e-12, jnp.where(x < 0, -1e-12, 1e-12), x)

    if limiter is not None:
        # limited star pressure (eulerian_riemann_solver.cpp:140-143)
        p_star_mid = 0.5 * (p_i + p_j) + 0.5 * lim * (
            rho_i * (s_l - ul) * (s_star - ul)
            + rho_j * (s_r - ur) * (s_star - ur))
        v_star_l = vel_i - e_ij * (s_star - ul)[..., None]
        rho_star_l = rho_i * (s_l - ul) / safe(s_l - s_star)
        E_star_l = ((s_l - ul) * E_i - p_i * ul
                    + p_star_mid * s_star) / safe(s_l - s_star)
        v_star_r = vel_j - e_ij * (s_star - ur)[..., None]
        rho_star_r = rho_j * (s_r - ur) / safe(s_r - s_star)
        E_star_r = ((s_r - ur) * E_j - p_j * ur
                    + p_star_mid * s_star) / safe(s_r - s_star)
    else:
        p_star_mid = p_i + rho_i * (s_l - ul) * (s_star - ul)
        v_star_l = vel_i - e_ij * (s_star - ul)[..., None]
        rho_star_l = rho_i * (s_l - ul) / safe(s_l - s_star)
        E_star_l = rho_star_l * (E_i / safe(rho_i) + (s_star - ul) *
                                 (s_star + p_i / safe(rho_i * (s_l - ul))))
        v_star_r = vel_j - e_ij * (s_star - ur)[..., None]
        rho_star_r = rho_j * (s_r - ur) / safe(s_r - s_star)
        E_star_r = rho_star_r * (E_j / safe(rho_j) + (s_star - ur) *
                                 (s_star + p_j / safe(rho_j * (s_r - ur))))

    left = (0.0 < s_l)
    midl = (s_l <= 0.0) & (0.0 <= s_star)
    midr = (s_star <= 0.0) & (0.0 <= s_r)
    right = (s_r < 0.0)

    def pick(sl, ml, mr, sr):
        out = jnp.where(left[..., None] if sl.ndim > left.ndim else left, sl,
                        0.0 * sl)
        out = jnp.where(midl[..., None] if ml.ndim > midl.ndim else midl, ml, out)
        out = jnp.where(midr[..., None] if mr.ndim > midr.ndim else midr, mr, out)
        out = jnp.where(right[..., None] if sr.ndim > right.ndim else right, sr, out)
        return out

    p_star = pick(p_i, p_star_mid, p_star_mid, p_j)
    v_star = pick(vel_i, v_star_l, v_star_r, vel_j)
    rho_star = pick(rho_i, rho_star_l, rho_star_r, rho_j)
    E_star = pick(E_i, E_star_l, E_star_r, E_j)
    return rho_star, v_star, p_star, E_star


def make_compressible_eulerian_state(pos, volume, gas, rho0, p0, vel0=None,
                                     dtype=jnp.float32) -> State:
    """Static control volumes carrying mass, momentum and total energy."""
    from sphinxsys_jax.core.state import make_base_state

    state = dict(make_base_state(pos, volume, 1.0, dtype=dtype))
    n, dim = state["Position"].shape
    rho0 = jnp.broadcast_to(jnp.asarray(rho0, dtype), (n,))
    p0 = jnp.broadcast_to(jnp.asarray(p0, dtype), (n,))
    vel = jnp.zeros((n, dim), dtype) if vel0 is None else jnp.asarray(vel0, dtype)
    vol = state["VolumetricMeasure"]
    state["Density"] = rho0
    state["Pressure"] = p0
    state["Velocity"] = vel
    state["Mass"] = rho0 * vol
    state["Momentum"] = state["Mass"][:, None] * vel
    e_int = gas.internal_energy(p0, rho0)          # per unit mass
    # TotalEnergy is EXTENSIVE (per particle); E/Vol enters the Riemann state
    state["TotalEnergy"] = (rho0 * e_int
                            + 0.5 * rho0 * jnp.sum(vel**2, -1)) * vol
    state["ForcePrior"] = jnp.zeros((n, dim), dtype)
    return state


def compressible_integration_1st_half(state: State, nl: NeighborList, kernel,
                                      dim: int, gas, dt, box=None,
                                      limiter: float | None = None) -> State:
    """EulerianCompressibleIntegration1stHalf with the HLLC flux:
    dmom/dt_i = F_prior - 2 V_i sum_j (rho* v* v*^T + p* I) e dW V_j."""
    out = dict(state)
    pg, rho_j, vel_j, p_j, vol_j = _pair_states(state, nl, kernel, dim, box)
    E_vol = state["TotalEnergy"] / state["VolumetricMeasure"]
    E_j, _ = gather(E_vol, nl.idx)
    rho_i = state["Density"][:, None]
    p_i = state["Pressure"][:, None]
    vel_i = state["Velocity"][:, None, :]
    vol_i = state["VolumetricMeasure"]

    rho_s, v_s, p_s, E_s = hllc_interface_state(
        gas, rho_i, vel_i, p_i, E_vol[:, None], rho_j, vel_j, p_j, E_j, pg.e,
        limiter=limiter)
    dWV = (pg.dW * vol_j * pg.mask)
    flux = (rho_s * jnp.sum(v_s * pg.e, axis=-1))[..., None] * v_s + \
        p_s[..., None] * pg.e
    dmom_dt = state["ForcePrior"] - 2.0 * vol_i[:, None] * jnp.sum(
        flux * dWV[..., None], axis=1)

    mom = state["Momentum"] + dmom_dt * dt
    out["Momentum"] = mom
    out["Velocity"] = mom / state["Mass"][:, None]
    return out


def compressible_integration_2nd_half(state: State, nl: NeighborList, kernel,
                                      dim: int, gas, dt, box=None,
                                      limiter: float | None = None) -> State:
    """EulerianCompressibleIntegration2ndHalf: mass + energy fluxes, then
    rho = mass/V and p = (gamma-1)(E/V - rho |v|^2 / 2)."""
    out = dict(state)
    pg, rho_j, vel_j, p_j, vol_j = _pair_states(state, nl, kernel, dim, box)
    vol_i = state["VolumetricMeasure"]
    E_vol = state["TotalEnergy"] / vol_i
    E_j, _ = gather(E_vol, nl.idx)
    rho_i = state["Density"][:, None]
    p_i = state["Pressure"][:, None]
    vel_i = state["Velocity"][:, None, :]

    rho_s, v_s, p_s, E_s = hllc_interface_state(
        gas, rho_i, vel_i, p_i, E_vol[:, None], rho_j, vel_j, p_j, E_j, pg.e,
        limiter=limiter)
    dWV = (pg.dW * vol_j * pg.mask)
    u_n = jnp.sum(v_s * pg.e, axis=-1)
    dmass_dt = -2.0 * vol_i * jnp.sum(rho_s * u_n * dWV, axis=1)
    dE_dt = jnp.sum(state["ForcePrior"] * state["Velocity"], axis=-1) \
        - 2.0 * vol_i * jnp.sum((E_s + p_s) * u_n * dWV, axis=1)

    mass = state["Mass"] + dmass_dt * dt
    E = state["TotalEnergy"] + dE_dt * dt
    rho = mass / vol_i
    vel = state["Momentum"] / mass[:, None]
    rho_e = E / vol_i - 0.5 * jnp.sum(vel**2, axis=-1) * rho
    out.update({"Mass": mass, "TotalEnergy": E, "Density": rho,
                "Pressure": gas.pressure(rho, rho_e / jnp.maximum(rho, TINY))})
    return out


def compressible_time_step(state: State, gas, h_min: float, cfl: float = 0.6,
                           dim: int = 2):
    """EulerianCompressibleAcousticTimeStepSize: CFL / Dimensions * h /
    max(c + |v|) (eulerian_compressible_fluid_integration.cpp:332-340)."""
    c = gas.sound_speed(state["Pressure"], state["Density"])
    speed = jnp.linalg.norm(state["Velocity"], axis=-1)
    n = state["Position"].shape[0]
    valid = jnp.arange(n) < state["NReal"]
    return (cfl / dim) * h_min / (jnp.max(jnp.where(valid, c + speed, 0.0)) + TINY)
