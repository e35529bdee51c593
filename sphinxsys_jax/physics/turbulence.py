"""Standard k-epsilon RANS turbulence with wall functions.

Counterpart of the reference's RANS stack in
tests/extra_source_and_tests/extra_src/for_2D_build/
k-epsilon_turbulent_model.{h,cpp} (the wall-function machinery, the K and
Epsilon transport equations, the turbulent kinetic-energy force, the
turbulent viscous force and the eddy-viscosity closure) and
extra_src/shared/rans_turbulence_dynamics.h.

Design: the reference's per-particle branchy CPU kernels (near-wall status
switches, running-minimum neighbor scans) become masked dense array sweeps
so everything jits to regular vector code:

  * per-particle `if (is_near_wall_P1)` -> jnp.where lane selects;
  * the nearest-wall-neighbor scan (JudgeIsNearWall::interaction,
    k-epsilon_turbulent_model.cpp:630-707) -> a masked argmin over the
    wall-contact slot axis;
  * the reference's ORDER-DEPENDENT running-minimum filter for the
    averaged interface distance is replaced by the order-free limit it
    converges to (weights over all valid wall neighbors) - documented
    deviation, see judge_is_near_wall.

State fields used (registered by register_turbulence_fields):
  TurbulenceKineticEnergy (k), TurbulentDissipation (eps),
  TurbulentViscosity (mu_t), K_Production, TurbulentVelocityGradient
  (N,d,d), IsNearWallP1/P2 (int32), WallNearestNormal/Tau,
  DistanceToDummyInterface, Y_P, WallYstar, WallYplus, FrictionVelocity.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import jax.numpy as jnp

from sphinxsys_jax.core.state import State
from sphinxsys_jax.neighbors.neighbor_list import NeighborList, gather
from sphinxsys_jax.physics.pair import pair_geometry

TINY = 1.0e-15


@dataclasses.dataclass(frozen=True)
class TurbuClosure:
    """BaseTurbuClosureCoeff (k-epsilon_turbulent_model.cpp:13-20)."""

    karman: float = 0.41
    const_E: float = 9.8
    c_mu: float = 0.09
    intensity: float = 5.0e-2
    sigma_k: float = 1.0
    c_1: float = 1.44
    c_2: float = 1.92
    sigma_e: float = 1.3
    length_ratio_eps_inlet: float = 0.07
    start_time_laminar: float = 0.0
    y_star_laminar: float = 11.225

    @property
    def c_mu_25(self) -> float:
        return self.c_mu ** 0.25

    @property
    def c_mu_75(self) -> float:
        return self.c_mu ** 0.75


def register_turbulence_fields(fluid: State, dim: int, k0: float, eps0: float,
                               mu_t0: float, y_p_constant: float) -> State:
    """Register every turbulence state variable (the registerStateVariableData
    calls spread over the reference ctors), so jitted while-loops see a
    stable pytree."""
    n = fluid["Position"].shape[0]
    dt_ = fluid["Position"].dtype
    out = dict(fluid)
    zeros, zerov = jnp.zeros((n,), dt_), jnp.zeros((n, dim), dt_)
    out.setdefault("TurbulenceKineticEnergy", jnp.full((n,), k0, dt_))
    out.setdefault("TurbulentDissipation", jnp.full((n,), eps0, dt_))
    out.setdefault("TurbulentViscosity", jnp.full((n,), mu_t0, dt_))
    out.setdefault("K_Production", zeros)
    out.setdefault("TurbulentVelocityGradient", jnp.zeros((n, dim, dim), dt_))
    out.setdefault("TurbulentCorrectionMatrix",
                   jnp.tile(jnp.eye(dim, dtype=dt_), (n, 1, 1)))
    out.setdefault("IsNearWallP1", jnp.zeros((n,), jnp.int32))
    out.setdefault("IsNearWallP2", jnp.zeros((n,), jnp.int32))
    out.setdefault("WallNearestNormal", zerov)
    out.setdefault("WallNearestTau", zerov)
    out.setdefault("DistanceToDummyInterface", zeros)
    out.setdefault("Y_P", jnp.full((n,), y_p_constant, dt_))
    out.setdefault("WallYstar", zeros)
    out.setdefault("WallYplus", zeros)
    out.setdefault("FrictionVelocity", zerov)
    out.setdefault("TkeForcePrev", zerov)
    out.setdefault("TurbulentStrainRate", jnp.zeros((n, dim, dim), dt_))
    out.setdefault("TangentialVelocity", zeros)
    out.setdefault("ViscousForce", zerov)
    out.setdefault("ViscousForcePrev", zerov)
    return out


# ---------------------------------------------------------------------------
# Wall-law scalar helpers (WallFunction, k-epsilon_turbulent_model.cpp:22-67)
# ---------------------------------------------------------------------------

def dimensionless_velocity(y_star, time, cl: TurbuClosure):
    """u* by the laminar law below y*=11.225, log law above
    (get_dimensionless_velocity)."""
    log_law = jnp.abs(jnp.log(cl.const_E * jnp.maximum(y_star, TINY)) / cl.karman)
    laminar = (y_star < cl.y_star_laminar) & (time > cl.start_time_laminar)
    return jnp.where(laminar, y_star, log_law)


# ---------------------------------------------------------------------------
# Near-wall status (JudgeIsNearWall)
# ---------------------------------------------------------------------------

def judge_is_near_wall(fluid: State, wall: State, nbr_wall: NeighborList,
                       kernel, dim: int, fluid_spacing: float,
                       wall_spacing: float) -> State:
    """JudgeIsNearWall (k-epsilon_turbulent_model.cpp:598-724).

    For each fluid particle, scan the wall contact neighborhood:
      r_dummy_j = |n_j . disp_ij| - 0.5 wall_spacing  (normal distance from
      the dummy-wall interface); the NEAREST wall particle (min r_ij among
      those with r_dummy_j > 0) supplies the local wall normal/tangent and
      the interface distance.  P2 = 10 when any wall neighbor exists; P1 = 1
      when additionally the interface distance < fluid_spacing.

    Deviation: the reference's averaged interface distance filters
    neighbors against a RUNNING minimum (loop-order dependent); we weight
    all valid wall neighbors - the order-free limit of that filter.
    """
    pos = fluid["Position"]
    pg = pair_geometry(pos, wall["Position"], nbr_wall, kernel, dim)
    n_j, _ = gather(wall["NormalDirection"], nbr_wall.idx)
    vol_j, _ = gather(wall["VolumetricMeasure"], nbr_wall.idx)

    disp = pg.r[..., None] * pg.e  # (N, K, d): pos_i - pos_j
    r_dummy = jnp.abs(jnp.sum(n_j * disp, axis=-1)) - 0.5 * wall_spacing
    valid = pg.mask & (r_dummy > TINY)

    r_for_min = jnp.where(valid, pg.r, jnp.inf)
    j_near = jnp.argmin(r_for_min, axis=1)
    has_near = jnp.isfinite(jnp.min(r_for_min, axis=1))
    rows = jnp.arange(pos.shape[0])
    e_n = jnp.where(has_near[:, None], n_j[rows, j_near], 0.0)
    dist = jnp.where(has_near, r_dummy[rows, j_near], 0.0)

    # 2D tangent: (n_y, -n_x) (cpp:694-698)
    e_tau = jnp.stack([e_n[:, 1], -e_n[:, 0]], axis=-1) if dim == 2 else (
        jnp.cross(e_n, jnp.tile(jnp.asarray([0.0, 0.0, 1.0], pos.dtype),
                                (pos.shape[0], 1))))

    p2 = jnp.where(jnp.any(pg.mask, axis=1), 10, 0).astype(jnp.int32)
    p1 = jnp.where((p2 == 10) & (dist < fluid_spacing), 1, 0).astype(jnp.int32)

    out = dict(fluid)
    out["IsNearWallP1"] = p1
    out["IsNearWallP2"] = p2
    out["WallNearestNormal"] = e_n
    out["WallNearestTau"] = e_tau
    out["DistanceToDummyInterface"] = dist
    return out


# ---------------------------------------------------------------------------
# Turbulent gradient-correction matrix
# ---------------------------------------------------------------------------

def turbulent_correction_matrix(fluid: State, nbr_inner: NeighborList, kernel,
                                dim: int, alpha: float = 0.0) -> State:
    """TurbulentLinearGradientCorrectionMatrix<Inner<>>
    (k-epsilon_turbulent_model.cpp:879-905): B = -sum r_ji grad W_ij V_j
    (inner only), then the determinant-weighted blend of inverse(B) with
    identity (weight2 = max(alpha - det, 0) renormalized)."""
    pos, vol = fluid["Position"], fluid["VolumetricMeasure"]
    pg = pair_geometry(pos, pos, nbr_inner, kernel, dim, need_W=False)
    vol_j, _ = gather(vol, nbr_inner.idx)
    gradw = (pg.dW * vol_j)[..., None] * pg.e  # (N,K,d)
    r_ji = pg.r[..., None] * pg.e
    B = (1.0e-6 * jnp.eye(dim, dtype=pos.dtype)
         - jnp.sum(r_ji[..., :, None] * gradw[..., None, :], axis=1))
    det = jnp.linalg.det(B)
    det_sqr = jnp.maximum(alpha - det, 0.0)
    w1 = det / (det + det_sqr + TINY)
    w2 = det_sqr / (det + det_sqr + TINY)
    inv = jnp.linalg.inv(B)
    eye = jnp.eye(dim, dtype=pos.dtype)
    out = dict(fluid)
    out["TurbulentCorrectionMatrix"] = (w1[:, None, None] * inv
                                        + w2[:, None, None] * eye)
    return out


# ---------------------------------------------------------------------------
# Velocity gradient (GetVelocityGradient Inner + Contact<Wall>)
# ---------------------------------------------------------------------------

def turbulent_velocity_gradient(fluid: State, nbr_inner: NeighborList,
                                wall: State, nbr_wall: NeighborList, kernel,
                                dim: int, weight_sub: float) -> State:
    """GetVelocityGradient (k-epsilon_turbulent_model.cpp:69-141):
    grad_i = sum_j -(v_i - v_j) (dW V_j e_ij)^T, with the sub-near-wall
    blend: when P2_i == 10 and P1_j == 1 the pair uses
    (1-w) P1-term + w * [-(grad_j r_ij e_ij) (dW V_j e)^T] (the neighbor's
    wall-law gradient extrapolated over the pair distance); wall contact
    adds -(v_i - 0) terms; update right-multiplies the turbulent correction
    matrix.  Near-wall P1 particles keep the wall-function gradient set by
    standard_wall_function_correction."""
    pos, vel, vol = fluid["Position"], fluid["Velocity"], fluid["VolumetricMeasure"]
    grad_old = fluid["TurbulentVelocityGradient"]
    p1, p2 = fluid["IsNearWallP1"], fluid["IsNearWallP2"]

    pg = pair_geometry(pos, pos, nbr_inner, kernel, dim, need_W=False)
    vel_j, _ = gather(vel, nbr_inner.idx)
    vol_j, _ = gather(vol, nbr_inner.idx)
    p1_j, _ = gather(p1, nbr_inner.idx)
    grad_j, _ = gather(grad_old, nbr_inner.idx)  # (N,K,d,d)

    nablaWV = (pg.dW * vol_j)[..., None] * pg.e  # (N,K,d)
    vdiff = vel[:, None, :] - vel_j
    P1_term = -vdiff[..., :, None] * nablaWV[..., None, :]  # (N,K,d,d)
    # neighbor's gradient times the pair separation vector
    r_vec = pg.r[..., None] * pg.e
    vel_ext = jnp.einsum("nkab,nkb->nka", grad_j, r_vec)
    P2_term = -vel_ext[..., :, None] * nablaWV[..., None, :]
    blend = ((p2 == 10)[:, None] & (p1_j == 1))[..., None, None]
    pair_term = jnp.where(blend,
                          (1.0 - weight_sub) * P1_term + weight_sub * P2_term,
                          P1_term)
    grad = jnp.sum(pair_term, axis=1)

    pgw = pair_geometry(pos, wall["Position"], nbr_wall, kernel, dim,
                        need_W=False)
    wvol_j, _ = gather(wall["VolumetricMeasure"], nbr_wall.idx)
    nablaWVw = (pgw.dW * wvol_j)[..., None] * pgw.e
    grad = grad - jnp.sum(
        vel[:, None, :, None] * nablaWVw[..., None, :], axis=1)

    grad = jnp.einsum("nab,nbc->nac", grad, fluid["TurbulentCorrectionMatrix"])
    out = dict(fluid)
    out["TurbulentVelocityGradient"] = jnp.where(
        (p1 == 1)[:, None, None], grad_old, grad)
    return out


# ---------------------------------------------------------------------------
# K and Epsilon transport (K_TurbulentModelInner / E_TurbulentModelInner)
# ---------------------------------------------------------------------------

def _harmonic_lap(pg, q_i, q_j, mu_i, mu_j, rho, vol_j, h):
    """2 mu_harmo (q_i - q_j)/(r + 0.01h) dW V_j / rho_i summed over j."""
    mu_h = 2.0 * mu_i[:, None] * mu_j / (mu_i[:, None] + mu_j + TINY)
    dq = (q_i[:, None] - q_j) / (pg.r + 0.01 * h)
    return jnp.sum(2.0 * mu_h * dq * pg.dW * vol_j, axis=1) / rho


def k_equation(fluid: State, nbr_inner: NeighborList, kernel, dim: int,
               mu: float, h: float, dt, cl: TurbuClosure = TurbuClosure(),
               stl: bool = True) -> State:
    """K_TurbulentModelInner (k-epsilon_turbulent_model.cpp:172-238):
    dk/dt = G_k - eps + lap(mu_t/sigma_k + mu, k); G_k from the Reynolds
    stress contracted with the velocity gradient; near-wall P1 particles
    keep the wall-function G_k.  STL update divides the dissipation term
    implicitly: k = (k + (G_k + lap) dt) / (1 + eps dt / k)."""
    pos, vol = fluid["Position"], fluid["VolumetricMeasure"]
    rho = fluid["Density"]
    k, eps = fluid["TurbulenceKineticEnergy"], fluid["TurbulentDissipation"]
    mu_t = fluid["TurbulentViscosity"]
    grad = fluid["TurbulentVelocityGradient"]
    p1 = fluid["IsNearWallP1"]

    pg = pair_geometry(pos, pos, nbr_inner, kernel, dim, need_W=False)
    vol_j, _ = gather(vol, nbr_inner.idx)
    k_j, _ = gather(k, nbr_inner.idx)
    mu_t_j, _ = gather(mu_t, nbr_inner.idx)
    mu_eff = mu_t / cl.sigma_k + mu
    mu_eff_j = mu_t_j / cl.sigma_k + mu
    k_lap = _harmonic_lap(pg, k, k_j, mu_eff, mu_eff_j, rho, vol_j, h)

    strain = 0.5 * (grad + jnp.swapaxes(grad, -1, -2))
    eye = jnp.eye(dim, dtype=pos.dtype)
    re_stress = (2.0 * strain * (mu_t / rho)[:, None, None]
                 - (2.0 / 3.0) * k[:, None, None] * eye)
    g_k_bulk = jnp.sum(re_stress * grad, axis=(-1, -2))
    g_k = jnp.where(p1 == 1, fluid["K_Production"], g_k_bulk)

    out = dict(fluid)
    out["K_Production"] = g_k
    out["TurbulentStrainRate"] = strain
    if stl:
        k_new = (k + (g_k + k_lap) * dt) / (1.0 + eps * dt / jnp.maximum(k, TINY))
    else:
        k_new = k + (g_k - eps + k_lap) * dt
    out["TurbulenceKineticEnergy"] = k_new
    return out


def epsilon_equation(fluid: State, nbr_inner: NeighborList, kernel, dim: int,
                     mu: float, h: float, dt,
                     cl: TurbuClosure = TurbuClosure(),
                     stl: bool = True) -> State:
    """E_TurbulentModelInner (k-epsilon_turbulent_model.cpp:249-313):
    deps/dt = C1 eps G_k / k - C2 eps^2 / k + lap(mu_t/sigma_e + mu, eps);
    update skipped for near-wall P1 particles (their eps is the wall-law
    value)."""
    pos, vol = fluid["Position"], fluid["VolumetricMeasure"]
    rho = fluid["Density"]
    k, eps = fluid["TurbulenceKineticEnergy"], fluid["TurbulentDissipation"]
    mu_t = fluid["TurbulentViscosity"]
    p1 = fluid["IsNearWallP1"]

    pg = pair_geometry(pos, pos, nbr_inner, kernel, dim, need_W=False)
    vol_j, _ = gather(vol, nbr_inner.idx)
    eps_j, _ = gather(eps, nbr_inner.idx)
    mu_t_j, _ = gather(mu_t, nbr_inner.idx)
    mu_eff = mu_t / cl.sigma_e + mu
    mu_eff_j = mu_t_j / cl.sigma_e + mu
    e_lap = _harmonic_lap(pg, eps, eps_j, mu_eff, mu_eff_j, rho, vol_j, h)

    k_safe = jnp.maximum(k, TINY)
    e_prod = cl.c_1 * eps * fluid["K_Production"] / k_safe
    e_diss = cl.c_2 * eps * eps / k_safe

    if stl:
        eps_new = ((eps + (e_prod + e_lap) * dt)
                   / (1.0 + cl.c_2 * eps * dt / k_safe))
    else:
        eps_new = eps + (e_prod - e_diss + e_lap) * dt
    out = dict(fluid)
    out["TurbulentDissipation"] = jnp.where(p1 == 1, eps, eps_new)
    return out


# ---------------------------------------------------------------------------
# Turbulent kinetic-energy force (TKEnergyForceComplex)
# ---------------------------------------------------------------------------

def tke_energy_force(fluid: State, nbr_inner: NeighborList, wall: State,
                     nbr_wall: NeighborList, kernel, dim: int) -> State:
    """TKEnergyForce Inner + Contact (k-epsilon_turbulent_model.cpp:315-
    367): F_i = -(2/3) m_i [sum_j (k_i + k_j) dW V_j e_ij
    + sum_wall 2 k_i dW V_j e_ij].  Accumulated into ForcePrior with the
    previous contribution subtracted (re-evaluated every acoustic
    substep, the reference adds it to force_ before the pressure
    relaxation each substep)."""
    pos, vol = fluid["Position"], fluid["VolumetricMeasure"]
    k = fluid["TurbulenceKineticEnergy"]
    mass = fluid["Mass"]

    pg = pair_geometry(pos, pos, nbr_inner, kernel, dim, need_W=False)
    vol_j, _ = gather(vol, nbr_inner.idx)
    k_j, _ = gather(k, nbr_inner.idx)
    k_grad = jnp.sum(((k[:, None] + k_j) * pg.dW * vol_j)[..., None] * pg.e,
                     axis=1)

    pgw = pair_geometry(pos, wall["Position"], nbr_wall, kernel, dim,
                        need_W=False)
    wvol_j, _ = gather(wall["VolumetricMeasure"], nbr_wall.idx)
    k_grad = k_grad + jnp.sum(
        (2.0 * k[:, None] * pgw.dW * wvol_j)[..., None] * pgw.e, axis=1)

    force = -(2.0 / 3.0) * k_grad * mass[:, None]
    out = dict(fluid)
    out["ForcePrior"] = fluid["ForcePrior"] + force - fluid["TkeForcePrev"]
    out["TkeForcePrev"] = force
    return out


# ---------------------------------------------------------------------------
# Turbulent viscous force (TurbuViscousForce Inner + Contact<Wall>)
# ---------------------------------------------------------------------------

def turbulent_viscous_force(fluid: State, nbr_inner: NeighborList,
                            wall: State, nbr_wall: NeighborList, kernel,
                            dim: int, mu: float, h: float, c0: float, time,
                            cl: TurbuClosure = TurbuClosure(),
                            extra_dissipation: bool = True) -> State:
    """TurbuViscousForce (k-epsilon_turbulent_model.cpp:369-474): inner
    shear with the pairwise harmonic mean of (mu + mu_t) and the optional
    extra inner dissipation limiter (swap the longitudinal component for an
    upwinded rho h min(3 max(du,0), c0) one when it exceeds the harmonic
    viscosity); the wall contact term is the WALL-FUNCTION shear stress
    WSS = rho u_fric^2 sign(u_tau) (e_tau e_n^T) applied to P2 particles."""
    pos, vel, vol = fluid["Position"], fluid["Velocity"], fluid["VolumetricMeasure"]
    rho = fluid["Density"]
    mu_t = fluid["TurbulentViscosity"]
    k = fluid["TurbulenceKineticEnergy"]
    p2 = fluid["IsNearWallP2"]
    eps_r = 0.01 * h

    pg = pair_geometry(pos, pos, nbr_inner, kernel, dim, need_W=False)
    vol_j, _ = gather(vol, nbr_inner.idx)
    vel_j, _ = gather(vel, nbr_inner.idx)
    mu_t_j, _ = gather(mu_t, nbr_inner.idx)
    mu_i = mu_t + mu
    mu_j = mu_t_j + mu
    mu_h = 2.0 * mu_i[:, None] * mu_j / (mu_i[:, None] + mu_j + TINY)

    vdiff = vel[:, None, :] - vel_j
    vderiv = vdiff / (pg.r + eps_r)[..., None]
    shear = mu_h[..., None] * vderiv
    shear_long = jnp.sum(shear * pg.e, axis=-1, keepdims=True) * pg.e
    if extra_dissipation:
        u_jump = jnp.sum(vdiff * pg.e, axis=-1)
        dissip = rho[:, None] * h * jnp.minimum(
            3.0 * jnp.maximum(u_jump, 0.0), c0)
        corrected = (jnp.sum(dissip[..., None] * vderiv * pg.e, axis=-1,
                             keepdims=True) * pg.e)
        use_corr = (mu_h < dissip)[..., None]
        shear = shear - shear_long + jnp.where(use_corr, corrected, shear_long)
    force = jnp.sum(shear * (2.0 * pg.dW * vol_j)[..., None], axis=1)
    force = force * (fluid["Mass"] / rho)[:, None]

    # wall-function WSS contact (cpp:422-474)
    pgw = pair_geometry(pos, wall["Position"], nbr_wall, kernel, dim,
                        need_W=False)
    wvol_j, _ = gather(wall["VolumetricMeasure"], nbr_wall.idx)
    n_j, _ = gather(wall["NormalDirection"], nbr_wall.idx)
    vel_n = jnp.sum(vel[:, None, :] * n_j, axis=-1, keepdims=True) * n_j
    vel_tau = vel[:, None, :] - vel_n
    e_tau = vel_tau / (jnp.linalg.norm(vel_tau, axis=-1, keepdims=True) + TINY)
    u_tau_mag = jnp.abs(jnp.sum(vel[:, None, :] * e_tau, axis=-1))

    k05 = jnp.sqrt(jnp.maximum(k, TINY))[:, None]
    y_p = fluid["Y_P"][:, None]
    nu = mu / jnp.maximum(rho, TINY)[:, None]
    y_star = cl.c_mu_25 * k05 * y_p / nu
    u_star = dimensionless_velocity(y_star, time, cl)
    fric2 = cl.c_mu_25 * k05 * u_tau_mag / jnp.maximum(u_star, TINY)
    sgn = jnp.sign(jnp.sum(vel[:, None, :] * e_tau, axis=-1) + TINY)
    wss_mag = rho[:, None] * fric2 * sgn
    # WSS e_ij = wss_mag (e_tau e_n^T) e_ij
    wss_e = wss_mag[..., None] * e_tau * jnp.sum(n_j * pgw.e, axis=-1)[..., None]
    fw = jnp.sum(wss_e * (2.0 * pgw.dW * wvol_j)[..., None], axis=1)
    fw = fw * (fluid["Mass"] / rho)[:, None]
    force = force + jnp.where((p2 == 10)[:, None], fw, 0.0)

    out = dict(fluid)
    out["ViscousForce"] = force
    out["ForcePrior"] = fluid["ForcePrior"] + force - fluid.get(
        "ViscousForcePrev", jnp.zeros_like(force))
    out["ViscousForcePrev"] = force
    return out


# ---------------------------------------------------------------------------
# Standard wall-function correction
# ---------------------------------------------------------------------------

def standard_wall_function_correction(fluid: State, wall: State,
                                      nbr_wall: NeighborList, kernel,
                                      dim: int, mu: float, time,
                                      cl: TurbuClosure = TurbuClosure()) -> State:
    """StandardWallFunctionCorrection (k-epsilon_turbulent_model.cpp:726-
    877): for P2 particles compute y*, the friction velocity and y+; for P1
    particles override eps, the velocity gradient and G_k with the
    wall-law values weighted (W V) over the wall neighborhood:
      eps_p = C_mu^3/4 k^3/2 / (kappa y_p)  [log layer]
            = 2 k nu / y_p^2               [laminar layer]
      dudn  = u_fric^2 / (C_mu^1/4 k^1/2 kappa y_p), grad = dudn e_tau e_n^T
      G_k_p = rho u_fric^2 dudn            [log layer, else 0].
    """
    pos, vel = fluid["Position"], fluid["Velocity"]
    rho = fluid["Density"]
    k = fluid["TurbulenceKineticEnergy"]
    p1, p2 = fluid["IsNearWallP1"], fluid["IsNearWallP2"]
    e_n = fluid["WallNearestNormal"]

    k05 = jnp.sqrt(jnp.maximum(k, TINY))
    k15 = jnp.maximum(k, TINY) ** 1.5
    nu = mu / jnp.maximum(rho, TINY)
    y_p = fluid["Y_P"]

    vel_tau_vec = vel - jnp.sum(vel * e_n, axis=-1, keepdims=True) * e_n
    e_i_tau = vel_tau_vec / (jnp.linalg.norm(vel_tau_vec, axis=-1,
                                             keepdims=True) + TINY)
    u_tan = jnp.abs(jnp.sum(e_i_tau * vel, axis=-1))

    y_star = y_p * cl.c_mu_25 * k05 / nu
    u_star = dimensionless_velocity(y_star, time, cl)
    fric_mag = jnp.sqrt(cl.c_mu_25 * k05 * u_tan / jnp.maximum(u_star, TINY))
    fric_vel = fric_mag[:, None] * e_i_tau
    fric_vel = jnp.where(jnp.sum(vel * fric_vel, axis=-1, keepdims=True) < 0,
                         -fric_vel, fric_vel)

    out = dict(fluid)
    near = p2 == 10
    out["WallYstar"] = jnp.where(near, y_star, 0.0)
    out["WallYplus"] = jnp.where(near, y_p * fric_mag / nu, 0.0)
    out["FrictionVelocity"] = jnp.where(near[:, None], fric_vel, 0.0)
    out["TangentialVelocity"] = jnp.where(near, u_tan, 0.0)

    # P1 overrides, weighted over wall neighbors (per-wall-neighbor tangent)
    pgw = pair_geometry(pos, wall["Position"], nbr_wall, kernel, dim,
                        need_dW=False)
    wvol_j, _ = gather(wall["VolumetricMeasure"], nbr_wall.idx)
    n_j, _ = gather(wall["NormalDirection"], nbr_wall.idx)
    w_j = pgw.W * wvol_j
    total_w = jnp.sum(w_j, axis=1) + TINY

    e_j_tau = (jnp.stack([n_j[..., 1], -n_j[..., 0]], axis=-1) if dim == 2
               else jnp.cross(n_j, jnp.broadcast_to(
                   jnp.asarray([0.0, 0.0, 1.0], pos.dtype), n_j.shape)))
    u_tau_j = jnp.abs(jnp.sum(vel[:, None, :] * e_j_tau, axis=-1))
    y_star_j = (cl.c_mu_25 * k05 / nu)[:, None] * y_p[:, None]
    u_star_j = dimensionless_velocity(y_star_j, time, cl)
    fric_j2 = cl.c_mu_25 * k05[:, None] * u_tau_j / jnp.maximum(u_star_j, TINY)
    denom_log = cl.c_mu_25 * k05[:, None] * cl.karman * y_p[:, None]
    dudn_mag_j = fric_j2 / jnp.maximum(denom_log, TINY)
    sgn_j = jnp.sign(jnp.sum(vel[:, None, :] * e_j_tau, axis=-1) + TINY)

    laminar_j = (y_star_j < cl.y_star_laminar) & (time > cl.start_time_laminar)
    eps_log = (cl.c_mu_75 * k15 / (cl.karman * y_p))[:, None]
    eps_lam = (2.0 * k * nu / (y_p * y_p))[:, None]
    eps_j = jnp.where(laminar_j, eps_lam, eps_log)
    gk_j = jnp.where(laminar_j, 0.0, rho[:, None] * fric_j2 * dudn_mag_j)

    eps_p = jnp.sum(w_j * eps_j, axis=1) / total_w
    dudn_p = jnp.sum(w_j * dudn_mag_j * sgn_j, axis=1) / total_w
    gk_p = jnp.sum(w_j * gk_j, axis=1) / total_w
    grad_p = dudn_p[:, None, None] * (e_i_tau[..., :, None]
                                      * e_n[..., None, :])

    is_p1 = p1 == 1
    out["TurbulentDissipation"] = jnp.where(is_p1, eps_p,
                                            fluid["TurbulentDissipation"])
    out["TurbulentVelocityGradient"] = jnp.where(
        is_p1[:, None, None], grad_p, fluid["TurbulentVelocityGradient"])
    out["K_Production"] = jnp.where(is_p1, gk_p, fluid["K_Production"])
    return out


def constrain_normal_velocity_region_p(fluid: State) -> State:
    """ConstrainNormalVelocityInRegionP (cpp:867-877): remove the
    wall-normal velocity component of P1 particles."""
    vel, e_n = fluid["Velocity"], fluid["WallNearestNormal"]
    v_proj = vel - jnp.sum(vel * e_n, axis=-1, keepdims=True) * e_n
    out = dict(fluid)
    out["Velocity"] = jnp.where((fluid["IsNearWallP1"] == 1)[:, None],
                                v_proj, vel)
    return out


def eddy_viscosity_update(fluid: State,
                          cl: TurbuClosure = TurbuClosure()) -> State:
    """TurbulentEddyViscosity (cpp:476-489): mu_t = rho C_mu k^2 / eps."""
    out = dict(fluid)
    out["TurbulentViscosity"] = (fluid["Density"] * cl.c_mu
                                 * fluid["TurbulenceKineticEnergy"] ** 2
                                 / jnp.maximum(fluid["TurbulentDissipation"],
                                               TINY))
    return out


def turbulent_advection_time_step(fluid: State, mu: float, rho0: float,
                                  h: float, u_max: float,
                                  cfl: float = 0.25):
    """TurbulentAdvectionTimeStepSize (cpp:491-519): the viscous speed uses
    mu + mu_t per particle."""
    visc_speed = (mu + fluid["TurbulentViscosity"]) / rho0 / h
    vel2 = jnp.sum(fluid["Velocity"] ** 2, axis=-1)
    speed2 = jnp.max(jnp.maximum(visc_speed ** 2, vel2))
    ref = max(u_max, mu / rho0 / h)
    return cfl * h / (jnp.maximum(jnp.sqrt(speed2), ref) + TINY)


def turbulent_inflow_values(u_inlet: float, characteristic_length: float,
                            cl: TurbuClosure = TurbuClosure()):
    """Intensity-based inlet turbulence (InflowTurbulentCondition, type 0):
    k = 1.5 (I u)^2, eps = C_mu^3/4 k^1.5 / (0.07 L)."""
    k_in = 1.5 * (cl.intensity * u_inlet) ** 2
    length = cl.length_ratio_eps_inlet * characteristic_length
    eps_in = cl.c_mu_75 * k_in ** 1.5 / length
    return k_in, eps_in
