"""Granular / updated-Lagrangian continuum dynamics (Drucker-Prager).

Counterpart of /root/reference/src/shared/particle_dynamics/
continuum_dynamics/continuum_integration.{h,hpp,cpp} and
materials/general_continuum.{h,cpp}:

  * PlasticContinuum: Drucker-Prager yield with non-associated flow,
    Jaumann stress rate, return mapping
        alpha_phi = tan(phi)/sqrt(9 + 12 tan^2 phi)
        k_c       = 3 c / sqrt(9 + 12 tan^2 phi)
  * PlasticIntegration 1st/2nd half: the WCSPH dual-half-step scheme with
    the pressure replaced by the full (3D, plane-strain in 2D) stress
    tensor; velocity gradient accumulated in the 2nd half feeds the
    constitutive update + return mapping
  * StressDiffusion: regularization of the stress field.

The 2D simulation carries 3x3 stress tensors (plane strain), exactly like
the reference's Mat3d `StressTensor3D` with degrade/upgrade helpers.
"""

from __future__ import annotations

import dataclasses
import math

import jax.numpy as jnp

from sphinxsys_jax.core.state import State
from sphinxsys_jax.core.materials import Material
from sphinxsys_jax.neighbors.neighbor_list import NeighborList, gather
from sphinxsys_jax.physics.pair import pair_geometry

TINY = 1.0e-15


@dataclasses.dataclass(frozen=True)
class GeneralContinuum(Material):
    """general_continuum.h:36: elastic continuum with artificial sound
    speed (WCSPH-style EoS for the volumetric part)."""

    c0: float = 1.0
    youngs_modulus: float = 1.0
    poisson_ratio: float = 0.3

    @property
    def shear_modulus(self) -> float:
        return 0.5 * self.youngs_modulus / (1.0 + self.poisson_ratio)

    @property
    def bulk_modulus(self) -> float:
        return self.youngs_modulus / (3.0 * (1.0 - 2.0 * self.poisson_ratio))

    def sound_speed(self, p=None, rho=None):
        return self.c0


@dataclasses.dataclass(frozen=True)
class PlasticContinuum(GeneralContinuum):
    """Drucker-Prager plasticity (general_continuum.cpp:38-90)."""

    friction_angle: float = 0.4  # radians
    cohesion: float = 0.0
    dilatancy: float = 0.0

    @property
    def alpha_phi(self) -> float:
        t = math.tan(self.friction_angle)
        return t / math.sqrt(9.0 + 12.0 * t * t)

    @property
    def k_c(self) -> float:
        t = math.tan(self.friction_angle)
        return 3.0 * self.cohesion / math.sqrt(9.0 + 12.0 * t * t)

    @property
    def alpha_psi(self) -> float:
        t = math.tan(self.dilatancy)
        return t / math.sqrt(9.0 + 12.0 * t * t)

    def constitutive_relation(self, velocity_gradient, stress_tensor):
        """Jaumann elastic rate minus the non-associated plastic corrector
        (general_continuum.cpp ConstitutiveRelation); inputs (..., 3, 3)."""
        G, K = self.shear_modulus, self.bulk_modulus
        L = velocity_gradient
        eye = jnp.eye(3, dtype=L.dtype)
        strain_rate = 0.5 * (L + jnp.swapaxes(L, -1, -2))
        spin_rate = 0.5 * (L - jnp.swapaxes(L, -1, -2))
        tr_e = jnp.trace(strain_rate, axis1=-2, axis2=-1)
        dev_e = strain_rate - (tr_e / 3.0)[..., None, None] * eye
        elastic = (2.0 * G * dev_e + K * tr_e[..., None, None] * eye
                   + stress_tensor @ jnp.swapaxes(spin_rate, -1, -2)
                   + spin_rate @ stress_tensor)
        tr_s = jnp.trace(stress_tensor, axis1=-2, axis2=-1)
        dev_s = stress_tensor - (tr_s / 3.0)[..., None, None] * eye
        J2 = 0.5 * jnp.sum(dev_s * dev_s, axis=(-2, -1))
        sqrtJ2 = jnp.sqrt(J2 + TINY)
        f = sqrtJ2 + self.alpha_phi * tr_s - self.k_c
        ds_e = jnp.sum(dev_s * strain_rate, axis=(-2, -1))
        lam = (3.0 * self.alpha_phi * K * tr_e + (G / sqrtJ2) * ds_e) / \
              (9.0 * self.alpha_phi * K * self.alpha_psi + G)
        g = lam[..., None, None] * (3.0 * K * self.alpha_psi * eye
                                    + (G / sqrtJ2)[..., None, None] * dev_s)
        plastic = jnp.where((f >= TINY)[..., None, None], g, 0.0)
        return elastic - plastic

    def return_mapping(self, stress_tensor):
        """Project back to the DP cone (general_continuum.cpp ReturnMapping)."""
        eye = jnp.eye(3, dtype=stress_tensor.dtype)
        I1 = jnp.trace(stress_tensor, axis1=-2, axis2=-1)
        # tension cutoff
        over = -self.alpha_phi * I1 + self.k_c < 0
        corr = ((I1 - self.k_c / max(self.alpha_phi, TINY)) / 3.0)[..., None, None] * eye
        s = jnp.where(over[..., None, None], stress_tensor - corr, stress_tensor)
        I1 = jnp.trace(s, axis1=-2, axis2=-1)
        dev = s - (I1 / 3.0)[..., None, None] * eye
        J2 = 0.5 * jnp.sum(dev * dev, axis=(-2, -1))
        sqrtJ2 = jnp.sqrt(J2 + TINY)
        yielding = -self.alpha_phi * I1 + self.k_c < sqrtJ2
        r = (-self.alpha_phi * I1 + self.k_c) / (sqrtJ2 + TINY)
        scaled = r[..., None, None] * dev + (I1 / 3.0)[..., None, None] * eye
        return jnp.where(yielding[..., None, None], scaled, s)


@dataclasses.dataclass(frozen=True)
class J2Plasticity(GeneralContinuum):
    """Von Mises (J2) plasticity with linear isotropic hardening on the
    deviatoric shear stress (general_continuum.h:126, .cpp:103-154); used
    by the updated-Lagrangian hourglass-controlled integrator
    (ShearStressRelaxationHourglassControl1stHalfJ2Plasticity,
    continuum_integration.cpp:159-179)."""

    yield_stress: float = 1.0
    hardening_modulus: float = 0.0

    _SQRT23 = math.sqrt(2.0 / 3.0)

    def _yield_f(self, shear_stress, hardening_factor):
        J2 = 0.5 * jnp.sum(shear_stress * jnp.swapaxes(shear_stress, -1, -2),
                           axis=(-2, -1))
        k = self.hardening_modulus * hardening_factor + self.yield_stress
        return jnp.sqrt(2.0 * J2) - self._SQRT23 * k, J2, k

    def shear_rate_with_hardening(self, velocity_gradient, shear_stress,
                                  hardening_factor):
        """ConstitutiveRelationShearStressWithHardening (cpp:113-130):
        Jaumann elastic deviatoric rate minus the plastic corrector."""
        G = self.shear_modulus
        L = velocity_gradient
        dim = L.shape[-1]
        eye = jnp.eye(dim, dtype=L.dtype)
        strain_rate = 0.5 * (L + jnp.swapaxes(L, -1, -2))
        spin = 0.5 * (L - jnp.swapaxes(L, -1, -2))
        dev_e = strain_rate - (jnp.trace(strain_rate, axis1=-2, axis2=-1)
                               / dim)[..., None, None] * eye
        elastic = (2.0 * G * dev_e
                   + shear_stress @ jnp.swapaxes(spin, -1, -2)
                   + spin @ shear_stress)
        f, J2, _ = self._yield_f(shear_stress, hardening_factor)
        s_dot_e = jnp.sum(shear_stress * strain_rate, axis=(-2, -1))
        lam = s_dot_e / (jnp.sqrt(2.0 * J2 + TINY)
                         * (1.0 + self.hardening_modulus / (3.0 * G)))
        g = (lam / jnp.sqrt(J2 + TINY))[..., None, None] * (
            math.sqrt(2.0) * G * shear_stress)
        return elastic - jnp.where((f > TINY)[..., None, None], g, 0.0)

    def hardening_factor_rate(self, shear_stress, hardening_factor):
        """HardeningFactorRate (cpp:149-154)."""
        f, _, _ = self._yield_f(shear_stress, hardening_factor)
        G = self.shear_modulus
        rate = 0.5 * f / (G + self.hardening_modulus / 3.0)
        return jnp.where(f > TINY, rate, 0.0)

    def scale_penalty_force(self, shear_stress, hardening_factor):
        """ScalePenaltyForce (cpp:142-147): radial-return ratio r<=1."""
        f, J2, k = self._yield_f(shear_stress, hardening_factor)
        r = self._SQRT23 * k / (jnp.sqrt(2.0 * J2) + TINY)
        return jnp.where(f > TINY, r, 1.0)

    def return_mapping_shear_stress(self, shear_stress, hardening_factor):
        """ReturnMappingShearStress (cpp:132-140)."""
        return self.scale_penalty_force(
            shear_stress, hardening_factor)[..., None, None] * shear_stress


def _degrade(s3, dim):
    return s3[..., :dim, :dim]


def _upgrade(m, dtype):
    d = m.shape[-1]
    out = jnp.zeros(m.shape[:-2] + (3, 3), dtype=dtype)
    return out.at[..., :d, :d].set(m)


def make_continuum_state(pos, volume, material, dtype=jnp.float32) -> State:
    from sphinxsys_jax.core.state import make_fluid_state

    state = dict(make_fluid_state(pos, volume, material.rho0, dtype=dtype))
    n = state["Position"].shape[0]
    state["StressTensor3D"] = jnp.zeros((n, 3, 3), dtype=dtype)
    state["StressRate3D"] = jnp.zeros((n, 3, 3), dtype=dtype)
    state["StrainTensor3D"] = jnp.zeros((n, 3, 3), dtype=dtype)
    state["VelocityGradient3D"] = jnp.zeros((n, 3, 3), dtype=dtype)
    return state


def plastic_integration_1st_half(soil: State, nl: NeighborList, kernel,
                                 dim: int, material, riemann, dt,
                                 wall: State | None = None,
                                 nl_wall: NeighborList | None = None) -> State:
    """continuum_integration.hpp PlasticIntegration1stHalf (inner + wall)."""
    out = dict(soil)
    mass = soil["Mass"]
    rho = soil["Density"] + soil["DensityChangeRate"] * (0.5 * dt)
    sigma3 = soil["StressTensor3D"]
    p = -jnp.trace(sigma3, axis1=-2, axis2=-1) / 3.0
    pos = soil["Position"] + soil["Velocity"] * (0.5 * dt)
    vol = soil["VolumetricMeasure"]

    pg = pair_geometry(pos, pos, nl, kernel, dim, need_W=False)
    sig = _degrade(sigma3, dim)
    sig_j, _ = gather(sig, nl.idx)
    rho_j, _ = gather(rho, nl.idx)
    p_j, _ = gather(p, nl.idx)
    vol_j, _ = gather(vol, nl.idx)
    grad = (pg.dW * vol_j)[..., None] * pg.e  # (N,K,dim)
    pair_sig = (sig[:, None] + sig_j) / (rho[:, None, None, None] * rho_j[..., None, None])
    force = mass[:, None] * jnp.einsum(
        "nk,nkij,nkj->ni", rho_j, pair_sig, grad)
    rho_diss = jnp.sum(riemann.dissipative_u_jump(p[:, None] - p_j) * pg.dW * vol_j, axis=1)
    force_total = soil["Force"] + force
    drho_dt = rho_diss * rho

    if wall is not None:
        # non-conservative force (hpp:56-69)
        ncf = soil["ForcePrior"] * rho[:, None] + mass[:, None] * jnp.sum(
            ((p[:, None] - p_j) * pg.dW * vol_j)[..., None] * pg.e, axis=1)
        ncf = ncf / rho[:, None]
        pgw = pair_geometry(pos, wall["Position"], nl_wall, kernel, dim, need_W=False)
        wall_vol, _ = gather(wall["VolumetricMeasure"], nl_wall.idx)
        wall_acc, _ = gather(wall["AverageAcceleration"], nl_wall.idx)
        dWV_w = pgw.dW * wall_vol
        acc_i = ncf / mass[:, None]
        face_acc = jnp.sum((acc_i[:, None, :] - wall_acc) * (-pgw.e), axis=-1)
        p_in_wall = p[:, None] + rho[:, None] * pgw.r * jnp.maximum(face_acc, 0.0)
        fw = ncf + 2.0 * mass[:, None] * jnp.einsum(
            "nij,nkj->ni", sig, dWV_w[..., None] * pgw.e)
        rho_diss_w = jnp.sum(riemann.dissipative_u_jump(p[:, None] - p_in_wall) * dWV_w, axis=1)
        force_total = force_total + fw / rho[:, None]
        drho_dt = drho_dt + rho_diss_w * rho

    vel = soil["Velocity"] + (soil["ForcePrior"] + force_total) / mass[:, None] * dt
    out.update({"Density": rho, "Pressure": p, "Position": pos,
                "Force": force_total, "DensityChangeRate": drho_dt,
                "Velocity": vel})
    return out


def plastic_integration_2nd_half(soil: State, nl: NeighborList, kernel,
                                 dim: int, material, riemann, dt,
                                 wall: State | None = None,
                                 nl_wall: NeighborList | None = None) -> State:
    """continuum_integration.hpp PlasticIntegration2ndHalf (inner + wall):
    density rate, momentum dissipation, velocity gradient, then the
    constitutive update + return mapping."""
    out = dict(soil)
    pos = soil["Position"] + soil["Velocity"] * (0.5 * dt)
    vel = soil["Velocity"]
    rho = soil["Density"]
    vol = soil["VolumetricMeasure"]
    mass = soil["Mass"]

    pg = pair_geometry(pos, pos, nl, kernel, dim, need_W=False)
    vel_j, _ = gather(vel, nl.idx)
    vol_j, _ = gather(vol, nl.idx)
    dWV = pg.dW * vol_j
    u_jump = jnp.sum((vel[:, None, :] - vel_j) * pg.e, axis=-1)
    dcr = jnp.sum(u_jump * dWV, axis=1)
    p_diss = mass[:, None] * jnp.sum(
        (riemann.dissipative_p_jump(u_jump) * dWV)[..., None] * pg.e, axis=1)
    dvel = vel[:, None, :] - vel_j
    vgrad = -jnp.einsum("nki,nkj->nij", dvel, dWV[..., None] * pg.e)

    drho_dt = soil["DensityChangeRate"] + dcr * rho
    force = p_diss / rho[:, None]

    if wall is not None:
        pgw = pair_geometry(pos, wall["Position"], nl_wall, kernel, dim, need_W=False)
        wall_vol, _ = gather(wall["VolumetricMeasure"], nl_wall.idx)
        vel_ave, _ = gather(wall["AverageVelocity"], nl_wall.idx)
        n_k, _ = gather(wall["NormalDirection"], nl_wall.idx)
        dWV_w = pgw.dW * wall_vol
        vel_in_wall = 2.0 * vel_ave - vel[:, None, :]
        dcr_w = jnp.sum(jnp.sum((vel[:, None, :] - vel_in_wall) * pgw.e, axis=-1) * dWV_w, axis=1)
        u_jump_w = 2.0 * jnp.sum((vel[:, None, :] - vel_ave) * n_k, axis=-1)
        p_diss_w = mass[:, None] * jnp.sum(
            (riemann.dissipative_p_jump(u_jump_w) * dWV_w)[..., None] * n_k, axis=1)
        dvel_w = vel[:, None, :] - vel_in_wall
        vgrad = vgrad - jnp.einsum("nki,nkj->nij", dvel_w, dWV_w[..., None] * pgw.e)
        drho_dt = drho_dt + dcr_w * rho
        force = force + p_diss_w / rho[:, None]

    rho_new = rho + drho_dt * (0.5 * dt)
    vol_new = mass / rho_new
    vg3 = _upgrade(vgrad, rho.dtype)
    stress_rate = soil["StressRate3D"] + material.constitutive_relation(
        vg3, soil["StressTensor3D"])
    sigma3 = soil["StressTensor3D"] + stress_rate * dt
    sigma3 = material.return_mapping(sigma3)
    strain_rate = 0.5 * (vg3 + jnp.swapaxes(vg3, -1, -2))
    strain3 = soil["StrainTensor3D"] + strain_rate * dt

    out.update({"Position": pos, "DensityChangeRate": drho_dt, "Force": force,
                "Density": rho_new, "VolumetricMeasure": vol_new,
                "StressTensor3D": sigma3, "StrainTensor3D": strain3,
                "StressRate3D": jnp.zeros_like(stress_rate),
                "VelocityGradient3D": vg3})
    return out


def stress_diffusion(soil: State, nl: NeighborList, kernel, dim: int,
                     material, smoothing_length: float,
                     zeta: float = 0.1) -> State:
    """StressDiffusion (continuum_integration.cpp:41-63): sets StressRate3D
    to the diffusive regularization (consumed by the next 2nd half)."""
    out = dict(soil)
    pos = soil["Position"]
    acc_prior = soil["ForcePrior"] / soil["Mass"][:, None]
    gravity = jnp.abs(acc_prior[:, 1])
    density = material.rho0
    phi = material.friction_angle
    c0 = material.c0

    pg = pair_geometry(pos, pos, nl, kernel, dim, need_W=False)
    vol_j, _ = gather(soil["VolumetricMeasure"], nl.idx)
    sig3_j, _ = gather(soil["StressTensor3D"], nl.idx)
    pos_j, _ = gather(pos, nl.idx)
    y_ij = pos[:, None, 1] - pos_j[..., 1]
    ds = soil["StressTensor3D"][:, None] - sig3_j
    hydro = density * gravity[:, None] * y_ij
    ds = ds.at[..., 0, 0].add(-(1 - math.sin(phi)) * hydro)
    ds = ds.at[..., 1, 1].add(-hydro)
    ds = ds.at[..., 2, 2].add(-(1 - math.sin(phi)) * hydro)
    coeff = 2.0 * zeta * smoothing_length * c0 * pg.r * pg.dW * vol_j / (
        pg.r**2 + 0.01 * smoothing_length)
    out["StressRate3D"] = jnp.sum(coeff[..., None, None] * ds, axis=1)
    return out


# ---------------------------------------------------------------------------
# Updated-Lagrangian ELASTIC solid with generalized hourglass control
# (continuum_integration.{h,cpp}: ShearStressRelaxationHourglassControl
# 1st/2ndHalf, used by test_2d_oscillating_beam_UL / test_3d_taylor_bar_UL).
# The pressure/density halves are the plain WCSPH acoustic halves
# (continuum_dynamics::Integration1stHalf == fluid 1st half + AccShear in
# the velocity update, continuum_integration.hpp:19-22) — compose them via
# fluid.acoustic_step_1st_half(..., extra_force=ul_shear_force(state)).
# ---------------------------------------------------------------------------


def make_ul_solid_state(pos, volume, material, dtype=jnp.float32) -> State:
    from sphinxsys_jax.core.state import make_fluid_state

    state = dict(make_fluid_state(pos, volume, material.rho0, dtype=dtype))
    n, d = state["Position"].shape
    state["ShearStress"] = jnp.zeros((n, d, d), dtype=dtype)
    state["StrainTensor"] = jnp.zeros((n, d, d), dtype=dtype)
    state["VelocityGradient"] = jnp.zeros((n, d, d), dtype=dtype)
    state["AccHourglass"] = jnp.zeros((n, d), dtype=dtype)
    state["AccShear"] = jnp.zeros((n, d), dtype=dtype)
    state["LinearGradientCorrectionMatrix"] = jnp.broadcast_to(
        jnp.eye(d, dtype=dtype), (n, d, d))
    return state


def correction_matrix_current(state: State, nl: NeighborList, kernel,
                              dim: int, alpha: float = 0.0,
                              eps: float = 1.0e-8) -> State:
    """LinearGradientCorrectionMatrixInner on the CURRENT configuration
    (kernel_correction.cpp) — the UL twin of solid.linear_gradient_
    correction_matrix (which acts on frozen reference pairs); refreshed
    every advection step (oscillating_beam_UL.cpp:207)."""
    out = dict(state)
    pos = state["Position"]
    pg = pair_geometry(pos, pos, nl, kernel, dim, need_W=False)
    vol_j, _ = gather(state["VolumetricMeasure"], nl.idx)
    grad = (pg.dW * vol_j)[..., None] * pg.e
    r_ji = pg.r[..., None] * pg.e
    A = -jnp.einsum("nki,nkj->nij", r_ji, grad)
    det = jnp.linalg.det(A)
    eye = jnp.eye(dim, dtype=A.dtype)
    At = jnp.swapaxes(A, -1, -2)
    inv = jnp.linalg.inv(At @ A + eps * eye) @ At
    det_sqr = jnp.maximum(alpha - det, 0.0)
    w1 = det / (det + det_sqr + TINY)
    w2 = det_sqr / (det + det_sqr + TINY)
    out["LinearGradientCorrectionMatrix"] = (
        w1[..., None, None] * inv + w2[..., None, None] * eye)
    return out


def shear_stress_hourglass_1st_half(state: State, nl: NeighborList, kernel,
                                    dim: int, material, dt,
                                    plasticity=None, xi: float = 2.0) -> State:
    """ShearStressRelaxationHourglassControl1stHalf (continuum_integration
    .cpp:81-104): B-corrected velocity gradient, Jaumann shear-stress rate
    sigma_dot = 2G dev(eps_dot) + sigma Omega^T + Omega sigma, strain
    accumulation.  `plasticity` (a J2Plasticity) switches to the
    ...1stHalfJ2Plasticity variant (cpp:159-179): rate with plastic
    corrector, hardening increment, xi-scaled penalty indicator, radial
    return."""
    out = dict(state)
    pos, vel = state["Position"], state["Velocity"]
    pg = pair_geometry(pos, pos, nl, kernel, dim, need_W=False)
    vel_j, _ = gather(vel, nl.idx)
    vol_j, _ = gather(state["VolumetricMeasure"], nl.idx)
    B = state["LinearGradientCorrectionMatrix"]
    # corrected kernel gradient B_i e_ij dW V_j, then g = -sum v_ij (x) grad
    grad = jnp.einsum("nij,nkj->nki", B, (pg.dW * vol_j)[..., None] * pg.e)
    g = -jnp.einsum("nki,nkj->nij", vel[:, None, :] - vel_j, grad)
    out["VelocityGradient"] = g

    gT = jnp.swapaxes(g, -1, -2)
    strain_rate = 0.5 * (g + gT)
    spin = 0.5 * (g - gT)
    eye = jnp.eye(dim, dtype=g.dtype)
    dev = strain_rate - (jnp.trace(strain_rate, axis1=-2, axis2=-1)
                         / dim)[..., None, None] * eye
    G = material.shear_modulus
    sig = state["ShearStress"]
    if plasticity is None:
        rate = (2.0 * G * dev + sig @ jnp.swapaxes(spin, -1, -2) + spin @ sig)
        out["ShearStress"] = sig + rate * dt
    else:
        k = state["HardeningFactor"]
        rate = plasticity.shear_rate_with_hardening(g, sig, k)
        sig_try = sig + rate * dt
        k_new = k + J2Plasticity._SQRT23 * plasticity.hardening_factor_rate(
            sig_try, k)
        out["HardeningFactor"] = k_new
        out["ScalePenaltyForce"] = xi * plasticity.scale_penalty_force(
            sig_try, k_new)
        out["ShearStress"] = plasticity.return_mapping_shear_stress(
            sig_try, k_new)
    out["StrainTensor"] = state["StrainTensor"] + strain_rate * dt
    return out


def _rodrigues(spin, dt):
    """Rotation exp(spin*dt) via the reference's trace form
    (continuum_integration.cpp:121-133); dim-generic (2D/3D)."""
    dim = spin.shape[-1]
    s2 = spin @ spin
    tr = jnp.trace(s2, axis1=-2, axis2=-1)
    omega = jnp.sqrt(jnp.maximum(-0.5 * tr, 0.0))
    theta = omega * dt
    eye = jnp.eye(dim, dtype=spin.dtype)
    safe = jnp.maximum(omega, TINY)[..., None, None]
    s_hat = spin / safe
    R = (eye + jnp.sin(theta)[..., None, None] * s_hat
         + (1.0 - jnp.cos(theta))[..., None, None] * (s_hat @ s_hat))
    return jnp.where((theta > 1.0e-12)[..., None, None], R, eye)


def shear_acceleration_hourglass_2nd_half(state: State, nl: NeighborList,
                                          kernel, dim: int, material, dt,
                                          xi: float = 2.0) -> State:
    """ShearStressRelaxationHourglassControl2ndHalf (cpp:134-157): shear
    acceleration + zero-energy-mode penalty.  The penalty accumulator
    AccHourglass is ROTATED by exp(Omega dt) each step (Rodrigues) so the
    stored correction co-rotates with the material."""
    out = dict(state)
    pos, vel = state["Position"], state["Velocity"]
    rho = state["Density"]
    sig = state["ShearStress"]
    g = state["VelocityGradient"]

    pg = pair_geometry(pos, pos, nl, kernel, dim, need_W=False)
    vol_j, _ = gather(state["VolumetricMeasure"], nl.idx)
    vel_j, _ = gather(vel, nl.idx)
    sig_j, _ = gather(sig, nl.idx)
    g_j, _ = gather(g, nl.idx)
    scale = state.get("ScalePenaltyForce")
    dWV = pg.dW * vol_j

    acc = jnp.einsum("nkij,nkj->ni",
                     (sig[:, None] + sig_j) / rho[:, None, None, None],
                     dWV[..., None] * pg.e)

    v_ij = vel[:, None, :] - vel_j
    v_pred = jnp.einsum("nkij,nkj->nki", 0.5 * (g[:, None] + g_j),
                        pg.r[..., None] * pg.e)
    v_corr = v_ij - v_pred
    if scale is None:
        penalty = xi
    else:
        scale_j, _ = gather(scale, nl.idx)
        penalty = 0.5 * (scale[:, None] + scale_j)
    G = material.shear_modulus
    coeff = penalty * G * jnp.sum(v_corr * pg.e, axis=-1) * dWV * dt / (
        rho[:, None] * jnp.maximum(pg.r, TINY))
    acc_hg_inc = jnp.sum(coeff[..., None] * pg.e, axis=1)

    spin = 0.5 * (g - jnp.swapaxes(g, -1, -2))
    R = _rodrigues(spin, dt)
    acc_hg = jnp.einsum("nij,nj->ni", R, state["AccHourglass"]) + acc_hg_inc
    out["AccHourglass"] = acc_hg
    out["AccShear"] = acc + acc_hg
    return out


def ul_shear_force(state: State):
    """AccShear folded into the acoustic velocity update as a force
    (BaseIntegration1stHalf::update, continuum_integration.hpp:19-22)."""
    return state["AccShear"] * state["Mass"][:, None]


def volume_update(state: State) -> State:
    """fluid_dynamics::ContinuumVolumeUpdate: Vol = m / rho."""
    out = dict(state)
    out["VolumetricMeasure"] = state["Mass"] / state["Density"]
    return out
