"""Saturated porous-media solid dynamics (multi-species continuum).

Counterpart of /root/reference/tests/extra_source_and_tests/extra_src/
shared/porous_media_{solid,dynamics}.{h,cpp} (namespace
multi_species_continuum): a linear-elastic skeleton carrying a diffusing
pore fluid.  The momentum unknown is the TOTAL momentum (solid + fluid);
the fluid moves relative to the skeleton by a saturation-driven Darcy
flux, and the pore pressure k_w (s - eps) swells the skeleton:

  stress half:   Stress = (cauchy(almansi) - k_w s I) F^-T   (per volume)
                 d(total momentum)/dt_i = sum_j (Stress_i + Stress_j
                     + damping - outer_i - outer_j) gradW V_j
  momentum half: v = (M - q) V_up / m_total ;  v_f = v - q/(rho_f s)
  saturation:    q = -D rho_f s grad s ;
                 dm_f/dt = D V_up rho_f div(s grad s)   (pairwise form)

All state is per-particle in the solid body's frame; the saturation
relaxation runs on the ADVECTION (outer) time scale, the stress halves on
the acoustic scale (2d_membrane.cpp main loop).
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp

from sphinxsys_jax.core.state import State
from sphinxsys_jax.neighbors.neighbor_list import gather
from sphinxsys_jax.physics.solid import ReferencePairs

TINY = 1.0e-15


@dataclasses.dataclass(frozen=True)
class PorousMediaSolid:
    """LinearElasticSolid + pore-fluid parameters (porous_media_solid.h)."""

    rho0: float
    youngs_modulus: float
    poisson_ratio: float
    diffusivity_constant: float
    fluid_initial_density: float
    water_pressure_constant: float

    @property
    def shear_modulus(self) -> float:
        return self.youngs_modulus / (2.0 * (1.0 + self.poisson_ratio))

    @property
    def lambda0(self) -> float:
        nu = self.poisson_ratio
        return self.youngs_modulus * nu / ((1.0 + nu) * (1.0 - 2.0 * nu))

    @property
    def bulk_modulus(self) -> float:
        nu = self.poisson_ratio
        return self.youngs_modulus / (3.0 * (1.0 - 2.0 * nu))

    @property
    def sound_speed(self) -> float:
        import math

        return math.sqrt(self.bulk_modulus / self.rho0)


def make_porous_state(pos, volume, material: PorousMediaSolid,
                      dtype=jnp.float32) -> State:
    from sphinxsys_jax.physics.solid import make_elastic_solid_state

    state = dict(make_elastic_solid_state(pos, volume, material, dtype=dtype))
    n = state["Position"].shape[0]
    dim = state["Position"].shape[1]
    zeros_s = jnp.zeros((n,), dtype)
    zeros_v = jnp.zeros((n, dim), dtype)
    state.update({
        "UpdateVolume": state["VolumetricMeasure"],
        "FluidSaturation": zeros_s,
        "FluidMass": zeros_s,
        "FluidMassIncrement": zeros_s,
        "TotalMass": state["Mass"],
        "TotalMomentum": zeros_v,
        "FluidVelocity": zeros_v,
        "RelativeFluidFlux": zeros_v,
        "OuterFluidVelocityRelativeFluidFlux": jnp.zeros((n, dim, dim), dtype),
        "Stress": jnp.zeros((n, dim, dim), dtype),
    })
    return state


def set_initial_saturation(porous: State, mask, saturation: float,
                           material: PorousMediaSolid) -> State:
    """PorousMediaSaturationDynamicsInitialCondition: saturate a body part
    and update the total (solid + fluid) mass."""
    out = dict(porous)
    vol = porous["VolumetricMeasure"]
    sat = jnp.where(mask, saturation, porous["FluidSaturation"])
    fluid_mass = sat * material.fluid_initial_density * vol
    out["FluidSaturation"] = sat
    out["FluidMass"] = fluid_mass
    out["TotalMass"] = material.rho0 * vol + fluid_mass
    return out


def porous_stress_relaxation_1st_half(porous: State, rp: ReferencePairs,
                                      material: PorousMediaSolid, dt,
                                      smoothing_length: float, w0: float,
                                      numerical_dissipation_factor: float = 0.25) -> State:
    """PorousMediaStressRelaxationFirstHalf."""
    out = dict(porous)
    dim = porous["Position"].shape[1]
    rho0 = material.rho0
    c0 = material.sound_speed

    # ---- initialization ---------------------------------------------------
    pos = porous["Position"] + porous["Velocity"] * (0.5 * dt)
    F = porous["DeformationGradient"] + porous["DeformationRate"] * (0.5 * dt)
    J = jnp.linalg.det(F)
    inv_F_T = jnp.swapaxes(jnp.linalg.inv(F), -1, -2)
    eye = jnp.eye(dim, dtype=F.dtype)
    almansi = 0.5 * (eye - jnp.linalg.inv(F @ jnp.swapaxes(F, -1, -2)))
    vol_update = porous["VolumetricMeasure"] * J

    sat = porous["FluidSaturation"]
    cauchy = (material.lambda0 * jnp.trace(almansi, axis1=-2, axis2=-1)[..., None, None] * eye
              + 2.0 * material.shear_modulus * almansi)
    stress = (cauchy - (material.water_pressure_constant
                        * sat)[..., None, None] * eye) @ inv_F_T
    outer = jnp.einsum("ni,nj->nij", porous["FluidVelocity"],
                       porous["RelativeFluidFlux"]) @ inv_F_T

    # ---- interaction --------------------------------------------------------
    vel = porous["Velocity"]
    vol_j, _ = gather(porous["VolumetricMeasure"], rp.idx)
    stress_j, _ = gather(stress, rp.idx)
    outer_j, _ = gather(outer, rp.idx)
    F_j, _ = gather(F, rp.idx)
    pos_j, _ = gather(pos, rp.idx)
    vel_j, _ = gather(vel, rp.idx)

    dim_over_r = dim / (rp.r + TINY)
    strain_rate = dim_over_r * dim_over_r * jnp.sum(
        (pos[:, None, :] - pos_j) * (vel[:, None, :] - vel_j), axis=-1)
    pair_damping = 0.5 * rho0 * c0 * strain_rate * smoothing_length
    weight = rp.W / w0
    stress_ij = (stress[:, None] + stress_j
                 + (numerical_dissipation_factor * weight * pair_damping)[..., None, None]
                 * 0.5 * (F[:, None] + F_j)
                 - outer[:, None] - outer_j)
    coeff = (rp.dW * vol_j * rp.mask)[..., None]
    force = jnp.sum(jnp.einsum("nkij,nkj->nki", stress_ij, rp.e) * coeff,
                    axis=1)

    # ---- update --------------------------------------------------------------
    momentum = porous["TotalMomentum"] + (porous["ForcePrior"] + force) * dt
    out.update({
        "Position": pos, "DeformationGradient": F, "UpdateVolume": vol_update,
        "Stress": stress, "OuterFluidVelocityRelativeFluidFlux": outer,
        "Force": force, "TotalMomentum": momentum,
    })
    return out


def porous_stress_relaxation_2nd_half(porous: State, rp: ReferencePairs,
                                      material: PorousMediaSolid, dt) -> State:
    """PorousMediaStressRelaxationSecondHalf: velocities from the total
    momentum, then the deformation rate."""
    out = dict(porous)
    vel = ((porous["TotalMomentum"] - porous["RelativeFluidFlux"])
           * porous["UpdateVolume"][:, None]
           / jnp.maximum(porous["TotalMass"], TINY)[:, None])
    fluid_vel = vel - porous["RelativeFluidFlux"] / (
        material.fluid_initial_density
        * (porous["FluidSaturation"] + TINY))[:, None]
    pos = porous["Position"] + vel * (0.5 * dt)

    vol_j, _ = gather(porous["VolumetricMeasure"], rp.idx)
    vel_j, _ = gather(vel, rp.idx)
    grad = (rp.dW * vol_j * rp.mask)[..., None] * rp.e
    dF_dt = -jnp.einsum("nki,nkj->nij", vel[:, None] - vel_j, grad)
    dF_dt = dF_dt @ porous["LinearGradientCorrectionMatrix"]

    out.update({
        "Velocity": vel, "FluidVelocity": fluid_vel, "Position": pos,
        "DeformationRate": dF_dt,
        "DeformationGradient": porous["DeformationGradient"] + dF_dt * (0.5 * dt),
    })
    return out


def saturation_relaxation(porous: State, rp: ReferencePairs,
                          material: PorousMediaSolid, Dt) -> State:
    """SaturationRelaxationInPorousMedia: Darcy flux from the saturation
    gradient and the pairwise Laplacian-form divergence of s grad s."""
    out = dict(porous)
    D = material.diffusivity_constant
    rho_f = material.fluid_initial_density
    sat = porous["FluidSaturation"]
    vol_j, _ = gather(porous["VolumetricMeasure"], rp.idx)
    sat_j, _ = gather(sat, rp.idx)
    dwV = rp.dW * vol_j * rp.mask
    grad_s = -jnp.sum(((sat[:, None] - sat_j) * dwV)[..., None] * rp.e, axis=1)
    div_flux = jnp.sum(0.5 * (sat[:, None] ** 2 - sat_j ** 2)
                       / (rp.r + TINY) * dwV, axis=1)

    flux = -D * rho_f * sat[:, None] * grad_s
    dm_dt = D * porous["UpdateVolume"] * rho_f * div_flux

    fluid_mass = porous["FluidMass"] + dm_dt * Dt
    total_mass = material.rho0 * porous["VolumetricMeasure"] + fluid_mass
    saturation = fluid_mass / (rho_f * jnp.maximum(porous["UpdateVolume"], TINY))
    out.update({
        "RelativeFluidFlux": flux, "FluidMassIncrement": dm_dt,
        "FluidMass": fluid_mass, "TotalMass": total_mass,
        "FluidSaturation": saturation,
    })
    return out


def saturation_time_step(material: PorousMediaSolid, smoothing_length: float,
                         dim: int) -> float:
    """GetSaturationTimeStepSize: 0.5 h^2 / D / dim."""
    return 0.5 * smoothing_length ** 2 / material.diffusivity_constant / dim


def porous_momentum_constraint(porous: State, mask) -> State:
    """MomentumConstraint: clamp the total momentum on a body part."""
    out = dict(porous)
    out["TotalMomentum"] = jnp.where(mask[:, None], 0.0,
                                     porous["TotalMomentum"])
    return out
