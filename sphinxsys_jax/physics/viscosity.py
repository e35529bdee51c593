"""Non-Newtonian viscosity models and dynamics.

Counterpart of /root/reference/src/shared/materials/viscosity.{h,cpp} and
src/shared/particle_dynamics/fluid_dynamics/non_newtonian_dynamics/
non_newtonian_dynamics.{h,cpp} plus the VariableViscosity pair functor of
viscous_dynamics.h:55-65 (harmonic pair average 2 mu_i mu_j / (mu_i+mu_j),
particle_functors.h:196-210).

Three families:

  * Generalized Newtonian (shear-rate dependent): HerschelBulkley and
    Carreau models produce a per-particle "VariableViscosity" field from
    the deviatoric strain-rate magnitude sqrt(2 tr(D^2))
    (ShearRateDependentViscosity::update).
  * viscous_force_variable: the ViscousForce interaction with the
    harmonic inter-particle viscosity (NonNewtonianViscousForceWithWall).
  * Oldroyd-B viscoelasticity: an "ElasticStress" tensor evolved by the
    upper-convected Maxwell rate and fed back as a pairwise elastic force
    inside the pressure relaxation (Oldroyd_BIntegration1st/2ndHalf).

All functions are pure and jit-friendly; models are hashable dataclasses
usable as static arguments.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp

from sphinxsys_jax.core.state import State
from sphinxsys_jax.neighbors.neighbor_list import NeighborList, gather
from sphinxsys_jax.physics.pair import pair_geometry

TINY = 1.0e-15


# ---------------------------------------------------------------------------
# Material models (materials/viscosity.h)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HerschelBulkleyViscosity:
    """mu(gamma) = (tau_y + K gamma_eff^n) / gamma_eff with the shear rate
    clamped to [min_shear_rate, max_shear_rate] (viscosity.cpp:30-36)."""
    min_shear_rate: float
    max_shear_rate: float
    consistency_index: float
    power_index: float
    yield_stress: float

    def viscosity(self, shear_rate):
        sr = jnp.clip(shear_rate, self.min_shear_rate, self.max_shear_rate)
        return (self.yield_stress
                + self.consistency_index * sr ** self.power_index) / sr

    @property
    def reference_viscosity(self):
        # the reference stores mu_ = max_shear_rate in the base ctor
        # (viscosity.cpp:13-14); the physically useful bound for time
        # stepping is the viscosity AT the clamp limits.
        return float(self.viscosity(jnp.asarray(self.min_shear_rate)))


@dataclasses.dataclass(frozen=True)
class CarreauViscosity:
    """mu(gamma) = mu_inf + (mu0-mu_inf)(1+(t_c gamma_eff)^2)^((n-1)/2)
    (viscosity.cpp:43-49)."""
    min_shear_rate: float
    max_shear_rate: float
    characteristic_time: float
    mu_infty: float
    mu0: float
    power_index: float

    def viscosity(self, shear_rate):
        sr = jnp.clip(shear_rate, self.min_shear_rate, self.max_shear_rate)
        return self.mu_infty + (self.mu0 - self.mu_infty) * (
            1.0 + (self.characteristic_time * sr) ** 2
        ) ** (0.5 * (self.power_index - 1.0))

    @property
    def reference_viscosity(self):
        return self.mu0


@dataclasses.dataclass(frozen=True)
class OldroydBViscosity:
    """Solvent viscosity mu, relaxation time lambda, polymeric viscosity
    mu_p (viscosity.h:69-81)."""
    mu: float
    relaxation_time: float
    mu_p: float


# ---------------------------------------------------------------------------
# Shear-rate dependent viscosity field
# ---------------------------------------------------------------------------

def shear_rate_magnitude(vel_grad, dim: int):
    """sqrt(2 tr(D^2)) of the deviatoric strain rate
    (ShearRateDependentViscosity::update, non_newtonian_dynamics.cpp)."""
    D = 0.5 * (vel_grad + jnp.swapaxes(vel_grad, -1, -2))
    tr = jnp.trace(D, axis1=-2, axis2=-1)
    D = D - (tr / dim)[..., None, None] * jnp.eye(dim, dtype=vel_grad.dtype)
    return jnp.sqrt(2.0 * jnp.einsum("...ij,...ij->...", D, D))


def update_variable_viscosity(state: State, nl: NeighborList, kernel,
                              dim: int, model, box=None) -> State:
    """Compute "VelocityGradient" and the per-particle "VariableViscosity"
    field mu(shear_rate) (ShearRateDependentViscosity)."""
    from sphinxsys_jax.physics.general import velocity_gradient

    g = velocity_gradient(state, nl, kernel, dim, box)
    out = dict(state)
    out["VelocityGradient"] = g
    out["VariableViscosity"] = model.viscosity(shear_rate_magnitude(g, dim))
    return out


def viscous_force_variable(fluid: State, nl_inner: NeighborList, kernel,
                           dim: int, smoothing_length: float,
                           walls=(), box=None) -> State:
    """ViscousForce with the harmonic inter-particle viscosity
    2 mu_i mu_j/(mu_i+mu_j) (NonNewtonianViscousForceWithWall,
    viscous_dynamics.h:166-167).  Wall contacts use mu_i one-sided (the
    wall carries no viscosity field).  Accumulates into ForcePrior with
    the same running-difference bookkeeping as fluid.viscous_force."""
    pos, vel, vol = fluid["Position"], fluid["Velocity"], fluid["VolumetricMeasure"]
    mu = fluid["VariableViscosity"]
    eps_r = 0.01 * smoothing_length

    pg = pair_geometry(pos, pos, nl_inner, kernel, dim, need_W=False, box=box)
    vel_j, _ = gather(vel, nl_inner.idx)
    vol_j, _ = gather(vol, nl_inner.idx)
    mu_j, _ = gather(mu, nl_inner.idx)
    mu_ij = 2.0 * mu[:, None] * mu_j / (mu[:, None] + mu_j + TINY)
    vderiv = (vel[:, None, :] - vel_j) / (pg.r + eps_r)[..., None]
    force = 2.0 * jnp.sum(mu_ij[..., None] * vderiv
                          * (pg.dW * vol_j)[..., None], axis=1)

    for wstate, wnl in walls:
        pgw = pair_geometry(pos, wstate["Position"], wnl, kernel, dim,
                            need_W=False, box=box)
        wall_vol, _ = gather(wstate["VolumetricMeasure"], wnl.idx)
        vel_ave_k, _ = gather(wstate["AverageVelocity"], wnl.idx)
        vderiv_w = 2.0 * (vel[:, None, :] - vel_ave_k) / (pgw.r + eps_r)[..., None]
        force = force + 2.0 * mu[:, None] * jnp.sum(
            vderiv_w * (pgw.dW * wall_vol)[..., None], axis=1)

    out = dict(fluid)
    out["ViscousForce"] = force * vol[:, None]
    out["ForcePrior"] = fluid["ForcePrior"] + out["ViscousForce"] - fluid.get(
        "ViscousForcePrev", jnp.zeros_like(force))
    out["ViscousForcePrev"] = out["ViscousForce"]
    return out


def srd_viscous_time_step(fluid: State, smoothing_length: float,
                          diffusion_cfl: float = 0.125):
    """dt_visc = CFL h^2 / max(mu/rho) with the shear-rate-dependent field
    (SRDViscousTimeStepSize, non_newtonian_dynamics.cpp:100-115)."""
    from sphinxsys_jax.core.state import valid_mask

    nu = fluid["VariableViscosity"] / fluid["Density"]
    nu = jnp.where(valid_mask(fluid), nu, 0.0)
    return diffusion_cfl * smoothing_length ** 2 / (jnp.max(nu) + TINY)


# ---------------------------------------------------------------------------
# Oldroyd-B viscoelasticity
# ---------------------------------------------------------------------------

def make_oldroyd_b_state(fluid: State, dim: int) -> State:
    """Register "ElasticStress" / "ElasticStressChangeRate"
    (Oldroyd_BIntegration1stHalf<Inner<>> ctor)."""
    out = dict(fluid)
    n = fluid["Position"].shape[0]
    dtype = fluid["Position"].dtype
    out.setdefault("ElasticStress", jnp.zeros((n, dim, dim), dtype))
    out.setdefault("ElasticStressChangeRate", jnp.zeros((n, dim, dim), dtype))
    return out


def elastic_stress_force(fluid: State, nl_inner: NeighborList, kernel,
                         dim: int, walls=(), box=None):
    """F_i = V_i sum_j (tau_i + tau_j) . gradW_ij V_j, wall contact uses
    2 tau_i (stress boundary condition)
    (Oldroyd_BIntegration1stHalf interaction, non_newtonian_dynamics.cpp
    :27-72; mass_i/rho_i there is the current volume V_i)."""
    pos, vol = fluid["Position"], fluid["VolumetricMeasure"]
    tau = fluid["ElasticStress"]

    pg = pair_geometry(pos, pos, nl_inner, kernel, dim, need_W=False, box=box)
    vol_j, _ = gather(vol, nl_inner.idx)
    tau_j, _ = gather(tau, nl_inner.idx)
    grad = (pg.dW * vol_j)[..., None] * pg.e           # (N,K,d)
    force = jnp.einsum("nkij,nkj->ni", tau[:, None] + tau_j, grad)

    for wstate, wnl in walls:
        pgw = pair_geometry(pos, wstate["Position"], wnl, kernel, dim,
                            need_W=False, box=box)
        wall_vol, _ = gather(wstate["VolumetricMeasure"], wnl.idx)
        gw = jnp.sum((pgw.dW * wall_vol)[..., None] * pgw.e, axis=1)  # (N,d)
        force = force + 2.0 * jnp.einsum("nij,nj->ni", tau, gw)

    return force * vol[:, None]


def oldroyd_b_stress_half_step(fluid: State, dt) -> State:
    """tau += dtau/dt * dt/2 — called at the start of the 1st half and the
    end of the 2nd half (initialization/update hooks)."""
    out = dict(fluid)
    out["ElasticStress"] = (fluid["ElasticStress"]
                            + fluid["ElasticStressChangeRate"] * (0.5 * dt))
    return out


def oldroyd_b_stress_rate(fluid: State, nl_inner: NeighborList, kernel,
                          dim: int, model: OldroydBViscosity,
                          box=None) -> State:
    """Upper-convected Maxwell rate (Oldroyd_BIntegration2ndHalf::update):
    dtau/dt = gradv^T tau + tau gradv - tau/lambda
              + (gradv^T + gradv) mu_p/lambda."""
    from sphinxsys_jax.physics.general import velocity_gradient

    g = velocity_gradient(fluid, nl_inner, kernel, dim, box)
    gT = jnp.swapaxes(g, -1, -2)
    tau = fluid["ElasticStress"]
    lam, mu_p = model.relaxation_time, model.mu_p
    rate = (jnp.einsum("nij,njk->nik", gT, tau)
            + jnp.einsum("nij,njk->nik", tau, g)
            - tau / lam + (gT + g) * (mu_p / lam))
    out = dict(fluid)
    out["VelocityGradient"] = g
    out["ElasticStressChangeRate"] = rate
    return out


def oldroyd_b_1st_half(fluid: State, nl_inner: NeighborList, kernel,
                       dim: int, eos, riemann, dt, walls=(),
                       box=None) -> State:
    """Oldroyd_BIntegration1stHalfWithWall: stress half-step, then the
    acoustic pressure relaxation with the elastic-stress divergence added
    to the momentum balance."""
    from sphinxsys_jax.physics import fluid as fd

    fluid = oldroyd_b_stress_half_step(fluid, dt)
    f_el = elastic_stress_force(fluid, nl_inner, kernel, dim, walls, box)
    work = dict(fluid)
    work["ForcePrior"] = fluid["ForcePrior"] + f_el
    work = fd.acoustic_step_1st_half(work, nl_inner, kernel, dim, eos,
                                     riemann, dt, walls=walls, box=box)
    work["ForcePrior"] = fluid["ForcePrior"]  # elastic force is per-step
    return work


def oldroyd_b_2nd_half(fluid: State, nl_inner: NeighborList, kernel,
                       dim: int, riemann, dt, model: OldroydBViscosity,
                       walls=(), box=None) -> State:
    """Oldroyd_BIntegration2ndHalfWithWall: density update, then the
    stress-rate evaluation and trailing stress half-step."""
    from sphinxsys_jax.physics import fluid as fd

    fluid = fd.acoustic_step_2nd_half(fluid, nl_inner, kernel, dim, riemann,
                                      dt, walls=walls, box=box)
    fluid = oldroyd_b_stress_rate(fluid, nl_inner, kernel, dim, model, box)
    return oldroyd_b_stress_half_step(fluid, dt)
