"""Diffusion, reaction, and electrophysiology dynamics.

Counterpart of /root/reference/src/shared/particle_dynamics/
diffusion_reaction_dynamics/ (diffusion_dynamics.{h,hpp} explicit/RK2
relaxation with Dirichlet contact BCs; reaction_dynamics.h operator-split
exponential-integrator ODE sweeps) and electro_physiology/ (monodomain
transmembrane diffusion-reaction with the Aliev-Panfilow two-variable
cell model, electro_physiology.cpp:24-56).

SPH diffusion operator (diffusion_dynamics.hpp:76-99):
    dC/dt_i = sum_j d_ij (C_i - C_j) * 2 dW_ij V_j / r_ij
Dirichlet contact adds the same term against fixed boundary values.
Reaction update per species (reaction_dynamics.h:48-52, exponential /
quasi-steady integrator):
    C <- C e^{-L dt} + P (1 - e^{-L dt}) / L
applied forward then backward over the species list (Strang-like split).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Sequence

import jax
import jax.numpy as jnp

from sphinxsys_jax.core.state import State
from sphinxsys_jax.neighbors.neighbor_list import NeighborList, gather
from sphinxsys_jax.physics.pair import pair_geometry

TINY = 1.0e-15


# ---------------------------------------------------------------------------
# diffusion models (materials/diffusion_reaction.h:47-296)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class IsotropicDiffusion:
    d_coeff: float

    def inter_particle_coeff(self, e_ij, fiber_i=None, fiber_j=None):
        return self.d_coeff

    @property
    def reference_diffusivity(self) -> float:
        return self.d_coeff


@dataclasses.dataclass(frozen=True)
class DirectionalDiffusion:
    """D = d I + d_bias f f^T; pair coefficient 1/|T e|^2 with T the
    inverse Cholesky factor of D (diffusion_reaction.h:190-194), i.e.
    EXACTLY 1/(e^T D^-1 e).  Closed form via Sherman-Morrison:
    e^T D^-1 e = (1/d)(1 - beta/(d+beta) (e.f)^2) for unit e, f —
    coeff = d+beta along the fiber, d across it, and the inverse-metric
    interpolation (NOT the quadratic form d + beta (e.f)^2, which agrees
    only at the principal directions) at oblique angles."""

    d_coeff: float
    bias_coeff: float
    bias_direction: tuple

    def inter_particle_coeff(self, e_ij, fiber_i=None, fiber_j=None):
        f = jnp.asarray(self.bias_direction, dtype=e_ij.dtype)
        proj = jnp.sum(e_ij * f, axis=-1)
        d, b = self.d_coeff, self.bias_coeff
        return d / (1.0 - (b / (d + b)) * proj * proj)

    @property
    def reference_diffusivity(self) -> float:
        return self.d_coeff + self.bias_coeff


@dataclasses.dataclass(frozen=True)
class LocalDirectionalDiffusion:
    """Diffusion biased along a PER-PARTICLE fiber field
    (LocalDirectionalDiffusion, materials/diffusion_reaction.h:236-242):
    D_i = d I + d_bias f_i f_i^T.  The reference averages the two
    particles' inverse-Cholesky transforms T_i = chol(D_i)^-1 and returns
    1/|0.5 (T_i + T_j) e|^2 — reproduced here exactly: per-pair batched
    Cholesky of the (dim, dim) tensors, triangular inverse, element-wise
    average, quadratic form.  (The naive mean of the two quadratic forms
    d + 0.5 d_bias ((e.f_i)^2 + (e.f_j)^2) agrees only along principal
    fiber directions and overestimates oblique conduction — ADVICE r4.)

    `fiber_key` names the per-particle direction array in the state;
    diffusion_step gathers it when the diffusion object carries this
    attribute."""

    d_coeff: float
    bias_coeff: float
    fiber_key: str = "Fiber"

    def _inv_chol(self, f):
        """T = chol(d I + b f f^T)^-1 for a (..., dim) fiber stack."""
        dim = f.shape[-1]
        eye = jnp.eye(dim, dtype=f.dtype)
        D = self.d_coeff * eye + self.bias_coeff * (f[..., :, None]
                                                    * f[..., None, :])
        L = jnp.linalg.cholesky(D)
        return jax.scipy.linalg.solve_triangular(
            L, jnp.broadcast_to(eye, L.shape), lower=True)

    def inter_particle_coeff(self, e_ij, fiber_i=None, fiber_j=None):
        if fiber_i is None:
            return self.d_coeff + 0.5 * self.bias_coeff
        T_avg = 0.5 * (self._inv_chol(fiber_i)[:, None] +
                       self._inv_chol(fiber_j))
        g = jnp.einsum("...ij,...j->...i", T_avg, e_ij)
        return 1.0 / (jnp.sum(g * g, axis=-1) + TINY)

    @property
    def reference_diffusivity(self) -> float:
        return self.d_coeff + self.bias_coeff


def diffusion_time_step(h: float, diffusion, dim: int) -> float:
    """dt = 0.5 h^2 / d / dim (diffusion_reaction.cpp:16-19)."""
    return 0.5 * h * h / diffusion.reference_diffusivity / dim


# ---------------------------------------------------------------------------
# diffusion relaxation
# ---------------------------------------------------------------------------

def diffusion_rate(pos_q, species_q, vol_s, pos_s, species_s, nl: NeighborList,
                   kernel, dim: int, diffusion, box=None, B_q=None, B_s=None,
                   local_diff_q=None, local_diff_s=None, fiber_q=None,
                   fiber_s=None):
    """dC/dt contribution through one relation.  `B_q`/`B_s`: linear
    gradient correction matrices of the two sides — when given, the pair
    surface area uses the corrected kernel gradient
    0.5 (B_i + B_j) e (CorrectedKernelGradientInner,
    diffusion_dynamics.h:92-103), restoring consistency at truncated
    supports (domain corners/edges).

    `local_diff_q`/`local_diff_s`: per-particle diffusivity arrays
    (LocalIsotropicDiffusion, materials/diffusion_reaction.h:136-158) —
    the pair coefficient becomes the arithmetic mean
    0.5 (k_i + k_j), overriding `diffusion`'s constant coefficient."""
    pg = pair_geometry(pos_q, pos_s, nl, kernel, dim, need_W=False, box=box)
    vol_j, _ = gather(vol_s, nl.idx)
    c_j, _ = gather(species_s, nl.idx)
    if local_diff_q is not None:
        if local_diff_s is None:
            # contact body without its own diffusivity field: the pair
            # coefficient degenerates to the interior particle's k_i
            d_ij = local_diff_q[:, None]
        else:
            k_j, _ = gather(local_diff_s, nl.idx)
            d_ij = 0.5 * (local_diff_q[:, None] + k_j)
    elif fiber_q is not None:
        f_j, _ = gather(fiber_s if fiber_s is not None else fiber_q, nl.idx)
        d_ij = diffusion.inter_particle_coeff(pg.e, fiber_q, f_j)
    else:
        d_ij = diffusion.inter_particle_coeff(pg.e)
    area = 2.0 * pg.dW * vol_j / (pg.r + TINY)
    if B_q is not None:
        B_j, _ = gather(B_s if B_s is not None else B_q, nl.idx)
        Be = jnp.einsum("nkab,nkb->nka", 0.5 * (B_q[:, None] + B_j), pg.e)
        area = area * jnp.sum(Be * pg.e, axis=-1)
    return jnp.sum(d_ij * (species_q[:, None] - c_j) * area, axis=1)


def _normal_area(pos_q, n_q, vol_s, pos_s, n_s, nl: NeighborList, kernel,
                 dim: int, box=None):
    """Boundary surface-area measure of Neumann/Robin contact pairs
    (diffusion_dynamics.hpp:258-262,329-332):
        area_ij = (dW_ij V_j) e_ij . (n_i - n_j)."""
    pg = pair_geometry(pos_q, pos_s, nl, kernel, dim, need_W=False, box=box)
    vol_j, _ = gather(vol_s, nl.idx)
    n_j, _ = gather(n_s, nl.idx)
    n_ij = n_q[:, None, :] - n_j
    return (pg.dW * vol_j) * jnp.sum(pg.e * n_ij, axis=-1)


def neumann_rate(state: State, species: str, contact_state: State,
                 nl_c: NeighborList, kernel, dim: int, box=None):
    """Neumann (prescribed diffusive flux) contact rate
    (DiffusionRelaxation<Neumann<>>, diffusion_dynamics.hpp:233-265):
        dC/dt_i += sum_j area_ij * flux_j
    reading the boundary body's "<species>Flux" variable and both bodies'
    NormalDirection."""
    area = _normal_area(state["Position"], state["NormalDirection"],
                        contact_state["VolumetricMeasure"],
                        contact_state["Position"],
                        contact_state["NormalDirection"], nl_c, kernel, dim,
                        box)
    flux_j, _ = gather(contact_state[species + "Flux"], nl_c.idx)
    return jnp.sum(area * flux_j, axis=1)


def robin_rate(state: State, species: str, contact_state: State,
               nl_c: NeighborList, kernel, dim: int, c_infinity,
               box=None):
    """Robin (convective) contact rate (DiffusionRelaxation<Robin<>>,
    diffusion_dynamics.hpp:296-337):
        dC/dt_i += sum_j conv_j (C_inf - C_i) area_ij
    with the per-boundary-particle convection coefficient
    "<species>Convection" and the scalar far-field value `c_infinity`
    ("<species>Infinity" single variable in the reference)."""
    area = _normal_area(state["Position"], state["NormalDirection"],
                        contact_state["VolumetricMeasure"],
                        contact_state["Position"],
                        contact_state["NormalDirection"], nl_c, kernel, dim,
                        box)
    conv_j, _ = gather(contact_state[species + "Convection"], nl_c.idx)
    phi = c_infinity - state[species]
    return jnp.sum(area * conv_j, axis=1) * phi


def diffusion_step(state: State, species: str, nl_inner: NeighborList, kernel,
                   dim: int, diffusion, dt, dirichlet_contacts: Sequence[tuple] = (),
                   neumann_contacts: Sequence[tuple] = (),
                   robin_contacts: Sequence[tuple] = (), box=None,
                   correction: bool = False, local_diff: str = None) -> State:
    """One explicit Euler diffusion step.
      dirichlet_contacts: (contact_state, nl_contact) with fixed `species`
          values (Dirichlet<...>, diffusion_dynamics.h:173-207)
      neumann_contacts: (contact_state, nl_contact) carrying
          "<species>Flux" + NormalDirection (diffusion_dynamics.h:189-209)
      robin_contacts: (contact_state, nl_contact, c_infinity) carrying
          "<species>Convection" (diffusion_dynamics.h:212-231)
      local_diff: state key of a per-particle diffusivity field
          (LocalIsotropicDiffusion), e.g. "ThermalConductivity"."""
    pos = state["Position"]
    c = state[species]
    B = state["LinearGradientCorrectionMatrix"] if correction else None
    kq = state[local_diff] if local_diff is not None else None
    fq = state[diffusion.fiber_key] if hasattr(diffusion, "fiber_key") else None
    rate = diffusion_rate(pos, c, state["VolumetricMeasure"], pos, c, nl_inner,
                          kernel, dim, diffusion, box, B_q=B,
                          local_diff_q=kq, local_diff_s=kq, fiber_q=fq,
                          fiber_s=fq)
    for c_state, nl_c in dirichlet_contacts:
        # Dirichlet boundaries double the concentration jump (ghost value
        # reflected across the interface): phi_ij = 2 (C_i - C_j)
        # (diffusion_dynamics.hpp:180)
        rate = rate + 2.0 * diffusion_rate(pos, c,
                                           c_state["VolumetricMeasure"],
                                           c_state["Position"],
                                           c_state[species], nl_c, kernel,
                                           dim, diffusion, box,
                                           local_diff_q=kq,
                                           local_diff_s=(c_state.get(local_diff)
                                                         if local_diff else None))
    for c_state, nl_c in neumann_contacts:
        rate = rate + neumann_rate(state, species, c_state, nl_c, kernel,
                                   dim, box)
    for c_state, nl_c, c_inf in robin_contacts:
        rate = rate + robin_rate(state, species, c_state, nl_c, kernel, dim,
                                 c_inf, box)
    out = dict(state)
    out[species] = c + rate * dt
    return out


def diffusion_step_local_rk2(state: State, species: str,
                             nl_inner: NeighborList, kernel, dim: int,
                             diffusion, dt, local_diff: str,
                             robin_contacts: Sequence[tuple] = (),
                             box=None) -> State:
    """RK2 diffusion relaxation with a per-particle diffusivity field +
    Robin convective boundaries (DiffusionBodyRelaxationComplex<
    BaseDiffusion, ..., Robin> over LocalIsotropicDiffusion, the
    windows_frame_diffusion composition)."""
    c0 = state[species]
    s1 = diffusion_step(state, species, nl_inner, kernel, dim, diffusion, dt,
                        robin_contacts=robin_contacts, box=box,
                        local_diff=local_diff)
    s2 = diffusion_step(s1, species, nl_inner, kernel, dim, diffusion, dt,
                        robin_contacts=robin_contacts, box=box,
                        local_diff=local_diff)
    out = dict(s2)
    out[species] = 0.5 * (c0 + s2[species])
    return out


def diffusion_step_rk2(state: State, species: str, nl_inner: NeighborList,
                       kernel, dim: int, diffusion, dt,
                       dirichlet_contacts: Sequence[tuple] = (), box=None,
                       neumann_contacts: Sequence[tuple] = (),
                       robin_contacts: Sequence[tuple] = (),
                       correction: bool = False) -> State:
    """Second-order Runge-Kutta: C_half via two Euler steps averaged with
    the initial value (DiffusionRelaxationRK2, diffusion_dynamics.h)."""
    c0 = state[species]
    s1 = diffusion_step(state, species, nl_inner, kernel, dim, diffusion, dt,
                        dirichlet_contacts, neumann_contacts, robin_contacts,
                        box, correction)
    s2 = diffusion_step(s1, species, nl_inner, kernel, dim, diffusion, dt,
                        dirichlet_contacts, neumann_contacts, robin_contacts,
                        box, correction)
    out = dict(s2)
    out[species] = 0.5 * (c0 + s2[species])
    return out


# ---------------------------------------------------------------------------
# reaction models + operator-split relaxation
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AlievPanfilowModel:
    """Two-variable excitation-recovery cell model
    (electro_physiology.cpp:24-56).  Species: "Voltage" (V),
    "GateVariable" (w); production/loss split for the exponential
    integrator:
        dV/dt: P = -k V (V^2 - a V - V)/c_m           L = (k a + w)/c_m
        dw/dt: P = -g k V (V - b - 1), g = eps + mu1 w/(mu2 + V)
               L = g
    """

    k_a: float = 0.0
    c_m: float = 1.0
    k: float = 8.0
    a: float = 0.15
    b: float = 0.15
    mu_1: float = 0.2
    mu_2: float = 0.3
    epsilon: float = 0.002

    @property
    def species_names(self):
        if self.k_a != 0.0:
            return ("Voltage", "GateVariable", "ActiveContractionStress")
        return ("Voltage", "GateVariable")

    def rates(self, name: str, species: Dict[str, jnp.ndarray]):
        v = species["Voltage"]
        w = species["GateVariable"]
        if name == "Voltage":
            production = -self.k * v * (v * v - self.a * v - v) / self.c_m
            loss = (self.k * self.a + w) / self.c_m
        elif name == "GateVariable":
            g = self.epsilon + self.mu_1 * w / (self.mu_2 + v + TINY)
            production = -g * self.k * v * (v - self.b - 1.0)
            loss = g
        elif name == "ActiveContractionStress":
            # excitation-contraction coupling
            # (electro_physiology.cpp getProduction/LossRateActiveContractionStress)
            v_dim = v * 100.0 - 80.0
            factor = 0.1 + 0.9 * jnp.exp(-jnp.exp(-v_dim))
            production = factor * self.k_a * (v_dim + 80.0)
            loss = factor
        else:
            raise KeyError(name)
        return production, loss


def _exponential_update(c, production, loss, dt):
    """reaction_dynamics.h:48-52 quasi-steady exponential integrator."""
    alpha = jnp.exp(-loss * dt)
    return c * alpha + production * (1.0 - alpha) / (loss + TINY)


def reaction_step(state: State, model, dt, backward: bool = False) -> State:
    """One operator-split reaction sweep over the model's species
    (ReactionRelaxation forward/backward, reaction_dynamics.h:55-80)."""
    out = dict(state)
    names = list(model.species_names)
    if backward:
        names = names[::-1]
    for name in names:
        species = {k: out[k] for k in model.species_names}
        production, loss = model.rates(name, species)
        out[name] = _exponential_update(out[name], production, loss, dt)
    return out


def electrophysiology_step(state: State, nl_inner: NeighborList, kernel,
                           dim: int, diffusion, model, dt, box=None) -> State:
    """Monodomain operator splitting (Strang): half reaction forward,
    full diffusion of Voltage, half reaction backward — the composition
    used by the electrophysiology cases (electro_physiology.h:42-104)."""
    s = reaction_step(state, model, 0.5 * dt)
    s = diffusion_step_rk2(s, "Voltage", nl_inner, kernel, dim, diffusion, dt,
                           box=box,
                           correction="LinearGradientCorrectionMatrix" in s)
    s = reaction_step(s, model, 0.5 * dt, backward=True)
    return s
