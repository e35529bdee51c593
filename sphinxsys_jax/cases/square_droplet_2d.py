"""2D square droplet rounding under surface tension.

Counterpart of /root/reference/tests/2d_examples/test_2d_square_droplet/
2d_square_droplet.cpp: a 1x1 water square (rho=1) suspended in a 1000x
lighter air phase inside a closed 2x2 box deforms toward a circle under
the momentum-conservative stress-form surface tension
(physics/surface_tension.py).  Both phases are weakly compressible with
the same numerical sound speed (c = 10 U_ref):

  * plain density summation for both phases with {other phase, wall}
    contacts (BaseDensitySummationComplex<Inner, Contact, Contact>);
  * AllParticles multi-phase transport-velocity correction for both;
  * MultiPhaseViscousForceWithWall: inner + harmonic-mu other-phase
    contact + wall;
  * surface-tension stress from the other-phase contact, stress force
    from {inner, other-phase contact}, recomputed every acoustic substep
    (2d_square_droplet.cpp:221-227);
  * acoustic dt floored by the capillary wave speed
    (SurfaceTensionTimeStep, CFL 0.6); advection dt with viscous CFL 0.1.

Both phases advance on the SHARED min dt inside one jitted loop (same
deviation as cases/two_phase_dambreak_2d.py — identical physics at the
shared smaller step, one trace).
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

from sphinxsys_jax.core import geometry as G
from sphinxsys_jax.core.adaptation import SPHAdaptation
from sphinxsys_jax.core.generators import generate_lattice
from sphinxsys_jax.core.materials import WeaklyCompressibleFluid
from sphinxsys_jax.core.state import State, make_fluid_state, make_solid_state
from sphinxsys_jax.neighbors import grid_from_bounds, build_cell_table, build_neighbor_list
from sphinxsys_jax.physics import fluid as fd
from sphinxsys_jax.physics import general as gd
from sphinxsys_jax.physics import riemann as rs
from sphinxsys_jax.physics import surface_tension as st

# 2d_square_droplet.cpp:14-29
DL = 2.0
DH = 2.0
LL = 1.0
LH = 1.0
RHO0_F = 1.0
RHO0_A = 0.001
U_REF = 1.0
C_F = 10.0 * U_REF
MU_F = 5.0e-2
MU_A = 5.0e-4
SIGMA = 1.0                     # surface_tension_coeff
MU_WA = 2.0 * MU_F * MU_A / (MU_F + MU_A)   # pair-harmonic (FixedViscosity)
FRAC_W = st.contact_fraction(RHO0_F, RHO0_A)
FRAC_A = st.contact_fraction(RHO0_A, RHO0_F)


class SimState(NamedTuple):
    water: Any
    air: Any
    nl_ww: Any
    nl_wa: Any
    nl_wb: Any
    nl_aa: Any
    nl_aw: Any
    nl_ab: Any
    time: jnp.ndarray
    n_adv: jnp.ndarray
    overflow: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class DropletCase:
    dx: float
    adaptation: SPHAdaptation
    grid: Any
    eos_w: WeaklyCompressibleFluid
    eos_a: WeaklyCompressibleFluid
    rs_w: rs.AcousticRiemannSolver
    rs_a: rs.AcousticRiemannSolver
    rs_wa: rs.AcousticRiemannSolver
    rs_aw: rs.AcousticRiemannSolver
    wall: State
    wall_table: Any
    n_water: int
    n_air: int
    cell_cap: int
    k_inner: int
    k_contact: int

    @property
    def kernel(self):
        return self.adaptation.kernel


def build_case(dx: float = DL / 50.0, dtype=jnp.float32, cell_cap: int = 24,
               k_inner: int = 48, k_contact: int = 32):
    bw = 4 * dx
    adaptation = SPHAdaptation(spacing=dx, dim=2)

    # boxes centered at the origin (2d_square_droplet.cpp:33-42)
    droplet = G.Box(G.Transform(translation=(0.0, 0.0)),
                    halfsize=(LL / 2, LH / 2))
    inner = G.Box(G.Transform(translation=(0.0, 0.0)),
                  halfsize=(DL / 2, DH / 2))
    air_shape = G.make_complex(("add", inner), ("sub", droplet))
    outer = G.Box(G.Transform(translation=(0.0, 0.0)),
                  halfsize=(DL / 2 + bw, DH / 2 + bw))
    wall_shape = G.make_complex(("add", outer), ("sub", inner))

    dom_lo = (-DL / 2 - bw, -DH / 2 - bw)
    dom_hi = (DL / 2 + bw, DH / 2 + bw)
    pos_w, vol = generate_lattice(droplet, dom_lo, dom_hi, dx)
    pos_a, _ = generate_lattice(air_shape, dom_lo, dom_hi, dx)
    pos_b, _ = generate_lattice(wall_shape, dom_lo, dom_hi, dx)

    water = make_fluid_state(pos_w, vol, RHO0_F, dtype=dtype)
    air = make_fluid_state(pos_a, vol, RHO0_A, dtype=dtype)
    for st_state in (water, air):      # pre-register surface-tension fields
        n = st_state["Position"].shape[0]
        st_state["ColorGradient"] = jnp.zeros((n, 2), dtype)
        st_state["NormDirection"] = jnp.zeros((n, 2), dtype)
        st_state["SurfaceTensionStress"] = jnp.zeros((n, 2, 2), dtype)
        st_state["SurfaceTensionForce"] = jnp.zeros((n, 2), dtype)
        st_state["SurfaceTensionForcePrev"] = jnp.zeros((n, 2), dtype)
        st_state["ViscousForce"] = jnp.zeros((n, 2), dtype)
        st_state["ViscousForcePrev"] = jnp.zeros((n, 2), dtype)
    wall = make_solid_state(pos_b, vol, RHO0_F, dtype=dtype)
    wall = gd.normal_direction_from_shape(wall, wall_shape)

    eos_w = WeaklyCompressibleFluid(rho0=RHO0_F, c0=C_F)
    eos_a = WeaklyCompressibleFluid(rho0=RHO0_A, c0=C_F)

    grid = grid_from_bounds(dom_lo, dom_hi, adaptation.cutoff)
    wall_table = jax.jit(partial(build_cell_table, grid=grid, cap=cell_cap))(
        wall["Position"], wall["NReal"])

    case = DropletCase(
        dx=dx, adaptation=adaptation, grid=grid, eos_w=eos_w, eos_a=eos_a,
        rs_w=rs.acoustic_riemann(eos_w), rs_a=rs.acoustic_riemann(eos_a),
        rs_wa=rs.acoustic_riemann(eos_w, eos_a),
        rs_aw=rs.acoustic_riemann(eos_a, eos_w), wall=wall,
        wall_table=wall_table, n_water=len(pos_w), n_air=len(pos_a),
        cell_cap=cell_cap, k_inner=k_inner, k_contact=k_contact)
    return case, water, air


def rebuild(case: DropletCase, water: State, air: State):
    cutoff = case.adaptation.cutoff
    nl = partial(build_neighbor_list, grid=case.grid, cutoff=cutoff)
    tw = build_cell_table(water["Position"], water["NReal"], case.grid,
                          cap=case.cell_cap)
    ta = build_cell_table(air["Position"], air["NReal"], case.grid,
                          cap=case.cell_cap)
    nl_ww = nl(water["Position"], water["NReal"], water["Position"],
               water["NReal"], tw, k_max=case.k_inner, include_self=False)
    nl_wa = nl(water["Position"], water["NReal"], air["Position"],
               air["NReal"], ta, k_max=case.k_contact, include_self=True)
    nl_wb = nl(water["Position"], water["NReal"], case.wall["Position"],
               case.wall["NReal"], case.wall_table, k_max=case.k_contact,
               include_self=True)
    nl_aa = nl(air["Position"], air["NReal"], air["Position"], air["NReal"],
               ta, k_max=case.k_inner, include_self=False)
    nl_aw = nl(air["Position"], air["NReal"], water["Position"],
               water["NReal"], tw, k_max=case.k_contact, include_self=True)
    nl_ab = nl(air["Position"], air["NReal"], case.wall["Position"],
               case.wall["NReal"], case.wall_table, k_max=case.k_contact,
               include_self=True)
    ovf = (nl_ww.overflow | nl_wa.overflow | nl_wb.overflow | nl_aa.overflow
           | nl_aw.overflow | nl_ab.overflow)
    return nl_ww, nl_wa, nl_wb, nl_aa, nl_aw, nl_ab, ovf


def init_sim(case: DropletCase, water: State, air: State) -> SimState:
    nls = jax.jit(partial(rebuild, case))(water, air)
    dtype = water["Position"].dtype
    return SimState(water, air, *nls[:-1], time=jnp.zeros((), dtype),
                    n_adv=jnp.zeros((), jnp.int32), overflow=nls[-1])


def _advection_step(case: DropletCase, s: SimState) -> SimState:
    kernel, dim = case.kernel, 2
    h = case.adaptation.h
    sigma0 = case.adaptation.sigma0
    water, air = s.water, s.air

    # AdvectionViscousTimeStep(U_ref, 0.1) for both phases
    dt_adv = jnp.minimum(
        fd.advection_viscous_time_step(water, h, U_REF, RHO0_F, MU_F, cfl=0.1),
        fd.advection_viscous_time_step(air, h, U_REF, RHO0_A, MU_A, cfl=0.1))

    water = fd.density_summation(
        water, s.nl_ww, kernel, dim, RHO0_F, sigma0,
        contacts=[(air, s.nl_wa, RHO0_A), (case.wall, s.nl_wb, RHO0_F)],
        free_surface=False)
    air = fd.density_summation(
        air, s.nl_aa, kernel, dim, RHO0_A, sigma0,
        contacts=[(water, s.nl_aw, RHO0_F), (case.wall, s.nl_ab, RHO0_F)],
        free_surface=False)
    water = fd.transport_velocity_correction(
        water, s.nl_ww, kernel, dim, h,
        walls=[(air, s.nl_wa), (case.wall, s.nl_wb)])
    air = fd.transport_velocity_correction(
        air, s.nl_aa, kernel, dim, h,
        walls=[(water, s.nl_aw), (case.wall, s.nl_ab)])

    water = fd.viscous_force(water, s.nl_ww, kernel, dim, MU_F, h,
                             walls=[(case.wall, s.nl_wb)],
                             contacts=[(air, s.nl_wa, MU_WA)])
    air = fd.viscous_force(air, s.nl_aa, kernel, dim, MU_A, h,
                           walls=[(case.wall, s.nl_ab)],
                           contacts=[(water, s.nl_aw, MU_WA)])

    def ac_cond(carry):
        _, _, rt = carry
        return rt < dt_adv

    def ac_body(carry):
        w, a, rt = carry
        # surface tension stress + force EVERY substep
        # (2d_square_droplet.cpp:221-227)
        w = st.surface_tension_stress(w, [(a, s.nl_wa, FRAC_W)], kernel, dim,
                                      SIGMA)
        a = st.surface_tension_stress(a, [(w, s.nl_aw, FRAC_A)], kernel, dim,
                                      SIGMA)
        w = st.surface_stress_force(w, s.nl_ww, [(a, s.nl_wa, FRAC_W)],
                                    kernel, dim, SIGMA)
        a = st.surface_stress_force(a, s.nl_aa, [(w, s.nl_aw, FRAC_A)],
                                    kernel, dim, SIGMA)

        dt = jnp.minimum(jnp.minimum(
            st.surface_tension_time_step(w, case.eos_w, h, RHO0_F, SIGMA),
            st.surface_tension_time_step(a, case.eos_a, h, RHO0_A, SIGMA)),
            dt_adv)
        walls_w = [(case.wall, s.nl_wb)]
        walls_a = [(case.wall, s.nl_ab)]
        w1 = fd.acoustic_step_1st_half(w, s.nl_ww, kernel, dim, case.eos_w,
                                       case.rs_w, dt, walls=walls_w,
                                       contacts=[(a, s.nl_wa, case.rs_wa)])
        a1 = fd.acoustic_step_1st_half(a, s.nl_aa, kernel, dim, case.eos_a,
                                       case.rs_a, dt, walls=walls_a,
                                       contacts=[(w, s.nl_aw, case.rs_aw)])
        w2 = fd.acoustic_step_2nd_half(w1, s.nl_ww, kernel, dim, case.rs_w,
                                       dt, walls=walls_w,
                                       contacts=[(a1, s.nl_wa, case.rs_wa)])
        a2 = fd.acoustic_step_2nd_half(a1, s.nl_aa, kernel, dim, case.rs_a,
                                       dt, walls=walls_a,
                                       contacts=[(w1, s.nl_aw, case.rs_aw)])
        return (w2, a2, rt + dt)

    water, air, relax_t = jax.lax.while_loop(
        ac_cond, ac_body, (water, air, jnp.zeros_like(dt_adv)))

    nls = rebuild(case, water, air)
    return SimState(water, air, *nls[:-1], time=s.time + relax_t,
                    n_adv=s.n_adv + 1, overflow=s.overflow | nls[-1])


def make_run_chunk(case: DropletCase):
    @jax.jit
    def run_chunk(s: SimState, t_target) -> SimState:
        return jax.lax.while_loop(lambda st_: st_.time < t_target,
                                  lambda st_: _advection_step(case, st_), s)

    return run_chunk


def water_kinetic_energy(s: SimState) -> float:
    """WaterBody TotalKineticEnergy (the regression-DB quantity)."""
    w = s.water
    n = w["Position"].shape[0]
    valid = jnp.arange(n) < w["NReal"]
    ke = 0.5 * w["Mass"] * jnp.sum(w["Velocity"] ** 2, axis=-1)
    return float(jnp.sum(jnp.where(valid, ke, 0.0)))


def water_max_radius(s: SimState) -> float:
    """Largest droplet-particle distance from the origin — decreases from
    the square's corner radius ~0.687 toward the equal-area circle 0.564
    as surface tension rounds the droplet."""
    w = s.water
    n = w["Position"].shape[0]
    valid = jnp.arange(n) < w["NReal"]
    r = jnp.linalg.norm(w["Position"], axis=-1)
    return float(jnp.max(jnp.where(valid, r, 0.0)))
