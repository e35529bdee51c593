"""2D two-phase (air-water) dambreak.

Counterpart of /root/reference/tests/2d_examples/test_2d_two_phase_dambreak/
two_phase_dambreak.{h,cpp}: water column (rho=1) collapses under a
1000x-lighter air phase filling the rest of a 5.3 x 2 tank, both phases
weakly compressible with the same numerical sound speed (c = 20):

  * water: free-surface density summation with WALL contact only; MultiPhase
    pressure/density relaxation with the air phase as a fluid-fluid contact
  * air: plain density summation with water+wall contacts, multi-phase
    transport-velocity correction (light phases need it), same relaxations
  * both phases advance on a SHARED advection/acoustic step (the min of the
    two criteria) so one jitted loop integrates the pair — simpler and
    XLA-friendlier than the reference's per-phase interleaving, identical
    physics at the shared (smaller) dt.
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

# two_phase_dambreak.h:11-28
DL = 5.3
DH = 2.0
LL = 2.0
LH = 1.0
RHO0_F = 1.0
RHO0_A = 0.001
GRAVITY_G = 1.0
U_REF = 2.0 * math.sqrt(GRAVITY_G * LH)
C_F = 10.0 * U_REF


class SimState(NamedTuple):
    water: Any
    air: Any
    nl_ww: Any    # water-water
    nl_wa: Any    # water-air
    nl_wb: Any    # water-wall
    nl_aa: Any
    nl_aw: Any    # air-water
    nl_ab: Any    # air-wall
    time: jnp.ndarray
    n_adv: jnp.ndarray
    overflow: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class TwoPhaseCase:
    dx: float
    adaptation: SPHAdaptation
    grid: Any
    eos_w: WeaklyCompressibleFluid
    eos_a: WeaklyCompressibleFluid
    rs_w: rs.AcousticRiemannSolver      # water inner
    rs_a: rs.AcousticRiemannSolver      # air inner
    rs_wa: rs.AcousticRiemannSolver     # cross-phase, water-side (water, air)
    rs_aw: rs.AcousticRiemannSolver     # cross-phase, air-side (air, water)
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


def build_case(dx: float = 0.05, dtype=jnp.float32, cell_cap: int = 24,
               k_inner: int = 64, k_contact: int = 48):
    bw = 4 * dx
    adaptation = SPHAdaptation(spacing=dx, dim=2)

    water_shape = G.Box(G.Transform(translation=(LL / 2, LH / 2)),
                        halfsize=(LL / 2, LH / 2))
    tank = G.Box(G.Transform(translation=(DL / 2, DH / 2)),
                 halfsize=(DL / 2, DH / 2))
    air_shape = G.make_complex(("add", tank), ("sub", water_shape))
    outer = G.Box(G.Transform(translation=(DL / 2, DH / 2)),
                  halfsize=(DL / 2 + bw, DH / 2 + bw))
    wall_shape = G.make_complex(("add", outer), ("sub", tank))

    dom_lo, dom_hi = (-bw, -bw), (DL + bw, DH + bw)
    pos_w, vol = generate_lattice(water_shape, dom_lo, dom_hi, dx)
    pos_a, _ = generate_lattice(air_shape, dom_lo, dom_hi, dx)
    pos_b, _ = generate_lattice(wall_shape, dom_lo, dom_hi, dx)

    water = make_fluid_state(pos_w, vol, RHO0_F, dtype=dtype)
    air = make_fluid_state(pos_a, vol, RHO0_A, dtype=dtype)
    wall = make_solid_state(pos_b, vol, RHO0_F, dtype=dtype)
    wall = gd.normal_direction_from_shape(wall, wall_shape)

    eos_w = WeaklyCompressibleFluid(rho0=RHO0_F, c0=C_F)
    eos_a = WeaklyCompressibleFluid(rho0=RHO0_A, c0=C_F)
    gravity = gd.Gravity(acceleration=(0.0, -GRAVITY_G))
    water = gd.gravity_force(water, gravity)
    air = gd.gravity_force(air, gravity)

    grid = grid_from_bounds(dom_lo, dom_hi, adaptation.cutoff)
    wall_table = jax.jit(partial(build_cell_table, grid=grid, cap=cell_cap))(
        wall["Position"], wall["NReal"])

    case = TwoPhaseCase(
        dx=dx, adaptation=adaptation, grid=grid, eos_w=eos_w, eos_a=eos_a,
        rs_w=rs.acoustic_riemann(eos_w), rs_a=rs.acoustic_riemann(eos_a),
        rs_wa=rs.acoustic_riemann(eos_w, eos_a),
        rs_aw=rs.acoustic_riemann(eos_a, eos_w), wall=wall,
        wall_table=wall_table, n_water=len(pos_w), n_air=len(pos_a),
        cell_cap=cell_cap, k_inner=k_inner, k_contact=k_contact)
    return case, water, air


def rebuild(case: TwoPhaseCase, water: State, air: State):
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


def init_sim(case: TwoPhaseCase, water: State, air: State) -> SimState:
    nls = jax.jit(partial(rebuild, case))(water, air)
    dtype = water["Position"].dtype
    return SimState(water, air, *nls[:-1], time=jnp.zeros((), dtype),
                    n_adv=jnp.zeros((), jnp.int32), overflow=nls[-1])


def _advection_step(case: TwoPhaseCase, s: SimState) -> SimState:
    kernel, dim = case.kernel, 2
    h = case.adaptation.h
    sigma0 = case.adaptation.sigma0
    water, air = s.water, s.air

    dt_adv = jnp.minimum(fd.advection_time_step(water, h, U_REF),
                         fd.advection_time_step(air, h, U_REF))
    # water: free-surface summation with wall only (DensitySummationComplex
    # FreeSurface, two_phase_dambreak.cpp:78); air: plain with water+wall
    water = fd.density_summation(
        water, s.nl_ww, kernel, dim, RHO0_F, sigma0,
        contacts=[(case.wall, s.nl_wb, RHO0_F)], free_surface=True)
    # contact rho0 is the CONTACT body's reference density (its Mass/rho0
    # is the rest volume, density_summation.cpp:58-69) — the wall state was
    # built with rho = RHO0_F
    air = fd.density_summation(
        air, s.nl_aa, kernel, dim, RHO0_A, sigma0,
        contacts=[(water, s.nl_aw, RHO0_F), (case.wall, s.nl_ab, RHO0_F)],
        free_surface=False)
    # MultiPhaseTransportVelocityCorrectionComplex: the correction integral
    # includes the heavy phase and the wall (both enter only through the
    # kernel-gradient volume integral)
    air = fd.transport_velocity_correction(air, s.nl_aa, kernel, dim, h,
                                           walls=[(water, s.nl_aw),
                                                  (case.wall, s.nl_ab)])

    def ac_cond(carry):
        _, _, rt = carry
        return rt < dt_adv

    def ac_body(carry):
        w, a, rt = carry
        dt = jnp.minimum(jnp.minimum(fd.acoustic_time_step(w, case.eos_w, h),
                                     fd.acoustic_time_step(a, case.eos_a, h)),
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


def make_run_chunk(case: TwoPhaseCase):
    @jax.jit
    def run_chunk(s: SimState, t_target) -> SimState:
        return jax.lax.while_loop(lambda st: st.time < t_target,
                                  lambda st: _advection_step(case, st), s)

    return run_chunk
