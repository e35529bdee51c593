"""2D still floating body (STFB): a free rigid structure at its
equilibrium draft.

Counterpart of /root/reference/tests/2d_examples/test_2d_stfb/stfb.{h,cpp}
(author Nicolò Salis): a 1 x 1 rigid structure of mass 700 (rho_s = 700)
floats in the 3 x 2 still-water tank of cases/stlw_2d.py, placed at its
Archimedes equilibrium (com at (0, -0.2): draft = rho_s/rho_f L = 0.7).
The reference couples through a Simbody Planar mobilizer; here the native
3-DOF planar rigid solver (physics/rigid.py) plays that role with the
SAME mass properties (mass 700, Iz = m/12 (L^2 + L^2), stfb.h:42-55).

Protocol (stfb.cpp:195-258): the structure is FROZEN for the first 1 s of
simulation while the fluid settles (relax_time; only then does the
physical clock start); after release it receives pressure + viscous
forces from the fluid and gravity through the rigid solver.  Observables
(committed reference DBs): Observer_Position — the material point at the
initial com, which for a rigid body is exactly the rigid com — and the
FreeSurfaceGauge at x = 1.0.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from sphinxsys_jax.core import geometry as G
from sphinxsys_jax.core.adaptation import SPHAdaptation
from sphinxsys_jax.core.generators import generate_lattice
from sphinxsys_jax.core.materials import WeaklyCompressibleFluid
from sphinxsys_jax.core.state import State, make_fluid_state, make_solid_state
from sphinxsys_jax.neighbors import (build_cell_table, build_neighbor_list,
                                     grid_from_bounds)
from sphinxsys_jax.physics import fluid as fd
from sphinxsys_jax.physics import fsi
from sphinxsys_jax.physics import general as gd
from sphinxsys_jax.physics import riemann as rs
from sphinxsys_jax.physics import rigid as rg

# stfb.h:12-56
DL = 3.0
DH = 4.0
WH = 2.0
L = 1.0
RHO0_F = 1000.0
GRAVITY_G = 9.81
U_F = 2.0 * math.sqrt(0.79 * GRAVITY_G)
C_F = 10.0 * U_F
MU_F = 1.0e-3
STRUCTURE_MASS = 700.0
RHO_S = STRUCTURE_MASS / (L * L)
H_COM = -(RHO_S / RHO0_F * L - L / 2)       # -0.2: equilibrium com height
IZ = STRUCTURE_MASS / 12.0 * (L * L + L * L)
X_GAUGE = DL / 3.0
RELAX_TIME = 1.0                            # structure frozen until then


class SimState(NamedTuple):
    fluid: Any
    block: Any
    rb: rg.RigidBody2D
    nl_inner: Any
    nl_fw: Any
    nl_fb: Any
    nl_bf: Any
    time: jnp.ndarray
    n_adv: jnp.ndarray
    overflow: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class StfbCase:
    dx: float
    adaptation: SPHAdaptation
    grid: Any
    eos: WeaklyCompressibleFluid
    riemann: rs.AcousticRiemannSolver
    gravity: gd.Gravity
    wall: State
    wall_table: Any
    block0: State
    rb0: rg.RigidBody2D
    n_fluid: int
    n_block: int
    cell_cap: int
    k_inner: int
    k_contact: int

    @property
    def kernel(self):
        return self.adaptation.kernel


def build_case(dx: float = L / 20.0, dtype=jnp.float32, cell_cap: int = 24,
               k_inner: int = 64, k_contact: int = 40):
    bw = 4 * dx
    adaptation = SPHAdaptation(spacing=dx, dim=2)

    structure_shape = G.Box(G.Transform(translation=(0.0, H_COM)),
                            halfsize=(L / 2, L / 2))
    water_box = G.Box(G.Transform(translation=(0.0, -WH / 2)),
                      halfsize=(DL / 2, WH / 2))
    water_shape = G.make_complex(("add", water_box), ("sub", structure_shape))
    outer = G.Box(G.Transform(translation=(0.0, 0.0)),
                  halfsize=(DL / 2 + bw, DH / 2 + bw))
    inner = G.Box(G.Transform(translation=(0.0, 0.0)),
                  halfsize=(DL / 2, DH / 2))
    wall_shape = G.make_complex(("add", outer), ("sub", inner))

    dom_lo = (-DL / 2 - bw, -DH / 2 - bw)
    dom_hi = (DL / 2 + bw, DH / 2 + bw)
    pos_f, vol = generate_lattice(water_shape, dom_lo, dom_hi, dx)
    pos_w, _ = generate_lattice(wall_shape, dom_lo, dom_hi, dx)
    pos_b, _ = generate_lattice(structure_shape, dom_lo, dom_hi, dx)

    fluid = dict(make_fluid_state(pos_f, vol, RHO0_F, dtype=dtype))
    eos = WeaklyCompressibleFluid(rho0=RHO0_F, c0=C_F)
    p_hydro = RHO0_F * GRAVITY_G * (0.0 - np.asarray(pos_f)[:, 1])
    p_hydro = np.maximum(p_hydro, 0.0)
    fluid["Density"] = jnp.asarray(
        np.asarray(eos.density_from_pressure(jnp.asarray(p_hydro))), dtype)
    fluid["Pressure"] = jnp.asarray(p_hydro, dtype)

    wall = make_solid_state(pos_w, vol, RHO0_F, dtype=dtype)
    wall = gd.normal_direction_from_shape(wall, wall_shape)

    block = dict(make_solid_state(pos_b, vol, RHO_S, dtype=dtype))
    block = gd.normal_direction_from_shape(block, structure_shape)
    block["InitialPosition"] = block["Position"]
    for key in ("PressureForceFromFluid", "ViscousForceFromFluid"):
        block[key] = jnp.zeros_like(block["Position"])
        block["Previous" + key] = jnp.zeros_like(block["Position"])
    block["ForcePrior"] = jnp.zeros_like(block["Position"])
    block["Force"] = jnp.zeros_like(block["Position"])
    block["AverageAcceleration"] = jnp.zeros_like(block["Position"])

    mask = jnp.ones((len(pos_b),), bool)
    rb0 = rg.rigid_body_from_particles(block, mask)
    # impose the reference's exact Simbody mass properties (stfb.h:42-55)
    rb0 = rb0._replace(mass=jnp.asarray(STRUCTURE_MASS, dtype),
                       inertia=jnp.asarray(IZ, dtype))

    gravity = gd.Gravity(acceleration=(0.0, -GRAVITY_G))
    fluid = gd.gravity_force(fluid, gravity)
    n = fluid["Position"].shape[0]
    fluid["ViscousForce"] = jnp.zeros((n, 2), dtype)
    fluid["ViscousForcePrev"] = jnp.zeros((n, 2), dtype)
    # opt into gravity_force's BaseForcePrior delta form (coexists with
    # the viscous prior force; see physics/general.py gravity_force)
    fluid["GravityForcePrev"] = jnp.zeros((n, 2), dtype)

    grid = grid_from_bounds(dom_lo, dom_hi, adaptation.cutoff)
    wall_table = jax.jit(partial(build_cell_table, grid=grid, cap=cell_cap))(
        wall["Position"], wall["NReal"])

    case = StfbCase(dx=dx, adaptation=adaptation, grid=grid, eos=eos,
                    riemann=rs.acoustic_riemann(eos), gravity=gravity,
                    wall=wall, wall_table=wall_table, block0=block, rb0=rb0,
                    n_fluid=len(pos_f), n_block=len(pos_b),
                    cell_cap=cell_cap, k_inner=k_inner, k_contact=k_contact)
    return case, fluid


def rebuild(case: StfbCase, fluid: State, block: State):
    pos = fluid["Position"]
    n_f, n_b = fluid["NReal"], block["NReal"]
    cutoff = case.adaptation.cutoff
    table_f = build_cell_table(pos, n_f, case.grid, cap=case.cell_cap)
    table_b = build_cell_table(block["Position"], n_b, case.grid,
                               cap=case.cell_cap)
    nl_inner = build_neighbor_list(pos, n_f, pos, n_f, table_f, case.grid,
                                   cutoff, k_max=case.k_inner,
                                   include_self=False)
    nl_fw = build_neighbor_list(pos, n_f, case.wall["Position"],
                                case.wall["NReal"], case.wall_table,
                                case.grid, cutoff, k_max=case.k_contact,
                                include_self=True)
    nl_fb = build_neighbor_list(pos, n_f, block["Position"], n_b, table_b,
                                case.grid, cutoff, k_max=case.k_contact,
                                include_self=True)
    nl_bf = build_neighbor_list(block["Position"], n_b, pos, n_f, table_f,
                                case.grid, cutoff, k_max=case.k_contact,
                                include_self=True)
    ovf = nl_inner.overflow | nl_fw.overflow | nl_fb.overflow | nl_bf.overflow
    return nl_inner, nl_fw, nl_fb, nl_bf, ovf


def init_sim(case: StfbCase, fluid: State,
             settle_time: float = RELAX_TIME) -> SimState:
    """Build relations and run the reference's frozen-structure settling
    window (stfb.cpp relax_time); returns the state at physical t = 0
    (the moment of release)."""
    block = case.block0
    nls = jax.jit(partial(rebuild, case))(fluid, block)
    dtype = fluid["Position"].dtype
    s = SimState(fluid=fluid, block=block, rb=case.rb0,
                 nl_inner=nls[0], nl_fw=nls[1], nl_fb=nls[2], nl_bf=nls[3],
                 time=jnp.zeros((), dtype), n_adv=jnp.zeros((), jnp.int32),
                 overflow=nls[4])
    if settle_time > 0:
        s = settle(case, s, t_relax=settle_time)
    return s


def _advection_step(case: StfbCase, s: SimState, frozen: bool) -> SimState:
    """One dual-criteria step; `frozen` statically selects the settling
    phase (structure held, stfb.cpp:246-252 executes the rigid update only
    once total_time >= relax_time)."""
    kernel, dim = case.kernel, 2
    h = case.adaptation.h
    sigma0 = case.adaptation.sigma0
    fluid, block, rb = s.fluid, s.block, s.rb
    mask_b = jnp.ones((case.n_block,), bool)

    dt_adv = fd.advection_viscous_time_step(fluid, h, U_F, RHO0_F, MU_F)
    fluid = fd.density_summation(
        fluid, s.nl_inner, kernel, dim, RHO0_F, sigma0,
        contacts=[(case.wall, s.nl_fw, RHO0_F), (block, s.nl_fb, RHO0_F)],
        free_surface=True)
    fluid = fd.viscous_force(fluid, s.nl_inner, kernel, dim, MU_F, h,
                             walls=[(case.wall, s.nl_fw), (block, s.nl_fb)])
    block = fsi.viscous_force_from_fluid(block, fluid, s.nl_bf, kernel, dim,
                                         MU_F, h)

    def ac_cond(carry):
        _, _, _, rt = carry
        return rt < dt_adv

    def ac_body(carry):
        f, b, r, rt = carry
        dt = jnp.minimum(fd.acoustic_time_step(f, case.eos, h), dt_adv)
        walls = [(case.wall, s.nl_fw), (b, s.nl_fb)]
        f = fd.acoustic_step_1st_half(f, s.nl_inner, kernel, dim, case.eos,
                                      case.riemann, dt, walls=walls)
        b = fsi.pressure_force_from_fluid(b, f, s.nl_bf, kernel, dim,
                                          case.riemann)
        if not frozen:
            force, torque = rg.total_force_and_torque(b, mask_b, r,
                                                      force_keys=("ForcePrior",))
            r_new = rg.rigid_step(r, force, torque, dt,
                                  gravity=(0.0, -GRAVITY_G))
            b = rg.constrain_by_rigid_body(b, mask_b, r_new,
                                           case.block0["InitialPosition"],
                                           case.rb0.com)
            acc = (r_new.vel - r.vel) / (dt + 1e-15)
            b = dict(b)
            b["AverageAcceleration"] = jnp.broadcast_to(acc,
                                                        b["Position"].shape)
        else:
            r_new = r
        f = fd.acoustic_step_2nd_half(f, s.nl_inner, kernel, dim,
                                      case.riemann, dt,
                                      walls=[(case.wall, s.nl_fw),
                                             (b, s.nl_fb)])
        return (f, b, r_new, rt + dt)

    fluid, block, rb, relax_t = jax.lax.while_loop(
        ac_cond, ac_body, (fluid, block, rb, jnp.zeros_like(dt_adv)))

    nls = rebuild(case, fluid, block)
    return SimState(fluid=fluid, block=block, rb=rb,
                    nl_inner=nls[0], nl_fw=nls[1], nl_fb=nls[2], nl_bf=nls[3],
                    time=s.time + relax_t, n_adv=s.n_adv + 1,
                    overflow=s.overflow | nls[4])


def make_run_chunk(case: StfbCase, frozen: bool = False):
    @jax.jit
    def run_chunk(s: SimState, t_target) -> SimState:
        return jax.lax.while_loop(
            lambda st: st.time < t_target,
            lambda st: _advection_step(case, st, frozen), s)

    return run_chunk


def settle(case: StfbCase, s: SimState, t_relax: float = RELAX_TIME):
    """The reference's relax window: fluid settles around the held
    structure; afterwards the clock is rezeroed (physical_time starts
    at release, stfb.cpp:219-224)."""
    run_frozen = make_run_chunk(case, frozen=True)
    s = run_frozen(s, jnp.asarray(t_relax, s.time.dtype))
    return s._replace(time=jnp.zeros_like(s.time))


def free_surface_height(case, fluid: State, x_gauge: float = X_GAUGE):
    """FreeSurfaceGauge (stfb.h:99-103 + UpperFrontInAxisDirection)."""
    hw = 1.3 * case.dx
    pos = fluid["Position"]
    n = fluid["NReal"]
    valid = jnp.arange(pos.shape[0]) < n
    in_col = valid & (jnp.abs(pos[:, 0] - x_gauge) <= hw)
    return jnp.max(jnp.where(in_col, pos[:, 1], -jnp.inf))
