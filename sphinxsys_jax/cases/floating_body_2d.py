"""2D floating rigid body — Archimedes validation of the rigid coupling.

The native counterpart of the reference's Simbody-coupled cases (e.g.
tests/3d_examples/test_3d_stfb / 2d floating bodies): a rigid block of
half the water density floats in a tank; after the transient it must
settle at a draft of half its height (Archimedes).

Coupling loop (the constraint pattern of constraint_dynamics.h:156-184):
  fluid pressure relaxation sees the block as a moving wall-type contact;
  the block receives PressureForceFromFluid; the rigid 3-DOF equations are
  advanced; the rigid transform is imposed back on the block's particles
  (positions, velocities, averaged-wall kinematics).
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
from sphinxsys_jax.neighbors import grid_from_bounds, build_cell_table, build_neighbor_list
from sphinxsys_jax.physics import fluid as fd
from sphinxsys_jax.physics import fsi
from sphinxsys_jax.physics import general as gd
from sphinxsys_jax.physics import riemann as rs
from sphinxsys_jax.physics import rigid as rg

DL = 1.0       # tank width
DH = 0.8       # tank height
WH = 0.5       # water depth
BL, BH = 0.2, 0.1  # block size
RHO0_F = 1.0
RHO_RATIO = 0.5    # block density / water density
GRAVITY_G = 9.81
U_REF = 2.0 * math.sqrt(GRAVITY_G * WH)
C_F = 10.0 * U_REF


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
class FloatingCase:
    dx: float
    adaptation: SPHAdaptation
    grid: Any
    eos: WeaklyCompressibleFluid
    riemann: rs.AcousticRiemannSolver
    gravity: gd.Gravity
    wall: State
    wall_table: Any
    block0: State          # initial block state (positions at t=0)
    rb0: rg.RigidBody2D
    n_fluid: int
    n_block: int
    cell_cap: int
    k_inner: int
    k_contact: int

    @property
    def kernel(self):
        return self.adaptation.kernel


def build_case(dx: float = 0.02, dtype=jnp.float32, cell_cap: int = 24,
               k_inner: int = 64, k_contact: int = 40):
    bw = 4 * dx
    adaptation = SPHAdaptation(spacing=dx, dim=2)
    # block initially floats with its bottom exactly at the surface
    # (draft 0) -> must sink to draft = RHO_RATIO * BH
    block_lo_y = WH
    block_shape = G.Box(G.Transform(translation=(DL / 2, block_lo_y + BH / 2)),
                        halfsize=(BL / 2, BH / 2))
    water_shape = G.Box(G.Transform(translation=(DL / 2, WH / 2)),
                        halfsize=(DL / 2, WH / 2))
    outer = G.Box(G.Transform(translation=(DL / 2, DH / 2)),
                  halfsize=(DL / 2 + bw, DH / 2 + bw))
    inner = G.Box(G.Transform(translation=(DL / 2, DH / 2)),
                  halfsize=(DL / 2, DH / 2))
    wall_shape = G.make_complex(("add", outer), ("sub", inner))

    dom_lo, dom_hi = (-bw, -bw), (DL + bw, DH + bw)
    pos_f, vol = generate_lattice(water_shape, dom_lo, dom_hi, dx)
    pos_w, _ = generate_lattice(wall_shape, dom_lo, dom_hi, dx)
    pos_b, _ = generate_lattice(block_shape, dom_lo, dom_hi, dx)

    fluid = dict(make_fluid_state(pos_f, vol, RHO0_F, dtype=dtype))
    # hydrostatic pre-equilibration: p = rho0 g (WH - y), rho = EoS^-1(p)
    eos = WeaklyCompressibleFluid(rho0=RHO0_F, c0=C_F)
    p_hydro = RHO0_F * GRAVITY_G * (WH - np.asarray(pos_f)[:, 1])
    rho_h = np.asarray(eos.density_from_pressure(jnp.asarray(p_hydro)))
    fluid["Density"] = jnp.asarray(rho_h, dtype)
    fluid["Pressure"] = jnp.asarray(p_hydro, dtype)

    wall = make_solid_state(pos_w, vol, RHO0_F, dtype=dtype)
    wall = gd.normal_direction_from_shape(wall, wall_shape)

    block = dict(make_solid_state(pos_b, vol, RHO_RATIO * RHO0_F, dtype=dtype))
    block = gd.normal_direction_from_shape(block, block_shape)
    block["InitialPosition"] = block["Position"]
    for key in ["PressureForceFromFluid"]:
        block[key] = jnp.zeros_like(block["Position"])
        block["Previous" + key] = jnp.zeros_like(block["Position"])
    block["ForcePrior"] = jnp.zeros_like(block["Position"])
    block["Force"] = jnp.zeros_like(block["Position"])
    block["AverageAcceleration"] = jnp.zeros_like(block["Position"])

    mask = jnp.ones((len(pos_b),), bool)
    rb0 = rg.rigid_body_from_particles(block, mask)

    gravity = gd.Gravity(acceleration=(0.0, -GRAVITY_G))
    fluid = gd.gravity_force(fluid, gravity)

    grid = grid_from_bounds(dom_lo, dom_hi, adaptation.cutoff)
    wall_table = jax.jit(partial(build_cell_table, grid=grid, cap=cell_cap))(
        wall["Position"], wall["NReal"])

    case = FloatingCase(dx=dx, adaptation=adaptation, grid=grid, eos=eos,
                        riemann=rs.acoustic_riemann(eos), gravity=gravity,
                        wall=wall, wall_table=wall_table, block0=block,
                        rb0=rb0, n_fluid=len(pos_f), n_block=len(pos_b),
                        cell_cap=cell_cap, k_inner=k_inner,
                        k_contact=k_contact)
    return case, fluid


def rebuild(case: FloatingCase, fluid: State, block: State):
    pos = fluid["Position"]
    n_f, n_b = fluid["NReal"], block["NReal"]
    cutoff = case.adaptation.cutoff
    table_f = build_cell_table(pos, n_f, case.grid, cap=case.cell_cap)
    table_b = build_cell_table(block["Position"], n_b, case.grid, cap=case.cell_cap)
    nl_inner = build_neighbor_list(pos, n_f, pos, n_f, table_f, case.grid,
                                   cutoff, k_max=case.k_inner, include_self=False)
    nl_fw = build_neighbor_list(pos, n_f, case.wall["Position"],
                                case.wall["NReal"], case.wall_table, case.grid,
                                cutoff, k_max=case.k_contact, include_self=True)
    nl_fb = build_neighbor_list(pos, n_f, block["Position"], n_b, table_b,
                                case.grid, cutoff, k_max=case.k_contact,
                                include_self=True)
    nl_bf = build_neighbor_list(block["Position"], n_b, pos, n_f, table_f,
                                case.grid, cutoff, k_max=case.k_contact,
                                include_self=True)
    ovf = nl_inner.overflow | nl_fw.overflow | nl_fb.overflow | nl_bf.overflow
    return nl_inner, nl_fw, nl_fb, nl_bf, ovf


def init_sim(case: FloatingCase, fluid: State) -> SimState:
    block = case.block0
    nl_inner, nl_fw, nl_fb, nl_bf, ovf = jax.jit(partial(rebuild, case))(fluid, block)
    dtype = fluid["Position"].dtype
    return SimState(fluid=fluid, block=block, rb=case.rb0, nl_inner=nl_inner,
                    nl_fw=nl_fw, nl_fb=nl_fb, nl_bf=nl_bf,
                    time=jnp.zeros((), dtype), n_adv=jnp.zeros((), jnp.int32),
                    overflow=ovf)


def _advection_step(case: FloatingCase, s: SimState) -> SimState:
    kernel, dim = case.kernel, 2
    h = case.adaptation.h
    sigma0 = case.adaptation.sigma0
    fluid, block, rb = s.fluid, s.block, s.rb
    mask_b = jnp.ones((case.n_block,), bool)

    dt_adv = fd.advection_time_step(fluid, h, U_REF)
    fluid = fd.density_summation(
        fluid, s.nl_inner, kernel, dim, RHO0_F, sigma0,
        contacts=[(case.wall, s.nl_fw, RHO0_F), (block, s.nl_fb, RHO0_F)],
        free_surface=True)

    def ac_cond(carry):
        _, _, _, rt = carry
        return rt < dt_adv

    def ac_body(carry):
        f, b, r, rt = carry
        dt = jnp.minimum(fd.acoustic_time_step(f, case.eos, h), dt_adv)
        walls = [(case.wall, s.nl_fw), (b, s.nl_fb)]
        f = fd.acoustic_step_1st_half(f, s.nl_inner, kernel, dim, case.eos,
                                      case.riemann, dt, walls=walls)
        # force on the block from the fluid, then the rigid update
        b = fsi.pressure_force_from_fluid(b, f, s.nl_bf, kernel, dim,
                                          case.riemann)
        force, torque = rg.total_force_and_torque(b, mask_b, r,
                                                  force_keys=("ForcePrior",))
        r_new = rg.rigid_step(r, force, torque, dt,
                              gravity=(0.0, -GRAVITY_G))
        b = rg.constrain_by_rigid_body(b, mask_b, r_new,
                                       case.block0["InitialPosition"],
                                       case.rb0.com)
        acc = (r_new.vel - r.vel) / (dt + 1e-15)
        b = dict(b)
        b["AverageAcceleration"] = jnp.broadcast_to(acc, b["Position"].shape)
        f = fd.acoustic_step_2nd_half(f, s.nl_inner, kernel, dim, case.riemann,
                                      dt, walls=[(case.wall, s.nl_fw), (b, s.nl_fb)])
        return (f, b, r_new, rt + dt)

    fluid, block, rb, relax_t = jax.lax.while_loop(
        ac_cond, ac_body, (fluid, block, rb, jnp.zeros_like(dt_adv)))

    nl_inner, nl_fw, nl_fb, nl_bf, ovf = rebuild(case, fluid, block)
    return SimState(fluid=fluid, block=block, rb=rb, nl_inner=nl_inner,
                    nl_fw=nl_fw, nl_fb=nl_fb, nl_bf=nl_bf,
                    time=s.time + relax_t, n_adv=s.n_adv + 1,
                    overflow=s.overflow | ovf)


def make_run_chunk(case: FloatingCase):
    @jax.jit
    def run_chunk(s: SimState, t_target) -> SimState:
        return jax.lax.while_loop(lambda st: st.time < t_target,
                                  lambda st: _advection_step(case, st), s)

    return run_chunk
