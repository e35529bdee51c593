"""2D lid-driven cavity with a generalized-Newtonian (shear-thinning) fluid.

Counterpart of /root/reference/tests/2d_examples/
test_2d_lid_driven_cavity_non_newtonian/lid_driven_cavity.cpp: a unit
cavity of Herschel-Bulkley fluid (K=1, n=0.5, tau_y=0 by default) driven
by a moving lid.  Per advection step: density summation, velocity
gradient -> shear-rate-dependent "VariableViscosity", non-Newtonian
viscous force, transport-velocity correction; then the dual-criteria
acoustic loop.  The advection step uses min(advection, SRD-viscous) dt
as the reference does (lid_driven_cavity.cpp:210-213).
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
from sphinxsys_jax.physics import viscosity as vc

L = 1.0            # cavity width/height
RHO0 = 1000.0
U_LID = 1.0
C_F = 10.0 * U_LID


class SimState(NamedTuple):
    fluid: Any
    nl_inner: Any
    nl_fw: Any
    time: jnp.ndarray
    n_adv: jnp.ndarray
    overflow: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class CavityCase:
    dx: float
    adaptation: SPHAdaptation
    grid: Any
    eos: WeaklyCompressibleFluid
    riemann: rs.AcousticRiemannSolver
    model: Any               # generalized-Newtonian viscosity model
    wall: State
    wall_table: Any
    n_fluid: int
    cell_cap: int
    k_inner: int
    k_contact: int

    @property
    def kernel(self):
        return self.adaptation.kernel


def build_case(dx: float = 0.02, model=None, dtype=jnp.float32,
               cell_cap: int = 24, k_inner: int = 64, k_contact: int = 40):
    if model is None:
        # reference defaults (lid_driven_cavity.cpp:16-22)
        model = vc.HerschelBulkleyViscosity(
            min_shear_rate=1e-2, max_shear_rate=1e3,
            consistency_index=1.0, power_index=0.5, yield_stress=0.0)
    bw = 4 * dx
    adaptation = SPHAdaptation(spacing=dx, dim=2)

    water_shape = G.Box(G.Transform(translation=(L / 2, L / 2)),
                        halfsize=(L / 2, L / 2))
    outer = G.Box(G.Transform(translation=(L / 2, L / 2)),
                  halfsize=(L / 2 + bw, L / 2 + bw))
    wall_shape = G.make_complex(("add", outer), ("sub", water_shape))

    dom_lo, dom_hi = (-bw, -bw), (L + bw, L + bw)
    pos_f, vol = generate_lattice(water_shape, dom_lo, dom_hi, dx)
    pos_w, _ = generate_lattice(wall_shape, dom_lo, dom_hi, dx)

    fluid = dict(make_fluid_state(pos_f, vol, RHO0, dtype=dtype))
    # pre-register the variables the non-Newtonian ops add, so the
    # while_loop carry structure is stable
    n = len(pos_f)
    fluid["VariableViscosity"] = jnp.zeros((n,), dtype)
    fluid["VelocityGradient"] = jnp.zeros((n, 2, 2), dtype)
    fluid["ViscousForce"] = jnp.zeros((n, 2), dtype)
    fluid["ViscousForcePrev"] = jnp.zeros((n, 2), dtype)
    eos = WeaklyCompressibleFluid(rho0=RHO0, c0=C_F)

    wall = dict(make_solid_state(pos_w, vol, RHO0, dtype=dtype))
    wall = gd.normal_direction_from_shape(wall, wall_shape)
    # the lid: every wall particle above the cavity moves with the lid
    # (Lid_Boundary box + BoundaryVelocity, lid_driven_cavity.cpp:37-47,73-85)
    lid = wall["Position"][:, 1] > L
    lid_vel = jnp.where(lid[:, None],
                        jnp.asarray([U_LID, 0.0], dtype), 0.0)
    wall["Velocity"] = lid_vel
    wall["AverageVelocity"] = lid_vel

    grid = grid_from_bounds(dom_lo, dom_hi, adaptation.cutoff)
    wall_table = jax.jit(partial(build_cell_table, grid=grid, cap=cell_cap))(
        wall["Position"], wall["NReal"])

    case = CavityCase(dx=dx, adaptation=adaptation, grid=grid, eos=eos,
                      riemann=rs.acoustic_riemann(eos), model=model,
                      wall=wall, wall_table=wall_table, n_fluid=len(pos_f),
                      cell_cap=cell_cap, k_inner=k_inner, k_contact=k_contact)
    return case, fluid


def rebuild(case: CavityCase, fluid: State):
    pos, n_f = fluid["Position"], fluid["NReal"]
    cutoff = case.adaptation.cutoff
    table_f = build_cell_table(pos, n_f, case.grid, cap=case.cell_cap)
    nl_inner = build_neighbor_list(pos, n_f, pos, n_f, table_f, case.grid,
                                   cutoff, k_max=case.k_inner,
                                   include_self=False)
    nl_fw = build_neighbor_list(pos, n_f, case.wall["Position"],
                                case.wall["NReal"], case.wall_table,
                                case.grid, cutoff, k_max=case.k_contact,
                                include_self=True)
    return nl_inner, nl_fw, nl_inner.overflow | nl_fw.overflow


def init_sim(case: CavityCase, fluid: State) -> SimState:
    nl_inner, nl_fw, ovf = jax.jit(partial(rebuild, case))(fluid)
    dtype = fluid["Position"].dtype
    return SimState(fluid=fluid, nl_inner=nl_inner, nl_fw=nl_fw,
                    time=jnp.zeros((), dtype),
                    n_adv=jnp.zeros((), jnp.int32), overflow=ovf)


def _advection_step(case: CavityCase, s: SimState) -> SimState:
    kernel, dim = case.kernel, 2
    h = case.adaptation.h
    sigma0 = case.adaptation.sigma0
    fluid = s.fluid
    walls = [(case.wall, s.nl_fw)]

    # confined flow: no free surface in the summation
    fluid = fd.density_summation(fluid, s.nl_inner, kernel, dim, RHO0, sigma0,
                                 contacts=[(case.wall, s.nl_fw, RHO0)],
                                 free_surface=False)
    fluid = vc.update_variable_viscosity(fluid, s.nl_inner, kernel, dim,
                                         case.model)
    dt_adv = jnp.minimum(fd.advection_time_step(fluid, h, U_LID),
                         vc.srd_viscous_time_step(fluid, h))
    fluid = vc.viscous_force_variable(fluid, s.nl_inner, kernel, dim, h,
                                      walls=walls)
    fluid = fd.transport_velocity_correction(fluid, s.nl_inner, kernel, dim,
                                             h, walls=walls)

    def ac_cond(carry):
        _, rt = carry
        return rt < dt_adv

    def ac_body(carry):
        f, rt = carry
        dt = jnp.minimum(fd.acoustic_time_step(f, case.eos, h), dt_adv)
        f = fd.acoustic_step_1st_half(f, s.nl_inner, kernel, dim, case.eos,
                                      case.riemann, dt, walls=walls)
        f = fd.acoustic_step_2nd_half(f, s.nl_inner, kernel, dim,
                                      case.riemann, dt, walls=walls)
        return (f, rt + dt)

    fluid, relax_t = jax.lax.while_loop(
        ac_cond, ac_body, (fluid, jnp.zeros_like(dt_adv)))

    nl_inner, nl_fw, ovf = rebuild(case, fluid)
    return SimState(fluid=fluid, nl_inner=nl_inner, nl_fw=nl_fw,
                    time=s.time + relax_t, n_adv=s.n_adv + 1,
                    overflow=s.overflow | ovf)


def make_run_chunk(case: CavityCase):
    @jax.jit
    def run_chunk(s: SimState, t_target) -> SimState:
        return jax.lax.while_loop(lambda st: st.time < t_target,
                                  lambda st: _advection_step(case, st), s)

    return run_chunk
