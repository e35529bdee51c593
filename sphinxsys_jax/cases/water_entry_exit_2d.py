"""Water entry (and exit) of a free rigid cylinder with WETTING diffusion.

Mirrors /root/reference/tests/2d_examples/test_2d_water_entry_exit/
test_2d_water_entry_exit.cpp: a light cylinder (rho = 0.5) falls from
above a resting water column, impacts, submerges and rebounds; a wetting
species Phi diffuses from the water (Phi = 1, Dirichlet contact) into
the initially dry cylinder (Phi = 0, isotropic diffusivity 100 dx^2).
The reference couples the cylinder through Simbody with a free PLANAR
mobilizer under uniform gravity — i.e. an unconstrained planar rigid
body — which is exactly the native rigid 3-DOF solver here
(physics/rigid.py), as in the floating-body case.

Observables (committed reference DTW DBs): CylinderObserver Position
(the center trajectory) and WettingObserver Phi (the cylinder's bottom
material point).

Deviation: the reference tags the free surface with the
WettingCoupled...FreeSurfaceIndication variant for its free-stream
density; this case uses the plain free-surface density clamp
(rho >= rho0), the same choice validated on the floating-body and
dambreak cases.
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
from sphinxsys_jax.physics import diffusion as df
from sphinxsys_jax.physics import fluid as fd
from sphinxsys_jax.physics import fsi
from sphinxsys_jax.physics import general as gd
from sphinxsys_jax.physics import riemann as rs
from sphinxsys_jax.physics import rigid as rg

R_CYL = 0.055
DL = 8.0 * R_CYL
DH = 7.0 * R_CYL
LH = 3.0 * R_CYL                   # water depth
CYL_CY = LH + 0.15                 # initial center height
RHO0_F = 1.0
RHO0_S = 0.5
GRAVITY_G = 9.81
U_MAX = 2.0 * math.sqrt(GRAVITY_G * LH)
C_F = 10.0 * U_MAX
MU_F = 8.9e-7


class SimState(NamedTuple):
    fluid: Any
    cyl: Any
    rb: rg.RigidBody2D
    nl_ff: Any
    nl_fw: Any
    nl_fc: Any     # fluid -> cylinder
    nl_cf: Any     # cylinder -> fluid (forces + wetting Dirichlet)
    nl_cc: Any     # cylinder inner (wetting diffusion)
    time: jnp.ndarray
    n_adv: jnp.ndarray
    n_ac: jnp.ndarray
    overflow: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class EntryCase:
    dx: float
    adaptation: SPHAdaptation
    grid: Any
    eos: WeaklyCompressibleFluid
    riemann: Any
    gravity: Any
    wall: State
    wall_table: Any
    cyl0: State
    rb0: rg.RigidBody2D
    diffusion: Any
    bottom_idx: int        # wetting observer: bottom material particle
    n_fluid: int
    n_wall: int
    n_cyl: int
    cell_cap: int
    k_inner: int
    k_contact: int

    @property
    def kernel(self):
        return self.adaptation.kernel


def build_case(dx: float = 2.0 * R_CYL / 40.0, dtype=jnp.float32,
               cell_cap: int = 24, k_inner: int = 64, k_contact: int = 40):
    bw = 4 * dx
    adaptation = SPHAdaptation(spacing=dx, dim=2)

    water_shape = G.Box(G.Transform(translation=(DL / 2, LH / 2)),
                        halfsize=(DL / 2, LH / 2))
    outer = G.Box(G.Transform(translation=(DL / 2, DH / 2)),
                  halfsize=(DL / 2 + bw, DH / 2 + bw))
    inner = G.Box(G.Transform(translation=(DL / 2, DH / 2)),
                  halfsize=(DL / 2, DH / 2))
    wall_shape = G.make_complex(("add", outer), ("sub", inner))
    cyl_shape = G.Ball(center=(DL / 2, CYL_CY), radius=R_CYL)

    dom_lo, dom_hi = (-bw, -bw), (DL + bw, DH + bw)
    pos_f, vol = generate_lattice(water_shape, dom_lo, dom_hi, dx)
    pos_w, _ = generate_lattice(wall_shape, dom_lo, dom_hi, dx)
    pos_c, _ = generate_lattice(cyl_shape, dom_lo, dom_hi, dx)

    fluid = dict(make_fluid_state(pos_f, vol, RHO0_F, dtype=dtype))
    eos = WeaklyCompressibleFluid(rho0=RHO0_F, c0=C_F)
    # hydrostatic pre-equilibration of the resting column
    p_h = RHO0_F * GRAVITY_G * (LH - np.asarray(pos_f)[:, 1])
    fluid["Density"] = jnp.asarray(
        np.asarray(eos.density_from_pressure(jnp.asarray(p_h))), dtype)
    fluid["Pressure"] = jnp.asarray(p_h, dtype)
    fluid["Phi"] = jnp.ones((fluid["Position"].shape[0],), dtype)
    zeros_v = jnp.zeros_like(fluid["Position"])
    fluid["ViscousForce"] = zeros_v
    fluid["ViscousForcePrev"] = zeros_v
    # opt into gravity_force's BaseForcePrior delta form (coexists with
    # the viscous prior force; see physics/general.py gravity_force)
    fluid["GravityForcePrev"] = zeros_v
    fluid["Indicator"] = jnp.zeros((len(pos_f),), jnp.int32)
    fluid["PreviousSurfaceIndicator"] = jnp.ones((len(pos_f),), jnp.int32)
    fluid["PositionDivergence"] = jnp.zeros((len(pos_f),), dtype)

    wall = make_solid_state(pos_w, vol, RHO0_F, dtype=dtype)
    wall = gd.normal_direction_from_shape(wall, wall_shape)

    cyl = dict(make_solid_state(pos_c, vol, RHO0_S, dtype=dtype))
    cyl = dict(gd.normal_direction_from_shape(cyl, cyl_shape))
    cyl["InitialPosition"] = cyl["Position"]
    cyl["Phi"] = jnp.zeros((len(pos_c),), dtype)
    for key in ("PressureForceFromFluid", "ViscousForceFromFluid"):
        cyl[key] = jnp.zeros_like(cyl["Position"])
        cyl["Previous" + key] = jnp.zeros_like(cyl["Position"])
    cyl["ForcePrior"] = jnp.zeros_like(cyl["Position"])
    cyl["Force"] = jnp.zeros_like(cyl["Position"])
    cyl["AverageAcceleration"] = jnp.zeros_like(cyl["Position"])
    cyl["AverageVelocity"] = jnp.zeros_like(cyl["Position"])

    mask = jnp.ones((len(pos_c),), bool)
    rb0 = rg.rigid_body_from_particles(cyl, mask)
    bottom_idx = int(np.argmin(np.asarray(pos_c)[:, 1]))

    diffusion = df.IsotropicDiffusion(100.0 * dx * dx) if hasattr(
        df, "IsotropicDiffusion") else 100.0 * dx * dx

    gravity = gd.Gravity(acceleration=(0.0, -GRAVITY_G))
    fluid = gd.gravity_force(fluid, gravity)

    grid = grid_from_bounds(dom_lo, dom_hi, adaptation.cutoff)
    wall_table = jax.jit(partial(build_cell_table, grid=grid,
                                 cap=cell_cap))(wall["Position"],
                                                wall["NReal"])

    case = EntryCase(dx=dx, adaptation=adaptation, grid=grid, eos=eos,
                     riemann=rs.acoustic_riemann(eos), gravity=gravity,
                     wall=wall, wall_table=wall_table, cyl0=cyl, rb0=rb0,
                     diffusion=diffusion, bottom_idx=bottom_idx,
                     n_fluid=len(pos_f), n_wall=len(pos_w),
                     n_cyl=len(pos_c), cell_cap=cell_cap, k_inner=k_inner,
                     k_contact=k_contact)
    return case, fluid


def rebuild(case: EntryCase, fluid: State, cyl: State):
    pos = fluid["Position"]
    n_f, n_c = fluid["NReal"], cyl["NReal"]
    cutoff = case.adaptation.cutoff
    table_f = build_cell_table(pos, n_f, case.grid, cap=case.cell_cap)
    table_c = build_cell_table(cyl["Position"], n_c, case.grid,
                               cap=case.cell_cap)
    nl_ff = build_neighbor_list(pos, n_f, pos, n_f, table_f, case.grid,
                                cutoff, k_max=case.k_inner,
                                include_self=False)
    nl_fw = build_neighbor_list(pos, n_f, case.wall["Position"],
                                case.wall["NReal"], case.wall_table,
                                case.grid, cutoff, k_max=case.k_contact,
                                include_self=True)
    nl_fc = build_neighbor_list(pos, n_f, cyl["Position"], n_c, table_c,
                                case.grid, cutoff, k_max=case.k_contact,
                                include_self=True)
    nl_cf = build_neighbor_list(cyl["Position"], n_c, pos, n_f, table_f,
                                case.grid, cutoff, k_max=case.k_contact,
                                include_self=True)
    nl_cc = build_neighbor_list(cyl["Position"], n_c, cyl["Position"], n_c,
                                table_c, case.grid, cutoff,
                                k_max=case.k_inner, include_self=False)
    ovf = (nl_ff.overflow | nl_fw.overflow | nl_fc.overflow
           | nl_cf.overflow | nl_cc.overflow)
    return nl_ff, nl_fw, nl_fc, nl_cf, nl_cc, ovf


def init_sim(case: EntryCase, fluid: State) -> SimState:
    cyl = case.cyl0
    nl_ff, nl_fw, nl_fc, nl_cf, nl_cc, ovf = jax.jit(
        partial(rebuild, case))(fluid, cyl)
    dtype = fluid["Position"].dtype
    z32 = jnp.zeros((), jnp.int32)
    return SimState(fluid=fluid, cyl=cyl, rb=case.rb0, nl_ff=nl_ff,
                    nl_fw=nl_fw, nl_fc=nl_fc, nl_cf=nl_cf, nl_cc=nl_cc,
                    time=jnp.zeros((), dtype), n_adv=z32, n_ac=z32,
                    overflow=ovf)


def _advection_step(case: EntryCase, s: SimState) -> SimState:
    kernel, dim = case.kernel, 2
    h = case.adaptation.h
    sigma0 = case.adaptation.sigma0
    fluid, cyl, rb = s.fluid, s.cyl, s.rb
    mask_c = jnp.ones((case.n_cyl,), bool)

    contacts = [(case.wall, s.nl_fw, RHO0_F), (cyl, s.nl_fc, RHO0_S)]
    dt_adv = fd.advection_time_step(fluid, h, U_MAX)
    # free-stream indicator + bulk-scoped transport shift + viscosity,
    # mirroring the reference's op list (test_2d_water_entry_exit.cpp:
    # 291-298; the wetting-coupled indication variant reduces to the
    # spatial-temporal one here since the cylinder contact is already
    # counted in the position divergence)
    fluid = fd.free_surface_indication(fluid, s.nl_ff, kernel, dim,
                                       contacts=contacts,
                                       spatial_temporal=True)
    fluid = fd.density_summation(fluid, s.nl_ff, kernel, dim, RHO0_F, sigma0,
                                 contacts=contacts, free_surface=True)
    fluid = fd.viscous_force(fluid, s.nl_ff, kernel, dim, MU_F, h,
                             walls=[(case.wall, s.nl_fw), (cyl, s.nl_fc)])
    fluid = fd.transport_velocity_correction(
        fluid, s.nl_ff, kernel, dim, h,
        walls=[(case.wall, s.nl_fw), (cyl, s.nl_fc)],
        scope_mask=fluid["Indicator"] == 0)
    cyl = fsi.viscous_force_from_fluid(cyl, fluid, s.nl_cf, kernel, dim,
                                       MU_F, h)

    def ac_cond(carry):
        _, _, _, rt, _ = carry
        return rt < dt_adv

    def ac_body(carry):
        f, c, r, rt, k = carry
        dt = jnp.minimum(fd.acoustic_time_step(f, case.eos, h), dt_adv)
        walls = [(case.wall, s.nl_fw), (c, s.nl_fc)]
        f = fd.acoustic_step_1st_half(f, s.nl_ff, kernel, dim, case.eos,
                                      case.riemann, dt, walls=walls)
        c = fsi.pressure_force_from_fluid(c, f, s.nl_cf, kernel, dim,
                                          case.riemann)
        force, torque = rg.total_force_and_torque(c, mask_c, r,
                                                  force_keys=("ForcePrior",))
        r_new = rg.rigid_step(r, force, torque, dt,
                              gravity=(0.0, -GRAVITY_G))
        c = rg.constrain_by_rigid_body(c, mask_c, r_new,
                                       case.cyl0["InitialPosition"],
                                       case.rb0.com)
        acc = (r_new.vel - r.vel) / (dt + 1e-15)
        c = dict(c)
        c["AverageAcceleration"] = jnp.broadcast_to(acc, c["Position"].shape)
        c["AverageVelocity"] = jnp.broadcast_to(r_new.vel,
                                                c["Position"].shape)
        f = fd.acoustic_step_2nd_half(f, s.nl_ff, kernel, dim, case.riemann,
                                      dt, walls=[(case.wall, s.nl_fw),
                                                 (c, s.nl_fc)])
        # wetting: Phi diffuses into the cylinder from the (Phi = 1) water
        # through the Dirichlet contact (cylinder_wetting.exec(dt))
        c = df.diffusion_step_rk2(c, "Phi", s.nl_cc, kernel, dim,
                                  case.diffusion, dt,
                                  dirichlet_contacts=[(f, s.nl_cf)])
        return (f, c, r_new, rt + dt, k + 1)

    fluid, cyl, rb, relax_t, n_ac = jax.lax.while_loop(
        ac_cond, ac_body,
        (fluid, cyl, rb, jnp.zeros_like(dt_adv), jnp.zeros((), jnp.int32)))

    nl_ff, nl_fw, nl_fc, nl_cf, nl_cc, ovf = rebuild(case, fluid, cyl)
    return SimState(fluid=fluid, cyl=cyl, rb=rb, nl_ff=nl_ff, nl_fw=nl_fw,
                    nl_fc=nl_fc, nl_cf=nl_cf, nl_cc=nl_cc,
                    time=s.time + relax_t, n_adv=s.n_adv + 1,
                    n_ac=s.n_ac + n_ac, overflow=s.overflow | ovf)


def make_run_chunk(case: EntryCase):
    @jax.jit
    def run_chunk(s: SimState, t_target) -> SimState:
        return jax.lax.while_loop(lambda st: st.time < t_target,
                                  lambda st: _advection_step(case, st), s)

    return run_chunk


def center_position(s: SimState):
    """CylinderObserver Position (the rigid center)."""
    return s.rb.com


def bottom_wetting(case: EntryCase, s: SimState):
    """WettingObserver Phi at the cylinder's bottom material point."""
    return s.cyl["Phi"][case.bottom_idx]
