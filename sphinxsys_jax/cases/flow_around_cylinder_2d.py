"""2D flow around a cylinder at Re = 100 (free-stream, uniform resolution).

Counterpart of /root/reference/tests/2d_examples/test_2d_flow_around_cylinder/
2d_flow_around_cylinder.{h,cpp}: a 15 x 10 free-stream domain (doubly
periodic with sponge bands), cylinder r = 0.75 at (4, 5), ramped
free-stream U = 0.5 U_f (1 - cos(pi t / 2)) imposed in the buffer region
(everything left of x = 0 plus the bands above/below the channel —
createBufferShape), viscous + transport-velocity-corrected WCSPH, and the
total viscous force on the cylinder as the regression quantity
(Cylinder_TotalViscousForceFromFluid, time-averaged mean 0.4034 in the
shipped DB).

Status vs the reference DB: the startup transient tracks the shipped
curve closely (at dx = 0.1 our drag history reproduces the DB's first
five ~1s snapshots 0.61/0.56/0.30/0.14/0.37 to within a few percent),
but the developed mean settles ~25% below the DB's 0.403 at the DB's own
dx = 0.2 (~0.29); the deficit shrinks with resolution and is attributed
to the unrelaxed fluid lattice around the curved surface (the reference
relaxes the 2x-refined cylinder through its level-set shape; we relax the
cylinder body but not the surrounding fluid).  CI gates the developed
window rather than asserting DTW parity.

XLA-native notes: the buffer is re-tagged from current positions each
advection step (the reference's BodyRegionByCell); periodic wrap plays the
role of both PeriodicConditionUsingCellLinkedList axes.
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
from sphinxsys_jax.neighbors.cell_list import wrap_positions
from sphinxsys_jax.physics import fluid as fd
from sphinxsys_jax.physics import fsi
from sphinxsys_jax.physics import general as gd
from sphinxsys_jax.physics import riemann as rs

DL = 15.0
DH = 10.0
DX = 0.2
DL_SPONGE = DX * 10.0
DH_SPONGE = DX * 2.0
CX, CY = 4.0, 5.0
R_CYL = 0.75
RHO0_F = 1.0
U_F = 1.0
C_F = 10.0 * U_F
RE = 100.0
MU_F = RHO0_F * U_F * (2.0 * R_CYL) / RE
T_RAMP = 2.0


class SimState(NamedTuple):
    fluid: Any
    cyl: Any            # cylinder state incl. accumulated fluid forces
    nl_inner: Any
    nl_fw: Any          # fluid -> cylinder (wall terms)
    nl_wf: Any          # cylinder -> fluid (force recorders)
    time: jnp.ndarray
    n_adv: jnp.ndarray
    overflow: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class CylinderCase:
    dx: float
    adaptation: SPHAdaptation
    grid: Any
    eos: WeaklyCompressibleFluid
    riemann: rs.AcousticRiemannSolver
    no_riemann: rs.NoRiemannSolver
    n_fluid: int
    cell_cap: int
    k_inner: int
    k_contact: int

    @property
    def kernel(self):
        return self.adaptation.kernel

    @property
    def box(self):
        return self.grid.periodic_lengths


def build_case(dx: float = DX, dtype=jnp.float32, cell_cap: int = 24,
               k_inner: int = 64, k_contact: int = 96, relax_cyl: int = 200):
    adaptation = SPHAdaptation(spacing=dx, dim=2)
    dom_lo = (-DL_SPONGE, -DH_SPONGE)
    dom_hi = (DL, DH + DH_SPONGE)

    cyl_shape = G.Ball(center=(CX, CY), radius=R_CYL)
    water_shape = G.make_complex(
        ("add", G.Box(G.Transform(translation=((DL - DL_SPONGE) / 2, DH / 2)),
                      halfsize=((DL + DL_SPONGE) / 2, DH / 2 + DH_SPONGE))),
        ("sub", cyl_shape))

    pos_f, vol = generate_lattice(water_shape, dom_lo, dom_hi, dx)
    # the cylinder is 2x refined (defineAdaptationRatios(1.15, 2.0),
    # 2d_flow_around_cylinder.cpp:36): finer surface quadrature for the
    # wall-contact terms; pairs still use the fluid kernel (the larger h,
    # NeighborBuilderContact's kernel choice)
    pos_c, vol_c = generate_lattice(cyl_shape, dom_lo, dom_hi, dx / 2.0)
    if relax_cyl > 0:
        # body-fitted cylinder distribution (defineBodyLevelSetShape +
        # RelaxationStepInner, 2d_flow_around_cylinder.cpp:37,63-99)
        from sphinxsys_jax.physics.relax import relax_shape

        adapt_c = SPHAdaptation(spacing=dx / 2.0, dim=2, h_spacing_ratio=1.15)
        grid_c = grid_from_bounds(dom_lo, dom_hi, adapt_c.cutoff)
        pos_c = np.asarray(relax_shape(cyl_shape, jnp.asarray(
            np.asarray(pos_c), dtype), float(vol_c), adapt_c, grid_c,
            n_iterations=relax_cyl, cell_cap=32, k_max=48))

    fluid = dict(make_fluid_state(pos_f, vol, RHO0_F, dtype=dtype))
    fluid["ViscousForce"] = jnp.zeros_like(fluid["Velocity"])
    fluid["ViscousForcePrev"] = jnp.zeros_like(fluid["Velocity"])

    cyl = dict(make_solid_state(pos_c, vol_c, RHO0_F, dtype=dtype))
    cyl = gd.normal_direction_from_shape(cyl, cyl_shape)
    cyl["ForcePrior"] = jnp.zeros_like(cyl["Velocity"])
    cyl["AverageVelocity"] = jnp.zeros_like(cyl["Velocity"])
    cyl["AverageAcceleration"] = jnp.zeros_like(cyl["Velocity"])
    cyl["ViscousForceFromFluid"] = jnp.zeros_like(cyl["Velocity"])
    cyl["PressureForceFromFluid"] = jnp.zeros_like(cyl["Velocity"])
    cyl["PreviousPressureForceFromFluid"] = jnp.zeros_like(cyl["Velocity"])
    cyl["PreviousViscousForceFromFluid"] = jnp.zeros_like(cyl["Velocity"])

    eos = WeaklyCompressibleFluid(rho0=RHO0_F, c0=C_F)
    grid = grid_from_bounds(dom_lo, dom_hi, adaptation.cutoff,
                            periodic=(True, True))
    case = CylinderCase(dx=dx, adaptation=adaptation, grid=grid, eos=eos,
                        riemann=rs.acoustic_riemann(eos),
                        no_riemann=rs.no_riemann(eos), n_fluid=len(pos_f),
                        cell_cap=cell_cap, k_inner=k_inner,
                        k_contact=k_contact)
    return case, fluid, cyl


def _rebuild(case: CylinderCase, fluid: State, cyl: State):
    pos = wrap_positions(fluid["Position"], case.grid)
    n_f = fluid["NReal"]
    cutoff = case.adaptation.cutoff
    table_f = build_cell_table(pos, n_f, case.grid, cap=case.cell_cap)
    # dx/2 cylinder particles: up to (cutoff/(dx/2))^2 = 27 per cell
    table_c = build_cell_table(cyl["Position"], cyl["NReal"], case.grid,
                               cap=2 * case.cell_cap)
    nl_inner = build_neighbor_list(pos, n_f, pos, n_f, table_f, case.grid,
                                   cutoff, k_max=case.k_inner,
                                   include_self=False)
    nl_fw = build_neighbor_list(pos, n_f, cyl["Position"], cyl["NReal"],
                                table_c, case.grid, cutoff,
                                k_max=case.k_contact, include_self=True)
    nl_wf = build_neighbor_list(cyl["Position"], cyl["NReal"], pos, n_f,
                                table_f, case.grid, cutoff,
                                k_max=case.k_inner, include_self=True)
    ovf = nl_inner.overflow | nl_fw.overflow | nl_wf.overflow
    return pos, nl_inner, nl_fw, nl_wf, ovf


def init_sim(case: CylinderCase, fluid: State, cyl: State) -> SimState:
    pos, nl_inner, nl_fw, nl_wf, ovf = jax.jit(partial(_rebuild, case))(
        fluid, cyl)
    fluid = dict(fluid)
    fluid["Position"] = pos
    dtype = pos.dtype
    return SimState(fluid=fluid, cyl=cyl, nl_inner=nl_inner, nl_fw=nl_fw,
                    nl_wf=nl_wf, time=jnp.zeros((), dtype),
                    n_adv=jnp.zeros((), jnp.int32), overflow=ovf)


def freestream_velocity(t, dtype=jnp.float32):
    """FreeStreamCondition ramp (2d_flow_around_cylinder.h:122-126)."""
    ramp = 0.5 * U_F * (1.0 - jnp.cos(jnp.pi * t / T_RAMP))
    return jnp.where(t < T_RAMP, ramp, U_F).astype(dtype)


def _buffer_mask(pos):
    """createBufferShape: inlet sponge plus the bands above/below the
    channel (2d_flow_around_cylinder.h:52-68), from CURRENT positions."""
    x, y = pos[:, 0], pos[:, 1]
    return (x < 0.0) | (y < 0.0) | (y > DH)


def _advection_step(case: CylinderCase, s: SimState) -> SimState:
    kernel, dim = case.kernel, 2
    h = case.adaptation.h
    sigma0 = case.adaptation.sigma0
    box = case.box
    fluid, cyl = s.fluid, s.cyl
    walls = [(cyl, s.nl_fw)]

    dt_adv = fd.advection_viscous_time_step(fluid, h, U_F, RHO0_F, MU_F)
    fluid = fd.density_summation(fluid, s.nl_inner, kernel, dim, RHO0_F,
                                 sigma0, contacts=[(cyl, s.nl_fw, RHO0_F)],
                                 free_surface=False, box=box)
    fluid = fd.viscous_force(fluid, s.nl_inner, kernel, dim, MU_F, h,
                             walls=walls, box=box)
    # viscous drag on the cylinder (solid_dynamics::ViscousForceFromFluid),
    # recorded once per advection step like the reference
    cyl = fsi.viscous_force_from_fluid(cyl, fluid, s.nl_wf, kernel, dim,
                                       MU_F, h, box=box)
    fluid = fd.transport_velocity_correction(fluid, s.nl_inner, kernel, dim,
                                             h, walls=walls, box=box)

    def ac_cond(carry):
        _, _, rt = carry
        return rt < dt_adv

    def ac_body(carry):
        f, c, rt = carry
        dt = jnp.minimum(fd.acoustic_time_step(f, case.eos, h), dt_adv)
        f = fd.acoustic_step_1st_half(f, s.nl_inner, kernel, dim, case.eos,
                                      case.riemann, dt, walls=walls, box=box)
        c = fsi.pressure_force_from_fluid(c, f, s.nl_wf, kernel, dim,
                                          case.riemann, box=box)
        f = fd.acoustic_step_2nd_half(f, s.nl_inner, kernel, dim,
                                      case.no_riemann, dt, walls=walls,
                                      box=box)
        # FreeStreamCondition per acoustic step: relax buffer velocity
        # toward the ramped free stream (FlowVelocityBuffer rate 0.3,
        # fluid_boundary.cpp:18-21; exec placement flow_around_cylinder.cpp:203)
        u_ave = freestream_velocity(s.time + rt + dt, f["Position"].dtype)
        mask = _buffer_mask(f["Position"])
        target = jnp.stack([jnp.full_like(f["Velocity"][:, 0], u_ave),
                            jnp.zeros_like(f["Velocity"][:, 1])], -1)
        f = dict(f)
        f["Velocity"] = jnp.where(
            mask[:, None],
            f["Velocity"] + 0.3 * (target - f["Velocity"]), f["Velocity"])
        return (f, c, rt + dt)

    fluid, cyl, relax_t = jax.lax.while_loop(
        ac_cond, ac_body, (fluid, cyl, jnp.zeros_like(dt_adv)))

    pos, nl_inner, nl_fw, nl_wf, ovf = _rebuild(case, fluid, cyl)
    fluid["Position"] = pos
    return SimState(fluid=fluid, cyl=cyl, nl_inner=nl_inner, nl_fw=nl_fw,
                    nl_wf=nl_wf, time=s.time + relax_t, n_adv=s.n_adv + 1,
                    overflow=s.overflow | ovf)


def make_run_chunk(case: CylinderCase):
    @jax.jit
    def run_chunk(s: SimState, t_target) -> SimState:
        return jax.lax.while_loop(lambda st: st.time < t_target,
                                  lambda st: _advection_step(case, st), s)

    return run_chunk


def total_viscous_force(s: SimState):
    """Cylinder_TotalViscousForceFromFluid (QuantitySummation)."""
    n = int(s.cyl["NReal"])
    return np.asarray(jnp.sum(s.cyl["ViscousForceFromFluid"][:n], axis=0))
