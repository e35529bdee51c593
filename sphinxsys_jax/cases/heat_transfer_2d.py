"""Thermal channel flow (test_2d_heat_transfer).

Counterpart of /root/reference/tests/2d_examples/test_2d_heat_transfer/
heat_transfer.cpp: an x-periodic channel (DL=2, DH=0.4, dx=DH/25) with a
20*dx inflow sponge imposing a ramped parabolic velocity profile, a hot
lower wall (Phi=40) and a cold upper wall (Phi=20); the fluid (initial
Phi=20) advects and diffuses heat (isotropic D=1e-3) with Dirichlet
thermal contact to the walls (ThermalRelaxationComplex,
heat_transfer.cpp:150-151).  The observer records Phi at (0, DH/2)
against the reference's ensemble-averaged regression DB.

Per the reference loop (heat_transfer.cpp:300-345): advection step =
density summation + viscous force + transport-velocity correction, then
acoustic sub-steps of min(dt_thermal, dt_acoustic, Dt) each running
pressure relaxation (wall Riemann), density relaxation (wall no-Riemann),
RK2 thermal relaxation, and the inflow velocity reset.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from sphinxsys_jax.core.adaptation import SPHAdaptation
from sphinxsys_jax.core.materials import WeaklyCompressibleFluid
from sphinxsys_jax.core.state import State, make_fluid_state, make_solid_state
from sphinxsys_jax.neighbors import (build_cell_table, build_neighbor_list,
                                     grid_from_bounds)
from sphinxsys_jax.neighbors.cell_list import wrap_positions
from sphinxsys_jax.physics import diffusion as dfn
from sphinxsys_jax.physics import fluid as fd
from sphinxsys_jax.physics import riemann as rs

DL = 2.0
DH = 0.4
DX = DH / 25.0
DL_SPONGE = DX * 20.0
N_WALL_LAYERS = 4

RHO0_F = 1.0
U_F = 1.0
C_F = 10.0 * U_F
RE = 100.0
MU_F = RHO0_F * U_F * DH / RE
DIFFUSION_COEFF = 1.0e-3
PHI_UPPER_WALL = 20.0
PHI_LOWER_WALL = 40.0
PHI_FLUID_INITIAL = 20.0
T_RAMP = 2.0
OBS_POINT = (0.0, 0.5 * DH)

TINY = 1.0e-12


class SimState(NamedTuple):
    fluid: Any
    nl_inner: Any
    nl_wall: Any
    time: jnp.ndarray
    n_adv: jnp.ndarray
    n_ac: jnp.ndarray
    overflow: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class HeatTransferCase:
    dx: float
    adaptation: SPHAdaptation
    grid: Any
    eos: WeaklyCompressibleFluid
    riemann: Any
    no_riemann: Any
    wall: Any
    wall_table: Any
    diffusion: Any
    n_fluid: int
    cell_cap: int
    k_inner: int
    k_wall: int

    @property
    def kernel(self):
        return self.adaptation.kernel

    @property
    def box(self):
        return self.grid.periodic_lengths


def _make_walls(dx: float, dtype):
    """4 dummy layers below y=0 and above y=DH across the full periodic
    span, with inward normals and fixed wall temperatures
    (ThermosolidBodyInitialCondition, heat_transfer.cpp:100-122)."""
    xs = np.arange(-DL_SPONGE + dx / 2, DL, dx)
    ys = np.arange(dx / 2, N_WALL_LAYERS * dx, dx)
    bot = np.stack(np.meshgrid(xs, -ys, indexing="ij"), -1).reshape(-1, 2)
    top = np.stack(np.meshgrid(xs, DH + ys, indexing="ij"), -1).reshape(-1, 2)
    pos = np.concatenate([bot, top], axis=0)
    normals = np.concatenate([
        np.tile([0.0, 1.0], (len(bot), 1)),
        np.tile([0.0, -1.0], (len(top), 1))], axis=0)
    phi = np.concatenate([
        np.full(len(bot), PHI_LOWER_WALL),
        np.full(len(top), PHI_UPPER_WALL)])
    wall = dict(make_solid_state(pos, dx * dx, RHO0_F, dtype=dtype))
    wall["NormalDirection"] = jnp.asarray(normals, dtype)
    wall["Phi"] = jnp.asarray(phi, dtype)
    return wall


def build_case(dx: float = DX, dtype=jnp.float32, cell_cap: int = 24,
               k_inner: int = 40, k_wall: int = 24):
    adaptation = SPHAdaptation(spacing=dx, dim=2)
    xs = np.arange(-DL_SPONGE + dx / 2, DL, dx)
    ys = np.arange(dx / 2, DH, dx)
    pos = np.stack(np.meshgrid(xs, ys, indexing="ij"), -1).reshape(-1, 2)
    fluid = dict(make_fluid_state(pos, dx * dx, RHO0_F, dtype=dtype))
    fluid["Phi"] = jnp.full((len(pos),), PHI_FLUID_INITIAL, dtype)
    # registered up front so the viscous-force Prev-subtraction pattern
    # keeps the while_loop carry structure static
    fluid["ViscousForce"] = jnp.zeros((len(pos), 2), dtype)
    fluid["ViscousForcePrev"] = jnp.zeros((len(pos), 2), dtype)

    grid = grid_from_bounds(
        (-DL_SPONGE, -(N_WALL_LAYERS + 0.5) * dx),
        (DL, DH + (N_WALL_LAYERS + 0.5) * dx),
        adaptation.cutoff, periodic=(True, False))
    wall = _make_walls(dx, dtype)
    eos = WeaklyCompressibleFluid(rho0=RHO0_F, c0=C_F)
    wall_table = jax.jit(partial(build_cell_table, grid=grid, cap=cell_cap))(
        wall["Position"], wall["NReal"])
    case = HeatTransferCase(
        dx=dx, adaptation=adaptation, grid=grid, eos=eos,
        riemann=rs.acoustic_riemann(eos), no_riemann=rs.no_riemann(eos),
        wall=wall, wall_table=wall_table,
        diffusion=dfn.IsotropicDiffusion(d_coeff=DIFFUSION_COEFF),
        n_fluid=len(pos), cell_cap=cell_cap, k_inner=k_inner, k_wall=k_wall)
    return case, fluid


def _inflow_velocity(case, fluid: State, t):
    """Ramped parabolic profile imposed in the sponge x < 0
    (InflowVelocity, heat_transfer.cpp:155-177)."""
    pos, vel = fluid["Position"], fluid["Velocity"]
    dtype = pos.dtype
    u_ave = jnp.where(
        t < T_RAMP,
        0.5 * U_F * (1.0 - jnp.cos(jnp.pi * t / T_RAMP)), U_F).astype(dtype)
    half = 0.5 * DH
    yc = (pos[:, 1] - half) / half
    target = 1.5 * u_ave * (1.0 - yc * yc)
    in_buffer = pos[:, 0] < 0.0
    out = dict(fluid)
    out["Velocity"] = jnp.where(
        in_buffer[:, None],
        jnp.stack([target, vel[:, 1]], axis=-1), vel)
    return out


def rebuild_lists(case: HeatTransferCase, fluid: State):
    pos = wrap_positions(fluid["Position"], case.grid)
    n = fluid["NReal"]
    table = build_cell_table(pos, n, case.grid, cap=case.cell_cap)
    nl = build_neighbor_list(pos, n, pos, n, table, case.grid,
                             case.adaptation.cutoff, k_max=case.k_inner,
                             include_self=False)
    nlw = build_neighbor_list(pos, n, case.wall["Position"],
                              case.wall["NReal"], case.wall_table, case.grid,
                              case.adaptation.cutoff, k_max=case.k_wall,
                              include_self=False)
    return pos, nl, nlw


def init_sim(case: HeatTransferCase, fluid: State) -> SimState:
    pos, nl, nlw = jax.jit(partial(rebuild_lists, case))(fluid)
    fluid = dict(fluid)
    fluid["Position"] = pos
    dtype = pos.dtype
    return SimState(fluid=fluid, nl_inner=nl, nl_wall=nlw,
                    time=jnp.zeros((), dtype),
                    n_adv=jnp.zeros((), jnp.int32),
                    n_ac=jnp.zeros((), jnp.int32),
                    overflow=jnp.zeros((), bool))


def _advection_step(case: HeatTransferCase, s: SimState) -> SimState:
    kernel, dim = case.kernel, 2
    h = case.adaptation.h
    sigma0 = case.adaptation.sigma0
    box = case.box
    fluid = s.fluid
    wall = case.wall
    dt_thermal = dfn.diffusion_time_step(h, case.diffusion, dim)

    dt_adv = fd.advection_viscous_time_step(fluid, h, U_F, RHO0_F, MU_F)
    fluid = fd.density_summation(fluid, s.nl_inner, kernel, dim, RHO0_F,
                                 sigma0, contacts=[(wall, s.nl_wall, RHO0_F)],
                                 free_surface=False, box=box)
    fluid = fd.viscous_force(fluid, s.nl_inner, kernel, dim, MU_F, h,
                             wall=wall, nl_wall=s.nl_wall, box=box)
    fluid = fd.transport_velocity_correction(fluid, s.nl_inner, kernel, dim,
                                             h, wall=wall, nl_wall=s.nl_wall,
                                             box=box)

    def ac_cond(carry):
        _, rt, _ = carry
        return rt < dt_adv

    def ac_body(carry):
        f, rt, k = carry
        dt = jnp.minimum(jnp.minimum(
            jnp.asarray(dt_thermal, rt.dtype),
            fd.acoustic_time_step(f, case.eos, h)), dt_adv)
        f = fd.acoustic_step_1st_half(f, s.nl_inner, kernel, dim, case.eos,
                                      case.riemann, dt, wall=wall,
                                      nl_wall=s.nl_wall, box=box)
        f = fd.acoustic_step_2nd_half(f, s.nl_inner, kernel, dim,
                                      case.no_riemann, dt, wall=wall,
                                      nl_wall=s.nl_wall, box=box)
        f = dfn.diffusion_step_rk2(f, "Phi", s.nl_inner, kernel, dim,
                                   case.diffusion, dt,
                                   dirichlet_contacts=[(wall, s.nl_wall)],
                                   box=box)
        f = _inflow_velocity(case, f, s.time + rt + dt)
        return (f, rt + dt, k + 1)

    fluid, relax_t, n_ac = jax.lax.while_loop(
        ac_cond, ac_body,
        (fluid, jnp.zeros_like(dt_adv), jnp.zeros((), jnp.int32)))

    pos, nl, nlw = rebuild_lists(case, fluid)
    fluid = dict(fluid)
    fluid["Position"] = pos
    return SimState(fluid=fluid, nl_inner=nl, nl_wall=nlw,
                    time=s.time + relax_t, n_adv=s.n_adv + 1,
                    n_ac=s.n_ac + n_ac,
                    overflow=s.overflow | nl.overflow | nlw.overflow)


def make_run_chunk(case: HeatTransferCase):
    @jax.jit
    def run_chunk(s: SimState, t_target) -> SimState:
        return jax.lax.while_loop(lambda st: st.time < t_target,
                                  lambda st: _advection_step(case, st), s)

    return run_chunk


def observe_phi(case: HeatTransferCase, s: SimState) -> float:
    """Shepard-interpolated Phi at the reference observer (0, DH/2)
    (ObservedQuantityRecording<Real> 'Phi', heat_transfer.cpp:253)."""
    from sphinxsys_jax.io.observation import observe_quantity

    obs = jnp.asarray([OBS_POINT], s.fluid["Position"].dtype)
    table = build_cell_table(s.fluid["Position"], s.fluid["NReal"],
                             case.grid, cap=case.cell_cap)
    nl = build_neighbor_list(obs, 1, s.fluid["Position"], s.fluid["NReal"],
                             table, case.grid, case.adaptation.cutoff,
                             k_max=case.k_inner, include_self=False)
    return float(observe_quantity(obs, s.fluid, "Phi", nl, case.kernel, 2)[0])


def phi_profile(case: HeatTransferCase, s: SimState, n_bins: int = 25):
    """Streamwise-averaged Phi(y) profile for physics checks."""
    y = np.asarray(s.fluid["Position"][:, 1])
    phi = np.asarray(s.fluid["Phi"])
    edges = np.linspace(0.0, DH, n_bins + 1)
    idx = np.clip(np.digitize(y, edges) - 1, 0, n_bins - 1)
    prof = np.zeros(n_bins)
    for b in range(n_bins):
        prof[b] = phi[idx == b].mean()
    return 0.5 * (edges[:-1] + edges[1:]), prof
