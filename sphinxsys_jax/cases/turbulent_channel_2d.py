"""2D turbulent channel flow with the standard k-epsilon model and wall
functions.

Counterpart of the reference case tests/extra_source_and_tests/2d_examples/
test_2d_turbulent_channel/test_2d_turbulent_channel.{h,cpp}: channel height
DH = 2, Re = 20000, 20 particles across the section, near-wall particle
distance y_p = 0.05, and the full RANS op sequence of its main loop
(test_2d_turbulent_channel.cpp:205-258):

  outer:  gravity | turbulent dt_adv | density+pressure | correction
          matrices | eddy viscosity | turbulent viscous force | TVC
  inner:  TKE force | pressure relaxation | constrain normal velocity in
          region P | density relaxation | near-wall status | wall-function
          correction | velocity gradient | K equation | Eps equation

XLA-native deviation: the reference drives the flow with an inflow/outflow
buffer pair plus a startup body force over a 30-long channel.  We use the
PERIODIC streamwise channel driven by a constant body force g_x — the
standard closed form of the same benchmark: at statistical steady state the
wall shear balances the body force exactly, u_tau = sqrt(g_x * DH/2), which
gives an analytic oracle the open channel lacks.  The turbulent-inlet
machinery itself (InflowTurbulentCondition) is exercised separately via
turbulent_inflow_values.
"""

from __future__ import annotations

import dataclasses
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
from sphinxsys_jax.physics import fluid as fd
from sphinxsys_jax.physics import riemann as rs
from sphinxsys_jax.physics import turbulence as tb

DH = 2.0                      # channel height (test_2d_turbulent_channel.h:21)
N_CROSS = 20.0                # particles across the section (h:23)
Y_P = 0.05                    # wall-adjacent particle distance (h:33)
DX = (DH - 2.0 * Y_P) / (N_CROSS - 1.0)   # = 0.1 (h:34)
RHO0_F = 1.0
U_F = 1.0
U_MAX = 1.5 * U_F
C_F = 10.0 * U_MAX
RE = 20000.0
MU_F = RHO0_F * U_F * DH / RE
# driving body force: u_tau^2 = G_X * (DH/2) at steady state; G_X tuned so
# the log law at U~1 is in equilibrium (u_tau ~ 0.052)
G_X = 2.7e-3
WEIGHT_VGRAD_SUB = 0.1        # weight_vel_grad_sub_nearwall (h:30)
INITIAL_TURBU = (1.80001e-4, 3.326679e-5, 1.0e-9)  # k, eps, mu_t (h:32)
N_WALL_LAYERS = 4


class SimState(NamedTuple):
    fluid: Any
    nl_inner: Any
    nl_wall: Any
    time: jnp.ndarray
    n_adv: jnp.ndarray
    n_ac: jnp.ndarray
    overflow: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class ChannelCase:
    dx: float
    length: float
    adaptation: SPHAdaptation
    grid: Any
    eos: WeaklyCompressibleFluid
    riemann: rs.AcousticRiemannSolver
    no_riemann: Any
    wall: Any
    wall_table: Any
    closure: tb.TurbuClosure
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


def _make_walls(length: float, dx: float, dtype):
    """Dummy wall particle layers below y=0 and above y=DH with inward
    normals (wall_boundary shape, test_2d_turbulent_channel.h:88-108)."""
    xs = np.arange(dx / 2, length, dx)
    ys = np.arange(dx / 2, N_WALL_LAYERS * dx, dx)
    bot = np.stack(np.meshgrid(xs, -ys, indexing="ij"), -1).reshape(-1, 2)
    top = np.stack(np.meshgrid(xs, DH + ys, indexing="ij"), -1).reshape(-1, 2)
    pos = np.concatenate([bot, top], axis=0)
    normals = np.concatenate([
        np.tile([0.0, 1.0], (len(bot), 1)),
        np.tile([0.0, -1.0], (len(top), 1))], axis=0)
    wall = dict(make_solid_state(pos, dx * dx, RHO0_F, dtype=dtype))
    wall["NormalDirection"] = jnp.asarray(normals, dtype)
    return wall


def build_case(dx: float = DX, length: float | None = None,
               dtype=jnp.float32, cell_cap: int = 24, k_inner: int = 40,
               k_wall: int = 24):
    length = length or 8 * dx
    adaptation = SPHAdaptation(spacing=dx, dim=2)
    # fluid lattice fills [0, DH]; with dx = (DH - 2 y_p)/(N-1) the first
    # row of centers sits exactly at y_p from each wall surface
    xs = np.arange(dx / 2, length, dx)
    ys = np.arange(dx / 2, DH, dx)
    pos = np.stack(np.meshgrid(xs, ys, indexing="ij"), -1).reshape(-1, 2)

    fluid = dict(make_fluid_state(pos, dx * dx, RHO0_F, dtype=dtype))
    vel = np.zeros_like(pos)
    vel[:, 0] = U_F               # impulsive uniform start (inflow value)
    fluid["Velocity"] = jnp.asarray(vel, dtype)
    k0, eps0, mut0 = INITIAL_TURBU
    fluid = tb.register_turbulence_fields(fluid, 2, k0, eps0, mut0, Y_P)
    # constant driving force lives in ForcePrior; Tke/viscous contributions
    # are folded in incrementally with the Prev-subtraction pattern
    g = jnp.zeros_like(fluid["Velocity"])
    g = g.at[:, 0].set(G_X)
    fluid["ForcePrior"] = g * fluid["Mass"][:, None]
    fluid["LinearGradientCorrectionMatrix"] = jnp.tile(
        jnp.eye(2, dtype=dtype), (len(pos), 1, 1))

    grid = grid_from_bounds(
        (0.0, -(N_WALL_LAYERS + 0.5) * dx),
        (length, DH + (N_WALL_LAYERS + 0.5) * dx),
        adaptation.cutoff, periodic=(True, False))

    wall = _make_walls(length, dx, dtype)
    eos = WeaklyCompressibleFluid(rho0=RHO0_F, c0=C_F)
    wall_table = jax.jit(partial(build_cell_table, grid=grid, cap=cell_cap))(
        wall["Position"], wall["NReal"])
    case = ChannelCase(dx=dx, length=length, adaptation=adaptation,
                       grid=grid, eos=eos, riemann=rs.acoustic_riemann(eos),
                       no_riemann=rs.no_riemann(eos), wall=wall,
                       wall_table=wall_table, closure=tb.TurbuClosure(),
                       n_fluid=len(pos), cell_cap=cell_cap,
                       k_inner=k_inner, k_wall=k_wall)
    return case, fluid


def rebuild_lists(case: ChannelCase, fluid: State):
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


def init_sim(case: ChannelCase, fluid: State) -> SimState:
    pos, nl, nlw = jax.jit(partial(rebuild_lists, case))(fluid)
    fluid = dict(fluid)
    fluid["Position"] = pos
    dtype = pos.dtype
    return SimState(fluid=fluid, nl_inner=nl, nl_wall=nlw,
                    time=jnp.zeros((), dtype),
                    n_adv=jnp.zeros((), jnp.int32),
                    n_ac=jnp.zeros((), jnp.int32),
                    overflow=jnp.zeros((), bool))


def _advection_step(case: ChannelCase, s: SimState) -> SimState:
    kernel, dim = case.kernel, 2
    h = case.adaptation.h
    sigma0 = case.adaptation.sigma0
    box = case.box
    cl = case.closure
    fluid = s.fluid
    wall = case.wall

    dt_adv = tb.turbulent_advection_time_step(fluid, MU_F, RHO0_F, h, U_MAX)
    fluid = fd.density_summation(fluid, s.nl_inner, kernel, dim, RHO0_F,
                                 sigma0,
                                 contacts=[(wall, s.nl_wall, RHO0_F)],
                                 free_surface=False, box=box)
    fluid["Pressure"] = case.eos.pressure(fluid["Density"])
    # LinearGradientCorrectionMatrixComplex for the corrected pressure force
    # (test_2d_turbulent_channel.cpp:112,115)
    fluid = fd.kernel_correction_matrix(fluid, s.nl_inner, kernel, dim,
                                        wall=wall, nl_wall=s.nl_wall, box=box)
    fluid = tb.turbulent_correction_matrix(fluid, s.nl_inner, kernel, dim)
    fluid = tb.eddy_viscosity_update(fluid, cl)
    # is_AMRD = 0 in the reference channel (test_2d_turbulent_channel.h:28)
    fluid = tb.turbulent_viscous_force(fluid, s.nl_inner, wall, s.nl_wall,
                                       kernel, dim, MU_F, h, C_F, s.time, cl,
                                       extra_dissipation=False)
    fluid = fd.transport_velocity_correction(
        fluid, s.nl_inner, kernel, dim, h, limiter_slope=100.0,
        wall=wall, nl_wall=s.nl_wall, box=box)

    def ac_cond(carry):
        _, rt, _ = carry
        return rt < dt_adv

    def ac_body(carry):
        f, rt, k = carry
        dt = jnp.minimum(fd.acoustic_time_step(f, case.eos, h), dt_adv)
        f = tb.tke_energy_force(f, s.nl_inner, wall, s.nl_wall, kernel, dim)
        f = fd.acoustic_step_1st_half(f, s.nl_inner, kernel, dim, case.eos,
                                      case.riemann, dt, wall=wall,
                                      nl_wall=s.nl_wall, box=box,
                                      correction=True)
        # is_constrain_normal_velocity_in_P_region = false in the reference
        # channel (test_2d_turbulent_channel.h:29)
        # Integration2ndHalfWithWallNoRiemann (cpp:116)
        f = fd.acoustic_step_2nd_half(f, s.nl_inner, kernel, dim,
                                      case.no_riemann, dt, wall=wall,
                                      nl_wall=s.nl_wall, box=box)
        f = tb.judge_is_near_wall(f, wall, s.nl_wall, kernel, dim,
                                  case.dx, case.dx)
        f = tb.standard_wall_function_correction(f, wall, s.nl_wall, kernel,
                                                 dim, MU_F, s.time + rt, cl)
        f = tb.turbulent_velocity_gradient(f, s.nl_inner, wall, s.nl_wall,
                                           kernel, dim, WEIGHT_VGRAD_SUB)
        # is_source_term_linearisation = false (h:31): explicit updates
        f = tb.k_equation(f, s.nl_inner, kernel, dim, MU_F, h, dt, cl,
                          stl=False)
        f = tb.epsilon_equation(f, s.nl_inner, kernel, dim, MU_F, h, dt, cl,
                                stl=False)
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


def make_run_chunk(case: ChannelCase):
    @jax.jit
    def run_chunk(s: SimState, t_target) -> SimState:
        return jax.lax.while_loop(lambda st: st.time < t_target,
                                  lambda st: _advection_step(case, st), s)

    return run_chunk


def mean_profile(case: ChannelCase, s: SimState, n_bins: int | None = None):
    """Streamwise-averaged u(y) profile (n_bins defaults to the particle
    rows across the section)."""
    n_bins = n_bins or int(round(DH / case.dx))
    y = np.asarray(s.fluid["Position"][:, 1])
    u = np.asarray(s.fluid["Velocity"][:, 0])
    edges = np.linspace(0.0, DH, n_bins + 1)
    idx = np.clip(np.digitize(y, edges) - 1, 0, n_bins - 1)
    prof = np.zeros(n_bins)
    for b in range(n_bins):
        m = idx == b
        prof[b] = u[m].mean() if m.any() else 0.0
    return 0.5 * (edges[:-1] + edges[1:]), prof
