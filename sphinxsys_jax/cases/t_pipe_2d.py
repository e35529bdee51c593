"""T-shaped pipe — one inlet, two outlets (multi-outlet open boundary).

Counterpart of /root/reference/tests/2d_examples/test_2d_T_shaped_pipe/
T_shaped_pipe.cpp: a main channel (height DH=3, length DL1=3.5 plus a
DL_sponge=3 inflow sponge) tees into a vertical branch (width DL-DL1=1.5,
spanning y in [-DH, 2 DH]); Re=100 water enters with a ramped parabolic
profile (InflowVelocity, t_ref=2) imposed over the sponge every acoustic
step, is recycled at the left edge by emitter injection, and leaves by
disposer deletion strips at the two branch ends.  Free-stream density
summation + spatial-temporal free-surface indication keep the outlet
surfaces stable; WaterBody_TotalKineticEnergy is the DTW regression
quantity (t=100, recorded every 0.5).
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
from sphinxsys_jax.core.state import FAR_AWAY, State, make_fluid_state, make_solid_state
from sphinxsys_jax.neighbors import (build_cell_table, build_neighbor_list,
                                     grid_from_bounds)
from sphinxsys_jax.physics import boundary as bd
from sphinxsys_jax.physics import fluid as fd
from sphinxsys_jax.physics import general as gd
from sphinxsys_jax.physics import riemann as rs

DL = 5.0
DH = 3.0
DL1 = 0.7 * DL
DX = 0.15
BW = 4 * DX
DL_SPONGE = 20 * DX
RHO0_F = 1.0
U_F = 1.0
C_F = 10.0 * U_F * max(1.0, DH / (2.0 * (DL - DL1)))
RE = 100.0
MU_F = RHO0_F * U_F * DH / RE
T_REF = 2.0
RESERVE = 0.5


def water_shape():
    """T polygon (T_shaped_pipe.cpp:23-25)."""
    return G.make_multi_polygon(("add", [
        (-DL_SPONGE, 0.0), (-DL_SPONGE, DH), (DL1, DH), (DL1, 2.0 * DH),
        (DL, 2.0 * DH), (DL, -DH), (DL1, -DH), (DL1, 0.0)]))


def wall_shape():
    return G.make_multi_polygon(
        ("add", [(-DL_SPONGE - BW, -BW), (-DL_SPONGE - BW, DH + BW),
                 (DL1 - BW, DH + BW), (DL1 - BW, 2.0 * DH + BW),
                 (DL + BW, 2.0 * DH + BW), (DL + BW, -DH - BW),
                 (DL1 - BW, -DH - BW), (DL1 - BW, -BW)]),
        ("sub", [(-DL_SPONGE - BW, 0.0), (-DL_SPONGE - BW, DH), (DL1, DH),
                 (DL1, 2.0 * DH + BW), (DL, 2.0 * DH + BW), (DL, -DH - BW),
                 (DL1, -DH - BW), (DL1, 0.0)]))


class SimState(NamedTuple):
    fluid: Any
    nl_inner: Any
    nl_wall: Any
    time: jnp.ndarray
    n_adv: jnp.ndarray
    overflow: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class TPipeCase:
    dx: float
    adaptation: SPHAdaptation
    grid: Any
    eos: WeaklyCompressibleFluid
    riemann: Any
    no_riemann: Any
    wall: State
    wall_table: Any
    emitter: bd.AlignedBoxRegion
    disposer_up: bd.AlignedBoxRegion
    disposer_down: bd.AlignedBoxRegion
    cell_cap: int
    k_inner: int
    k_wall: int

    @property
    def kernel(self):
        return self.adaptation.kernel


def build_case(dx: float = DX, dtype=jnp.float32, cell_cap: int = 24,
               k_inner: int = 48, k_wall: int = 32):
    adaptation = SPHAdaptation(spacing=dx, dim=2)
    bw = 4 * dx

    dom_lo = (-DL_SPONGE - bw - dx, -DH - bw - dx)
    dom_hi = (DL + bw + dx, 2.0 * DH + bw + dx)
    pos_f, vol = generate_lattice(water_shape(), dom_lo, dom_hi, dx)
    n0 = len(pos_f)
    cap = int(n0 * (1.0 + RESERVE))
    pos_full = np.full((cap, 2), float(FAR_AWAY))
    pos_full[:n0] = pos_f
    fluid = dict(make_fluid_state(pos_full, vol, RHO0_F, dtype=dtype))
    fluid["Alive"] = jnp.arange(cap) < n0
    fluid["NReal"] = jnp.asarray(cap, jnp.int32)
    n = cap
    fluid["Indicator"] = jnp.zeros((n,), jnp.int32)
    # default 1 (surface_indication.cpp:52): the first indication pass runs
    # unsuppressed — a 0 default would lock every particle as bulk forever
    fluid["PreviousSurfaceIndicator"] = jnp.ones((n,), jnp.int32)
    fluid["PositionDivergence"] = jnp.zeros((n,), dtype)
    fluid["ViscousForce"] = jnp.zeros((n, 2), dtype)
    fluid["ViscousForcePrev"] = jnp.zeros((n, 2), dtype)

    pos_w, _ = generate_lattice(wall_shape(), dom_lo, dom_hi, dx)
    wall = dict(make_solid_state(pos_w, vol, RHO0_F, dtype=dtype))
    wall = gd.normal_direction_from_shape(wall, wall_shape())

    grid = grid_from_bounds(dom_lo, dom_hi, adaptation.cutoff)
    wall_table = jax.jit(partial(build_cell_table, grid=grid, cap=cell_cap))(
        wall["Position"], wall["NReal"])

    emitter = bd.AlignedBoxRegion(lower=(-DL_SPONGE, 0.0),
                                  upper=(-DL_SPONGE + bw, DH), axis=0)
    # outlet deletion regions: the reference deletes only particles whose
    # axis coordinate is PAST the outlet plane (checkUpperBound,
    # base_geometry.h:102-106) — strictly outside the T
    disposer_up = bd.AlignedBoxRegion(lower=(DL1 - 0.1 * DH, 2.0 * DH),
                                      upper=(DL + 0.1 * DH, 2.0 * DH + 2 * bw),
                                      axis=1)
    disposer_down = bd.AlignedBoxRegion(lower=(DL1 - 0.1 * DH, -DH - 2 * bw),
                                        upper=(DL + 0.1 * DH, -DH),
                                        axis=1)

    case = TPipeCase(dx=dx, adaptation=adaptation, grid=grid,
                     eos=WeaklyCompressibleFluid(rho0=RHO0_F, c0=C_F),
                     riemann=None, no_riemann=None, wall=wall,
                     wall_table=wall_table, emitter=emitter,
                     disposer_up=disposer_up, disposer_down=disposer_down,
                     cell_cap=cell_cap, k_inner=k_inner, k_wall=k_wall)
    eos = case.eos
    case = dataclasses.replace(case, riemann=rs.acoustic_riemann(eos),
                               no_riemann=rs.no_riemann(eos))
    return case, fluid


def rebuild_relations(case: TPipeCase, fluid: State):
    alive = fluid["Alive"]
    pos = fluid["Position"]
    cutoff = case.adaptation.cutoff
    table = build_cell_table(pos, alive, case.grid, cap=case.cell_cap)
    nl_inner = build_neighbor_list(pos, alive, pos, alive, table, case.grid,
                                   cutoff, k_max=case.k_inner,
                                   include_self=False)
    nl_wall = build_neighbor_list(pos, alive, case.wall["Position"],
                                  case.wall["NReal"], case.wall_table,
                                  case.grid, cutoff, k_max=case.k_wall,
                                  include_self=True)
    return nl_inner, nl_wall


def init_sim(case: TPipeCase, fluid: State) -> SimState:
    nl_inner, nl_wall = jax.jit(partial(rebuild_relations, case))(fluid)
    return SimState(fluid=fluid, nl_inner=nl_inner, nl_wall=nl_wall,
                    time=jnp.zeros((), fluid["Position"].dtype),
                    n_adv=jnp.zeros((), jnp.int32),
                    overflow=jnp.zeros((), bool))


def _inflow_condition(case: TPipeCase, fluid: State, t) -> State:
    """InflowVelocityCondition over the sponge (T_shaped_pipe.cpp:54-72):
    ramped parabolic x-velocity, y-velocity left untouched."""
    out = dict(fluid)
    pos = fluid["Position"]
    in_sponge = (fluid["Alive"] & (pos[:, 0] < 0.0)
                 & (pos[:, 0] >= -DL_SPONGE)
                 & (pos[:, 1] >= 0.0) & (pos[:, 1] <= DH))
    u_ave = jnp.where(t < T_REF,
                      0.5 * U_F * (1.0 - jnp.cos(jnp.pi * t / T_REF)), U_F)
    yl = (pos[:, 1] - 0.5 * DH) / (0.5 * DH)
    u = 1.5 * u_ave * jnp.maximum(0.0, 1.0 - yl * yl)
    vel = fluid["Velocity"]
    out["Velocity"] = vel.at[:, 0].set(jnp.where(in_sponge, u, vel[:, 0]))
    return out


def _advection_step(case: TPipeCase, s: SimState) -> SimState:
    kernel, dim = case.kernel, 2
    h = case.adaptation.h
    fluid = s.fluid
    pos_prev = fluid["Position"]
    walls = [(case.wall, s.nl_wall)]

    dt_adv = fd.advection_viscous_time_step(fluid, h, U_F, RHO0_F, MU_F)
    fluid = fd.free_surface_indication(
        fluid, s.nl_inner, kernel, dim,
        contacts=[(case.wall, s.nl_wall, None)], spatial_temporal=True)
    fluid = fd.density_summation_freestream(
        fluid, s.nl_inner, kernel, dim, RHO0_F, case.adaptation.sigma0,
        contacts=[(case.wall, s.nl_wall, RHO0_F)])
    fluid = fd.viscous_force(fluid, s.nl_inner, kernel, dim, MU_F, h,
                             walls=walls)
    fluid = fd.transport_velocity_correction(
        fluid, s.nl_inner, kernel, dim, h, walls=walls,
        scope_mask=(fluid["Indicator"] == 0) & fluid["Alive"])

    def ac_body(carry):
        f, rt = carry
        dt = jnp.minimum(fd.acoustic_time_step(f, case.eos, h), dt_adv)
        f = fd.acoustic_step_1st_half(f, s.nl_inner, kernel, dim, case.eos,
                                      case.riemann, dt, walls=walls)
        f = _inflow_condition(case, f, s.time + rt)
        f = fd.acoustic_step_2nd_half(f, s.nl_inner, kernel, dim,
                                      case.no_riemann, dt, walls=walls)
        return (f, rt + dt)

    fluid, relax_t = jax.lax.while_loop(
        lambda c: c[1] < dt_adv, ac_body, (fluid, jnp.zeros_like(dt_adv)))

    fluid = bd.disposer_outflow_deletion(fluid, case.disposer_up)
    fluid = bd.disposer_outflow_deletion(fluid, case.disposer_down)
    fluid = bd.emitter_inflow_injection(fluid, case.emitter,
                                        prev_pos=pos_prev)
    inj_ovf = fluid.pop("_InjectionOverflow", jnp.zeros((), bool))

    nl_inner, nl_wall = rebuild_relations(case, fluid)
    return SimState(fluid=fluid, nl_inner=nl_inner, nl_wall=nl_wall,
                    time=s.time + relax_t, n_adv=s.n_adv + 1,
                    overflow=s.overflow | nl_inner.overflow
                    | nl_wall.overflow | inj_ovf)


def make_run_chunk(case: TPipeCase):
    @jax.jit
    def run_chunk(s: SimState, t_target) -> SimState:
        return jax.lax.while_loop(lambda st: st.time < t_target,
                                  lambda st: _advection_step(case, st), s)

    return run_chunk


def kinetic_energy(s: SimState) -> float:
    f = s.fluid
    v2 = jnp.sum(f["Velocity"] ** 2, axis=-1)
    return float(jnp.sum(jnp.where(f["Alive"], 0.5 * f["Mass"] * v2, 0.0)))


def n_alive(s: SimState) -> int:
    return int(jnp.sum(s.fluid["Alive"]))
