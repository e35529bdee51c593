"""2D still-water tank (STLW) with a free-surface wave gauge.

Counterpart of /root/reference/tests/2d_examples/test_2d_stlw/stlw.{h,cpp}
(author Nicolò Salis): a 3 x 2 water block at rest in a 3 x 4 tank
(rho0 = 1000, g = 9.81, dx = 0.05, mu = 1e-3); after a 1 s settling
window the wave gauge at x = DL/3 = 1.0 records FreeSurfaceHeight
(UpperFrontInAxisDirection over a thin column).  The committed reference
DB (3 runs, 59 snapshots over 10 s) hovers at ~-0.02 — the half-spacing
lattice offset of the surface — with cm-scale sloshing noise; the physics
assertion is that still water STAYS still.

The tank is centered: x in [-DL/2, DL/2], water y in [-WH, 0], walls to
y = +DH/2 (stlw.h:12-36 with the reference's domain bounds).
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
from sphinxsys_jax.physics import general as gd
from sphinxsys_jax.physics import riemann as rs

# stlw.h:12-26
DL = 3.0
DH = 4.0
WH = 2.0
RHO0_F = 1000.0
GRAVITY_G = 9.81
U_F = 2.0 * math.sqrt(0.79 * GRAVITY_G)
C_F = 10.0 * U_F
MU_F = 1.0e-3
X_GAUGE = DL / 3.0          # stlw.h:52 gauge_translation


class SimState(NamedTuple):
    fluid: Any
    nl_inner: Any
    nl_wall: Any
    time: jnp.ndarray
    n_adv: jnp.ndarray
    overflow: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class StlwCase:
    dx: float
    adaptation: SPHAdaptation
    grid: Any
    eos: WeaklyCompressibleFluid
    riemann: Any
    gravity: Any
    wall: State
    wall_table: Any
    n_fluid: int
    n_wall: int
    cell_cap: int
    k_inner: int
    k_wall: int

    @property
    def kernel(self):
        return self.adaptation.kernel


def build_case(dx: float = 0.05, dtype=jnp.float32, cell_cap: int = 24,
               k_inner: int = 64, k_wall: int = 40):
    bw = 4 * dx
    adaptation = SPHAdaptation(spacing=dx, dim=2)

    water_shape = G.Box(G.Transform(translation=(0.0, -WH / 2)),
                        halfsize=(DL / 2, WH / 2))
    outer = G.Box(G.Transform(translation=(0.0, 0.0)),
                  halfsize=(DL / 2 + bw, DH / 2 + bw))
    inner = G.Box(G.Transform(translation=(0.0, 0.0)),
                  halfsize=(DL / 2, DH / 2))
    wall_shape = G.make_complex(("add", outer), ("sub", inner))

    dom_lo = (-DL / 2 - bw, -DH / 2 - bw)
    dom_hi = (DL / 2 + bw, DH / 2 + bw)
    pos_f, vol = generate_lattice(water_shape, dom_lo, dom_hi, dx)
    pos_w, _ = generate_lattice(wall_shape, dom_lo, dom_hi, dx)

    fluid = dict(make_fluid_state(pos_f, vol, RHO0_F, dtype=dtype))
    eos = WeaklyCompressibleFluid(rho0=RHO0_F, c0=C_F)
    # hydrostatic pre-equilibration cuts the settling transient (the
    # reference instead discards its first 1 s of simulation)
    p_hydro = RHO0_F * GRAVITY_G * (0.0 - np.asarray(pos_f)[:, 1])
    fluid["Density"] = jnp.asarray(
        np.asarray(eos.density_from_pressure(jnp.asarray(p_hydro))), dtype)
    fluid["Pressure"] = jnp.asarray(p_hydro, dtype)

    wall = make_solid_state(pos_w, vol, RHO0_F, dtype=dtype)
    wall = gd.normal_direction_from_shape(wall, wall_shape)

    gravity = gd.Gravity(acceleration=(0.0, -GRAVITY_G))
    fluid = gd.gravity_force(fluid, gravity)
    n = fluid["Position"].shape[0]
    fluid["ViscousForce"] = jnp.zeros((n, 2), dtype)
    fluid["ViscousForcePrev"] = jnp.zeros((n, 2), dtype)
    # opt into gravity_force's BaseForcePrior delta form (coexists with
    # the viscous prior force; see physics/general.py gravity_force)
    fluid["GravityForcePrev"] = jnp.zeros((n, 2), dtype)

    grid = grid_from_bounds(dom_lo, dom_hi, adaptation.cutoff)
    wall_table = jax.jit(partial(build_cell_table, grid=grid,
                                 cap=cell_cap))(wall["Position"],
                                                wall["NReal"])

    case = StlwCase(dx=dx, adaptation=adaptation, grid=grid, eos=eos,
                    riemann=rs.acoustic_riemann(eos), gravity=gravity,
                    wall=wall, wall_table=wall_table, n_fluid=len(pos_f),
                    n_wall=len(pos_w), cell_cap=cell_cap, k_inner=k_inner,
                    k_wall=k_wall)
    return case, fluid


def rebuild_relations(case, fluid: State):
    pos = fluid["Position"]
    n = fluid["NReal"]
    table = build_cell_table(pos, n, case.grid, cap=case.cell_cap)
    cutoff = case.adaptation.cutoff
    nl_inner = build_neighbor_list(pos, n, pos, n, table, case.grid, cutoff,
                                   k_max=case.k_inner, include_self=False)
    nl_wall = build_neighbor_list(pos, n, case.wall["Position"],
                                  case.wall["NReal"], case.wall_table,
                                  case.grid, cutoff, k_max=case.k_wall,
                                  include_self=True)
    return nl_inner, nl_wall


def init_sim(case, fluid: State) -> SimState:
    nl_inner, nl_wall = jax.jit(partial(rebuild_relations, case))(fluid)
    dtype = fluid["Position"].dtype
    return SimState(fluid=fluid, nl_inner=nl_inner, nl_wall=nl_wall,
                    time=jnp.zeros((), dtype),
                    n_adv=jnp.zeros((), jnp.int32),
                    overflow=nl_inner.overflow | nl_wall.overflow)


def _advection_step(case, s: SimState) -> SimState:
    kernel, dim = case.kernel, 2
    h = case.adaptation.h
    sigma0 = case.adaptation.sigma0
    fluid = s.fluid

    dt_adv = fd.advection_viscous_time_step(fluid, h, U_F, RHO0_F, MU_F)
    fluid = fd.density_summation(fluid, s.nl_inner, kernel, dim, RHO0_F,
                                 sigma0,
                                 contacts=[(case.wall, s.nl_wall, RHO0_F)],
                                 free_surface=True)
    fluid = fd.viscous_force(fluid, s.nl_inner, kernel, dim, MU_F, h,
                             walls=[(case.wall, s.nl_wall)])

    def ac_cond(carry):
        _, rt = carry
        return rt < dt_adv

    def ac_body(carry):
        f, rt = carry
        dt = jnp.minimum(fd.acoustic_time_step(f, case.eos, h), dt_adv)
        f = fd.acoustic_step_1st_half(f, s.nl_inner, kernel, dim, case.eos,
                                      case.riemann, dt, wall=case.wall,
                                      nl_wall=s.nl_wall)
        f = fd.acoustic_step_2nd_half(f, s.nl_inner, kernel, dim,
                                      case.riemann, dt, wall=case.wall,
                                      nl_wall=s.nl_wall)
        return (f, rt + dt)

    fluid, relax_t = jax.lax.while_loop(ac_cond, ac_body,
                                        (fluid, jnp.zeros_like(dt_adv)))

    nl_inner, nl_wall = rebuild_relations(case, fluid)
    return SimState(fluid=fluid, nl_inner=nl_inner, nl_wall=nl_wall,
                    time=s.time + relax_t, n_adv=s.n_adv + 1,
                    overflow=s.overflow | nl_inner.overflow | nl_wall.overflow)


def make_run_chunk(case):
    @jax.jit
    def run_chunk(s: SimState, t_target) -> SimState:
        return jax.lax.while_loop(lambda st: st.time < t_target,
                                  lambda st: _advection_step(case, st), s)

    return run_chunk


def free_surface_height(case, fluid: State, x_gauge: float = X_GAUGE):
    """FreeSurfaceHeight gauge (UpperFrontInAxisDirection over the column
    |x - x_gauge| <= 1.3 dx, stlw.h:50-53 + general_reduce.h)."""
    hw = 1.3 * case.dx
    pos = fluid["Position"]
    n = fluid["NReal"]
    valid = jnp.arange(pos.shape[0]) < n
    in_col = valid & (jnp.abs(pos[:, 0] - x_gauge) <= hw)
    return jnp.max(jnp.where(in_col, pos[:, 1], -jnp.inf))
