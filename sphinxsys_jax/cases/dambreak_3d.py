"""3D dambreak — dimensional-generality case.

Mirrors /root/reference/tests/3d_examples/test_3d_dambreak/dambreak.cpp:
tank 5.366 x 2 x 0.5, water column 2 x 1 x 0.5, dx = 0.05, same material
constants and dual-criteria loop as the 2D case.  All engine code is
dimension-generic (kernels, cell grids, window sweeps, Morton keys), so
this module only assembles the 3D scene and reuses the same jitted loop
shape as cases/dambreak_2d.py.
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
from sphinxsys_jax.physics import general as gd
from sphinxsys_jax.physics import riemann as rs

DL, DH, DW = 5.366, 2.0, 0.5
LL, LH, LW = 2.0, 1.0, 0.5
RHO0_F = 1.0
GRAVITY_G = 1.0
U_REF = 2.0 * math.sqrt(GRAVITY_G * LH)
C_F = 10.0 * U_REF


class SimState(NamedTuple):
    fluid: Any
    nl_inner: Any
    nl_wall: Any
    time: jnp.ndarray
    n_adv: jnp.ndarray
    n_ac: jnp.ndarray
    overflow: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class Dambreak3DCase:
    dx: float
    adaptation: SPHAdaptation
    grid: Any
    eos: WeaklyCompressibleFluid
    riemann: rs.AcousticRiemannSolver
    gravity: gd.Gravity
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


def build_case(dx: float = 0.05, dtype=jnp.float32, cell_cap: int = 40,
               k_inner: int = 128, k_wall: int = 80):
    BW = 4 * dx
    adaptation = SPHAdaptation(spacing=dx, dim=3)

    water = G.Box(G.Transform(translation=(LL / 2, LH / 2, LW / 2)),
                  halfsize=(LL / 2, LH / 2, LW / 2))
    outer = G.Box(G.Transform(translation=(DL / 2, DH / 2, DW / 2)),
                  halfsize=(DL / 2 + BW, DH / 2 + BW, DW / 2 + BW))
    inner = G.Box(G.Transform(translation=(DL / 2, DH / 2, DW / 2)),
                  halfsize=(DL / 2, DH / 2, DW / 2))
    wall_shape = G.make_complex(("add", outer), ("sub", inner))

    dom_lo = (-BW, -BW, -BW)
    dom_hi = (DL + BW, DH + BW, DW + BW)
    pos_f, vol = generate_lattice(water, dom_lo, dom_hi, dx)
    pos_w, _ = generate_lattice(wall_shape, dom_lo, dom_hi, dx)

    fluid = make_fluid_state(pos_f, vol, RHO0_F, dtype=dtype)
    wall = make_solid_state(pos_w, vol, RHO0_F, dtype=dtype)
    wall = gd.normal_direction_from_shape(wall, wall_shape)

    eos = WeaklyCompressibleFluid(rho0=RHO0_F, c0=C_F)
    gravity = gd.Gravity(acceleration=(0.0, -GRAVITY_G, 0.0))
    fluid = gd.gravity_force(fluid, gravity)

    grid = grid_from_bounds(dom_lo, dom_hi, adaptation.cutoff)
    wall_table = jax.jit(partial(build_cell_table, grid=grid, cap=cell_cap))(
        wall["Position"], wall["NReal"])

    case = Dambreak3DCase(dx=dx, adaptation=adaptation, grid=grid, eos=eos,
                          riemann=rs.acoustic_riemann(eos), gravity=gravity,
                          wall=wall, wall_table=wall_table,
                          n_fluid=len(pos_f), n_wall=len(pos_w),
                          cell_cap=cell_cap, k_inner=k_inner, k_wall=k_wall)
    return case, fluid


def rebuild_relations(case, fluid: State):
    pos = fluid["Position"]
    n = fluid["NReal"]
    table = build_cell_table(pos, n, case.grid, cap=case.cell_cap)
    cutoff = case.adaptation.cutoff
    nl_inner = build_neighbor_list(pos, n, pos, n, table, case.grid, cutoff,
                                   k_max=case.k_inner, include_self=False)
    nl_wall = build_neighbor_list(pos, n, case.wall["Position"], case.wall["NReal"],
                                  case.wall_table, case.grid, cutoff,
                                  k_max=case.k_wall, include_self=True)
    return nl_inner, nl_wall


def init_sim(case, fluid: State) -> SimState:
    nl_inner, nl_wall = jax.jit(partial(rebuild_relations, case))(fluid)
    dtype = fluid["Position"].dtype
    return SimState(fluid=fluid, nl_inner=nl_inner, nl_wall=nl_wall,
                    time=jnp.zeros((), dtype), n_adv=jnp.zeros((), jnp.int32),
                    n_ac=jnp.zeros((), jnp.int32), overflow=jnp.zeros((), bool))


def _advection_step(case, s: SimState) -> SimState:
    kernel, dim = case.kernel, 3
    h = case.adaptation.h
    sigma0 = case.adaptation.sigma0
    fluid = s.fluid

    dt_adv = fd.advection_time_step(fluid, h, U_REF)
    fluid = fd.density_summation(fluid, s.nl_inner, kernel, dim, RHO0_F, sigma0,
                                 contacts=[(case.wall, s.nl_wall, RHO0_F)],
                                 free_surface=True)

    def ac_cond(carry):
        _, rt, _ = carry
        return rt < dt_adv

    def ac_body(carry):
        f, rt, k = carry
        dt = fd.acoustic_time_step(f, case.eos, h)
        f = fd.acoustic_step_1st_half(f, s.nl_inner, kernel, dim, case.eos,
                                      case.riemann, dt, wall=case.wall,
                                      nl_wall=s.nl_wall)
        f = fd.acoustic_step_2nd_half(f, s.nl_inner, kernel, dim, case.riemann,
                                      dt, wall=case.wall, nl_wall=s.nl_wall)
        return (f, rt + dt, k + 1)

    fluid, relax_t, n_ac = jax.lax.while_loop(
        ac_cond, ac_body, (fluid, jnp.zeros_like(dt_adv), jnp.zeros((), jnp.int32)))

    nl_inner, nl_wall = rebuild_relations(case, fluid)
    return SimState(fluid=fluid, nl_inner=nl_inner, nl_wall=nl_wall,
                    time=s.time + relax_t, n_adv=s.n_adv + 1,
                    n_ac=s.n_ac + n_ac,
                    overflow=s.overflow | nl_inner.overflow | nl_wall.overflow)


def make_run_chunk(case):
    @jax.jit
    def run_chunk(s: SimState, t_target) -> SimState:
        return jax.lax.while_loop(lambda st: st.time < t_target,
                                  lambda st: _advection_step(case, st), s)

    return run_chunk


def build_block_case(dx: float = 0.05, dtype=jnp.float32, cap: int = 40,
                     c_max: int | None = None, cap_wall: int | None = None):
    """The same scene on the cell-block engine (engine/scene.py).

    3D capacity notes: a 2.6dx cell holds up to 3 lattice planes per axis
    = 27 particles at t = 0 and the surge front transiently clusters past
    32 (measured at dx=0.1), so the default slot cap is 40; the wall is a
    thin shell (mean occupancy ~9 at dx=0.1) sized by n_wall/4."""
    from sphinxsys_jax.engine import scene as sc

    base, fluid = build_case(dx=dx, dtype=dtype)
    scene = sc.standard_scene(
        base, fluid, rho0=RHO0_F, speed_ref=U_REF, dim=3,
        free_surface=True, wall=base.wall, cap=cap, c_max=c_max,
        cap_wall=cap_wall)
    return scene, fluid
