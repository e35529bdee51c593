"""2D dambreak — the canonical WCSPH free-surface case.

Scene, constants and loop structure mirror the reference case
/root/reference/tests/2d_examples/test_2d_dambreak/Dambreak.cpp:
  * water column 2 x 1 in a 5.366 x 5.366 tank, wall 4*dx thick
  * rho0 = 1, g = 1, U_ref = 2 sqrt(g LH), c = 10 U_ref
  * dual-criteria stepping: outer advection dt (CFL 0.25) with density
    summation, inner acoustic loop (CFL 0.6) of pressure/density
    relaxation with wall contact (Dambreak.cpp:166-220)
  * Morton resort every 100 advection steps, neighbor rebuild each step.

XLA-native structure: the whole "integrate until t_target" loop is ONE
jitted function (`make_run_chunk`) — outer lax.while_loop over advection
steps, inner lax.while_loop over acoustic sub-steps, neighbor rebuild and
periodic spatial sort inside — so the host only syncs once per output
interval.
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
from sphinxsys_jax.core.generators import generate_lattice, generate_observers
from sphinxsys_jax.core.materials import WeaklyCompressibleFluid, Solid
from sphinxsys_jax.core.state import State, make_fluid_state, make_solid_state
from sphinxsys_jax.neighbors import (
    CellGrid, grid_from_bounds, build_cell_table, build_neighbor_list,
)
from sphinxsys_jax.neighbors.cell_list import spatial_sort_permutation
from sphinxsys_jax.physics import fluid as fd
from sphinxsys_jax.physics import general as gd
from sphinxsys_jax.physics import riemann as rs

# case constants (Dambreak.cpp:13-25)
DL = 5.366
DH = 5.366
LL = 2.0
LH = 1.0
RHO0_F = 1.0
GRAVITY_G = 1.0
U_REF = 2.0 * math.sqrt(GRAVITY_G * LH)
C_F = 10.0 * U_REF


class SimState(NamedTuple):
    """Device-side carry of the main loop."""

    fluid: Any           # State dict
    nl_inner: Any        # NeighborList
    nl_wall: Any         # NeighborList
    time: jnp.ndarray    # physical time
    n_adv: jnp.ndarray   # advection step counter
    n_ac: jnp.ndarray    # acoustic step counter
    overflow: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class DambreakCase:
    dx: float
    adaptation: SPHAdaptation
    grid: CellGrid
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
    sort_every: int = 100

    @property
    def kernel(self):
        return self.adaptation.kernel

    @property
    def dim(self):
        return 2


def build_case(dx: float = 0.025, dtype=jnp.float32,
               cell_cap: int = 24, k_inner: int = 64, k_wall: int = 40,
               capacity_multiple: int = 1) -> tuple:
    """Build the scene. Returns (case, fluid_state).  `capacity_multiple`
    pads particle capacities (for sharding over a device mesh)."""
    BW = 4 * dx
    adaptation = SPHAdaptation(spacing=dx, dim=2)

    water_shape = G.Box(G.Transform(translation=(LL / 2, LH / 2)), halfsize=(LL / 2, LH / 2))
    outer = G.Box(G.Transform(translation=(DL / 2, DH / 2)), halfsize=(DL / 2 + BW, DH / 2 + BW))
    inner = G.Box(G.Transform(translation=(DL / 2, DH / 2)), halfsize=(DL / 2, DH / 2))
    wall_shape = G.make_complex(("add", outer), ("sub", inner))

    dom_lo, dom_hi = (-BW, -BW), (DL + BW, DH + BW)
    pos_f, vol = generate_lattice(water_shape, dom_lo, dom_hi, dx)
    pos_w, _ = generate_lattice(wall_shape, dom_lo, dom_hi, dx)

    def _round_up(n, m):
        return ((n + m - 1) // m) * m

    fluid = make_fluid_state(pos_f, vol, RHO0_F, dtype=dtype,
                             capacity=_round_up(len(pos_f), capacity_multiple))
    wall = make_solid_state(pos_w, vol, RHO0_F, dtype=dtype,
                            capacity=_round_up(len(pos_w), capacity_multiple))
    wall = gd.normal_direction_from_shape(wall, wall_shape)

    eos = WeaklyCompressibleFluid(rho0=RHO0_F, c0=C_F)
    riemann = rs.acoustic_riemann(eos)
    gravity = gd.Gravity(acceleration=(0.0, -GRAVITY_G))
    fluid = gd.gravity_force(fluid, gravity)

    grid = grid_from_bounds(dom_lo, dom_hi, adaptation.cutoff)
    wall_table = jax.jit(partial(build_cell_table, grid=grid, cap=cell_cap))(
        wall["Position"], wall["NReal"])

    case = DambreakCase(
        dx=dx, adaptation=adaptation, grid=grid, eos=eos, riemann=riemann,
        gravity=gravity, wall=wall, wall_table=wall_table,
        n_fluid=len(pos_f), n_wall=len(pos_w),
        cell_cap=cell_cap, k_inner=k_inner, k_wall=k_wall,
    )
    return case, fluid


def rebuild_relations(case: DambreakCase, fluid: State):
    """updateCellLinkedList + updateConfiguration (Dambreak.cpp:216-218)."""
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


def init_sim(case: DambreakCase, fluid: State) -> SimState:
    nl_inner, nl_wall = jax.jit(partial(rebuild_relations, case))(fluid)
    zero = jnp.zeros((), jnp.float64 if fluid["Position"].dtype == jnp.float64 else jnp.float32)
    return SimState(fluid=fluid, nl_inner=nl_inner, nl_wall=nl_wall,
                    time=zero, n_adv=jnp.zeros((), jnp.int32),
                    n_ac=jnp.zeros((), jnp.int32),
                    overflow=jnp.zeros((), bool))


def _advection_step(case: DambreakCase, s: SimState) -> SimState:
    kernel, dim = case.kernel, case.dim
    h = case.adaptation.h
    sigma0 = case.adaptation.sigma0
    fluid = s.fluid

    dt_adv = fd.advection_time_step(fluid, h, U_REF)
    fluid = fd.density_summation(
        fluid, s.nl_inner, kernel, dim, RHO0_F, sigma0,
        contacts=[(case.wall, s.nl_wall, RHO0_F)], free_surface=True)

    def ac_cond(carry):
        _, rt, _ = carry
        return rt < dt_adv

    def ac_body(carry):
        f, rt, k = carry
        dt = fd.acoustic_time_step(f, case.eos, h)
        f = fd.acoustic_step_1st_half(f, s.nl_inner, kernel, dim, case.eos,
                                      case.riemann, dt, wall=case.wall,
                                      nl_wall=s.nl_wall)
        f = fd.acoustic_step_2nd_half(f, s.nl_inner, kernel, dim,
                                      case.riemann, dt, wall=case.wall,
                                      nl_wall=s.nl_wall)
        return (f, rt + dt, k + 1)

    fluid, relax_t, n_ac = jax.lax.while_loop(
        ac_cond, ac_body, (fluid, jnp.zeros_like(dt_adv), jnp.zeros((), jnp.int32)))

    n_adv = s.n_adv + 1

    # Morton spatial resort every `sort_every` advection steps
    def do_sort(f):
        perm = spatial_sort_permutation(f["Position"], f["NReal"], case.grid)
        return {k: (v[perm] if getattr(v, "ndim", 0) >= 1 and v.shape[:1] == perm.shape else v)
                for k, v in f.items()}

    fluid = jax.lax.cond(n_adv % case.sort_every == 0, do_sort, lambda f: f, fluid)

    nl_inner, nl_wall = rebuild_relations(case, fluid)
    overflow = s.overflow | nl_inner.overflow | nl_wall.overflow
    return SimState(fluid=fluid, nl_inner=nl_inner, nl_wall=nl_wall,
                    time=s.time + relax_t, n_adv=n_adv,
                    n_ac=s.n_ac + n_ac, overflow=overflow)


def make_run_chunk(case: DambreakCase):
    """Jitted: advance the simulation until `t_target`."""

    @jax.jit
    def run_chunk(s: SimState, t_target) -> SimState:
        def cond(st):
            return st.time < t_target

        def body(st):
            return _advection_step(case, st)

        return jax.lax.while_loop(cond, body, s)

    return run_chunk


def make_advection_step(case: DambreakCase):
    @jax.jit
    def step(s: SimState) -> SimState:
        return _advection_step(case, s)

    return step


def build_block_case(dx: float = 0.025, dtype=jnp.float32, cap: int = 12,
                     c_max: int | None = None, cap_wall: int | None = None):
    """The same scene on the cell-block engine (engine/scene.py) — one
    scene, every engine.  Returns (BlockScene, fluid)."""
    from sphinxsys_jax.engine import scene as sc

    base, fluid = build_case(dx=dx, dtype=dtype)
    scene = sc.standard_scene(
        base, fluid, rho0=RHO0_F, speed_ref=U_REF, dim=2,
        free_surface=True, wall=base.wall, cap=cap, c_max=c_max,
        cap_wall=cap_wall)
    return scene, fluid
