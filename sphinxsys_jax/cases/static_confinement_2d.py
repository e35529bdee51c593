"""2D dambreak with level-set static confinement — no wall particles.

Counterpart of /root/reference/tests/2d_examples/test_2d_static_confinement/
static_confinement.cpp: the standard 5.366x5.366 dambreak tank plus a
triangular ramp obstacle, but every solid boundary is a packaged level set
(NearShapeSurface + StaticConfinement, shape_confinement.h) instead of
dummy particles:

  * density summation  += wall-region kernel integral   (cpp:151-153)
  * pressure relaxation += -2 V p * kernel gradient integral
  * density relaxation  += rho * 2 v . kernel gradient integral
  * ShapeSurfaceBounding projects escapees back each acoustic step

The tank confinement level set is built from the tank-interior polygon
(fluid inside = negative phi; integrals measure the positive/wall region);
the triangle uses InverseShape so its INTERIOR is the wall region
(static_confinement.cpp:147).

Deviation: the reference wires the triangle's density-relaxation op into
the density-summation post-process list (static_confinement.cpp:152) —
an apparent slip; here both confinements contribute to all three stages
symmetrically.
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
from sphinxsys_jax.core.state import State, make_fluid_state
from sphinxsys_jax.meshes.levelset import LevelSetShape, build_levelset
from sphinxsys_jax.neighbors import (CellGrid, build_cell_table,
                                     build_neighbor_list, grid_from_bounds)
from sphinxsys_jax.neighbors.cell_list import spatial_sort_permutation
from sphinxsys_jax.physics import fluid as fd
from sphinxsys_jax.physics import general as gd
from sphinxsys_jax.physics import riemann as rs
from sphinxsys_jax.physics.relax import surface_bounding

# static_confinement.cpp:12-26
DL = 5.366
DH = 5.366
LL = 2.0
LH = 1.0
RHO0_F = 1.0
GRAVITY_G = 1.0
U_REF = 2.0 * math.sqrt(GRAVITY_G * LH)
C_F = 10.0 * U_REF


class SimState(NamedTuple):
    fluid: Any
    nl_inner: Any
    time: jnp.ndarray
    n_adv: jnp.ndarray
    n_ac: jnp.ndarray
    overflow: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class ConfinementCase:
    dx: float
    adaptation: SPHAdaptation
    grid: CellGrid
    eos: WeaklyCompressibleFluid
    riemann: rs.AcousticRiemannSolver
    gravity: gd.Gravity
    ls_wall: LevelSetShape
    ls_triangle: LevelSetShape
    n_fluid: int
    cell_cap: int
    k_inner: int
    sort_every: int = 100

    @property
    def kernel(self):
        return self.adaptation.kernel

    @property
    def levelsets(self):
        return (self.ls_wall, self.ls_triangle)


def triangle_shape() -> G.Shape:
    """createStructureShape (static_confinement.cpp:56-64)."""
    return G.Polygon(vertices=(
        (0.5 * DL, 0.05 * DH),
        (0.5 * DL + 0.5 * LL, 0.05 * DH + 0.5 * LH),
        (0.5 * DL + 0.5 * LL, 0.05 * DH),
    ))


def build_case(dx: float = 0.025, dtype=jnp.float32, cell_cap: int = 24,
               k_inner: int = 64) -> tuple:
    bw = 4 * dx
    adaptation = SPHAdaptation(spacing=dx, dim=2)

    water_shape = G.make_complex(
        ("add", G.Box(G.Transform(translation=(LL / 2, LH / 2)),
                      halfsize=(LL / 2, LH / 2))),
        ("sub", triangle_shape()))
    tank_shape = G.Box(G.Transform(translation=(DL / 2, DH / 2)),
                       halfsize=(DL / 2, DH / 2))

    dom_lo, dom_hi = (-bw, -bw), (DL + bw, DH + bw)
    pos_f, vol = generate_lattice(water_shape, dom_lo, dom_hi, dx)
    fluid = make_fluid_state(pos_f, vol, RHO0_F, dtype=dtype)

    kernel = adaptation.kernel
    ls_wall = LevelSetShape(
        build_levelset(tank_shape, dom_lo, dom_hi, dx, dtype=dtype)
        .update_kernel_integrals(kernel, 2), name="Wall")
    ls_tri = LevelSetShape(
        build_levelset(G.InverseShape(base=triangle_shape()), dom_lo, dom_hi,
                       dx, dtype=dtype)
        .update_kernel_integrals(kernel, 2), name="Triangle")

    eos = WeaklyCompressibleFluid(rho0=RHO0_F, c0=C_F)
    gravity = gd.Gravity(acceleration=(0.0, -GRAVITY_G))
    fluid = gd.gravity_force(fluid, gravity)

    grid = grid_from_bounds(dom_lo, dom_hi, adaptation.cutoff)
    case = ConfinementCase(dx=dx, adaptation=adaptation, grid=grid, eos=eos,
                           riemann=rs.acoustic_riemann(eos), gravity=gravity,
                           ls_wall=ls_wall, ls_triangle=ls_tri,
                           n_fluid=len(pos_f), cell_cap=cell_cap,
                           k_inner=k_inner)
    return case, fluid


def rebuild_relations(case: ConfinementCase, fluid: State):
    pos, n = fluid["Position"], fluid["NReal"]
    table = build_cell_table(pos, n, case.grid, cap=case.cell_cap)
    return build_neighbor_list(pos, n, pos, n, table, case.grid,
                               case.adaptation.cutoff, k_max=case.k_inner,
                               include_self=False)


def init_sim(case: ConfinementCase, fluid: State) -> SimState:
    nl = jax.jit(partial(rebuild_relations, case))(fluid)
    zero = jnp.zeros((), fluid["Position"].dtype)
    return SimState(fluid=fluid, nl_inner=nl, time=zero,
                    n_adv=jnp.zeros((), jnp.int32),
                    n_ac=jnp.zeros((), jnp.int32),
                    overflow=jnp.zeros((), bool))


def _advection_step(case: ConfinementCase, s: SimState) -> SimState:
    kernel, dim = case.kernel, 2
    h = case.adaptation.h
    fluid = s.fluid

    dt_adv = fd.advection_time_step(fluid, h, U_REF)
    fluid = fd.density_summation(fluid, s.nl_inner, kernel, dim, RHO0_F,
                                 case.adaptation.sigma0, free_surface=True,
                                 levelsets=case.levelsets)

    def ac_body(carry):
        f, rt, k = carry
        dt = fd.acoustic_time_step(f, case.eos, h)
        f = fd.acoustic_step_1st_half(f, s.nl_inner, kernel, dim, case.eos,
                                      case.riemann, dt,
                                      levelsets=case.levelsets)
        f = fd.acoustic_step_2nd_half(f, s.nl_inner, kernel, dim,
                                      case.riemann, dt,
                                      levelsets=case.levelsets)
        pos = f["Position"]
        pos = surface_bounding(pos, case.ls_wall, case.dx)
        pos = surface_bounding(pos, case.ls_triangle, case.dx)
        f = dict(f)
        f["Position"] = pos
        return (f, rt + dt, k + 1)

    fluid, relax_t, n_ac = jax.lax.while_loop(
        lambda c: c[1] < dt_adv, ac_body,
        (fluid, jnp.zeros_like(dt_adv), jnp.zeros((), jnp.int32)))

    n_adv = s.n_adv + 1

    def do_sort(f):
        perm = spatial_sort_permutation(f["Position"], f["NReal"], case.grid)
        return {k: (v[perm] if getattr(v, "ndim", 0) >= 1
                    and v.shape[:1] == perm.shape else v)
                for k, v in f.items()}

    fluid = jax.lax.cond(n_adv % case.sort_every == 0, do_sort,
                         lambda f: f, fluid)
    nl = rebuild_relations(case, fluid)
    return SimState(fluid=fluid, nl_inner=nl, time=s.time + relax_t,
                    n_adv=n_adv, n_ac=s.n_ac + n_ac,
                    overflow=s.overflow | nl.overflow)


def make_run_chunk(case: ConfinementCase):
    @jax.jit
    def run_chunk(s: SimState, t_target) -> SimState:
        return jax.lax.while_loop(lambda st: st.time < t_target,
                                  lambda st: _advection_step(case, st), s)

    return run_chunk


def mechanical_energy(case: ConfinementCase, s: SimState) -> float:
    return float(gd.total_mechanical_energy(s.fluid, case.gravity))
