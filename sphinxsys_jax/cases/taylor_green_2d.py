"""2D Taylor-Green vortex — periodic viscous flow.

Scene and loop mirror the reference case
/root/reference/tests/2d_examples/test_2d_taylor_green/taylor_green.cpp:
  * unit box, doubly periodic, dx = 1/100 (configurable)
  * rho0 = 1, U = 1, c = 10, Re = 100 -> mu = 0.01
  * initial velocity u = -cos(2 pi x) sin(2 pi y), v = sin(2 pi x) cos(2 pi y)
  * outer advection step: dt_adv (viscous-aware CFL), density summation
    (plain, with Vol update), viscous force, transport-velocity correction
    (TruncatedLinear limiter); inner acoustic loop: 1st half with acoustic
    Riemann, 2nd half with NO Riemann dissipation, dt = min(dt_ac, dt_adv)
  * analytic decay: vel ~ exp(-8 pi^2 nu t) — the physics oracle.

XLA-native periodicity: no ghost images — cell windows wrap modulo the
grid and pair displacements use the minimum-image convention
(neighbors/cell_list.py CellGrid.periodic).
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
from sphinxsys_jax.core.state import State, make_fluid_state
from sphinxsys_jax.neighbors import grid_from_bounds, build_cell_table, build_neighbor_list
from sphinxsys_jax.neighbors.cell_list import wrap_positions, spatial_sort_permutation
from sphinxsys_jax.physics import fluid as fd
from sphinxsys_jax.physics import riemann as rs

DL = 1.0
DH = 1.0
RHO0_F = 1.0
U_F = 1.0
C_F = 10.0 * U_F
RE = 100.0
MU_F = RHO0_F * U_F * DL / RE


class SimState(NamedTuple):
    fluid: Any
    nl_inner: Any
    time: jnp.ndarray
    n_adv: jnp.ndarray
    n_ac: jnp.ndarray
    overflow: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class TaylorGreenCase:
    dx: float
    adaptation: SPHAdaptation
    grid: Any
    eos: WeaklyCompressibleFluid
    riemann: rs.AcousticRiemannSolver
    no_riemann: rs.NoRiemannSolver
    n_fluid: int
    cell_cap: int
    k_inner: int
    sort_every: int = 100

    @property
    def kernel(self):
        return self.adaptation.kernel

    @property
    def box(self):
        return self.grid.periodic_lengths


def build_case(dx: float = 0.01, dtype=jnp.float32, cell_cap: int = 24,
               k_inner: int = 64, relax_ic: int = 0):
    """`relax_ic`: number of particle-relaxation iterations on the periodic
    box before sampling the velocity field — the reference case starts from
    a RELAXED distribution (its regression DB has max|v| = 0.903 at t=0
    because no particle sits exactly on a velocity extremum)."""
    adaptation = SPHAdaptation(spacing=dx, dim=2)
    shape = G.Box(G.Transform(translation=(DL / 2, DH / 2)), halfsize=(DL / 2, DH / 2))
    pos, vol = generate_lattice(shape, (0.0, 0.0), (DL, DH), dx)

    grid = grid_from_bounds((0.0, 0.0), (DL, DH), adaptation.cutoff,
                            periodic=(True, True))
    if relax_ic > 0:
        from sphinxsys_jax.physics.relax import relax_periodic

        pos = np.asarray(relax_periodic(
            jnp.asarray(np.asarray(pos), dtype), float(vol), adaptation, grid,
            n_iterations=relax_ic, cell_cap=max(cell_cap, 32),
            k_max=k_inner, box=grid.periodic_lengths))
    fluid = make_fluid_state(pos, vol, RHO0_F, dtype=dtype)

    # Taylor-Green initial velocity (taylor_green.cpp:50-57)
    p = np.asarray(pos)
    vel = np.stack([
        -np.cos(2 * math.pi * p[:, 0]) * np.sin(2 * math.pi * p[:, 1]),
        np.sin(2 * math.pi * p[:, 0]) * np.cos(2 * math.pi * p[:, 1]),
    ], axis=-1)
    fluid = dict(fluid)
    fluid["Velocity"] = jnp.asarray(vel, dtype=dtype)
    # pre-register the viscous ForcePrior bookkeeping keys so the pytree
    # structure is stable across while_loop iterations
    fluid["ViscousForce"] = jnp.zeros_like(fluid["Velocity"])
    fluid["ViscousForcePrev"] = jnp.zeros_like(fluid["Velocity"])

    eos = WeaklyCompressibleFluid(rho0=RHO0_F, c0=C_F)
    case = TaylorGreenCase(dx=dx, adaptation=adaptation, grid=grid, eos=eos,
                           riemann=rs.acoustic_riemann(eos),
                           no_riemann=rs.no_riemann(eos),
                           n_fluid=len(pos), cell_cap=cell_cap, k_inner=k_inner)
    return case, fluid


def rebuild_inner(case: TaylorGreenCase, fluid: State):
    pos = wrap_positions(fluid["Position"], case.grid)
    n = fluid["NReal"]
    table = build_cell_table(pos, n, case.grid, cap=case.cell_cap)
    nl = build_neighbor_list(pos, n, pos, n, table, case.grid,
                             case.adaptation.cutoff, k_max=case.k_inner,
                             include_self=False)
    return pos, nl


def init_sim(case: TaylorGreenCase, fluid: State) -> SimState:
    pos, nl = jax.jit(partial(rebuild_inner, case))(fluid)
    fluid = dict(fluid)
    fluid["Position"] = pos
    dtype = pos.dtype
    return SimState(fluid=fluid, nl_inner=nl, time=jnp.zeros((), dtype),
                    n_adv=jnp.zeros((), jnp.int32), n_ac=jnp.zeros((), jnp.int32),
                    overflow=jnp.zeros((), bool))


def _advection_step(case: TaylorGreenCase, s: SimState) -> SimState:
    kernel, dim = case.kernel, 2
    h = case.adaptation.h
    sigma0 = case.adaptation.sigma0
    box = case.box
    fluid = s.fluid

    dt_adv = fd.advection_viscous_time_step(fluid, h, U_F, RHO0_F, MU_F)
    fluid = fd.density_summation(fluid, s.nl_inner, kernel, dim, RHO0_F, sigma0,
                                 free_surface=False, box=box)
    fluid = fd.viscous_force(fluid, s.nl_inner, kernel, dim, MU_F, h, box=box)
    fluid = fd.transport_velocity_correction(fluid, s.nl_inner, kernel, dim, h,
                                             limiter_slope=100.0, box=box)

    def ac_cond(carry):
        _, rt, _ = carry
        return rt < dt_adv

    def ac_body(carry):
        f, rt, k = carry
        dt = jnp.minimum(fd.acoustic_time_step(f, case.eos, h), dt_adv)
        f = fd.acoustic_step_1st_half(f, s.nl_inner, kernel, dim, case.eos,
                                      case.riemann, dt, box=box)
        f = fd.acoustic_step_2nd_half(f, s.nl_inner, kernel, dim,
                                      case.no_riemann, dt, box=box)
        return (f, rt + dt, k + 1)

    fluid, relax_t, n_ac = jax.lax.while_loop(
        ac_cond, ac_body, (fluid, jnp.zeros_like(dt_adv), jnp.zeros((), jnp.int32)))

    n_adv = s.n_adv + 1

    def do_sort(f):
        perm = spatial_sort_permutation(f["Position"], f["NReal"], case.grid)
        return {k: (v[perm] if getattr(v, "ndim", 0) >= 1 and v.shape[:1] == perm.shape else v)
                for k, v in f.items()}

    fluid = jax.lax.cond(n_adv % case.sort_every == 0, do_sort, lambda f: f, fluid)

    pos, nl = rebuild_inner(case, fluid)
    fluid = dict(fluid)
    fluid["Position"] = pos
    return SimState(fluid=fluid, nl_inner=nl, time=s.time + relax_t,
                    n_adv=n_adv, n_ac=s.n_ac + n_ac,
                    overflow=s.overflow | nl.overflow)


def make_run_chunk(case: TaylorGreenCase):
    @jax.jit
    def run_chunk(s: SimState, t_target) -> SimState:
        return jax.lax.while_loop(lambda st: st.time < t_target,
                                  lambda st: _advection_step(case, st), s)

    return run_chunk


def build_block_case(dx: float = 0.01, dtype=jnp.float32, cap: int = 12,
                     c_max: int | None = None, relax_ic: int = 0):
    """The same doubly-periodic scene on the cell-block engine
    (engine/scene.py).  The periodic box is fully occupied (every cell
    holds particles)."""
    from sphinxsys_jax.engine import scene as sc

    base, fluid = build_case(dx=dx, dtype=dtype, relax_ic=relax_ic)
    scene = sc.standard_scene(
        base, fluid, rho0=RHO0_F, speed_ref=U_F, dim=2, mu=MU_F,
        tvc_coef=0.2, tvc_limiter=100.0, free_surface=False,
        riemann2=base.no_riemann, cap=cap, c_max=c_max, cap_ac_dt=True,
        wrap=True)
    return scene, fluid
