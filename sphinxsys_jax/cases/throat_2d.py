"""Oldroyd-B viscoelastic flow through a channel with a throat.

Counterpart of /root/reference/tests/2d_examples/test_2d_throat/throat.cpp:
an x-periodic channel (DL=24, DH=4) necking down to a DT=1 throat over the
middle third, filled with an Oldroyd-B fluid (mu from Re=0.001,
mu_p=0.6 mu, lambda=10) and driven by a body force g=1 along x.  Per
acoustic step (throat.cpp:244-256):

    implicit pairwise viscous damping (inner + wall, eta = mu)
    Oldroyd-B 1st half  = Riemann pressure relaxation + polymeric force
    velocity-gradient update (with wall, near-wall extrapolation factor)
    Oldroyd-B 2nd half  = Riemann density relaxation + UCM stress rate

The elastic-stress ops live in physics/oldroyd.py; the near-wall velocity
gradient factor uses the exact wall-shape SDF for DistanceFromWall in
place of the reference's particle reconstruction (near_wall_boundary.cpp)
— the wall geometry here is analytic.

Periodicity: min-image pair geometry + position wrapping over DL (the
XLA-native equivalent of the reference's ghost-particle periodic buffers).
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
from sphinxsys_jax.physics import dissipation as dp
from sphinxsys_jax.physics import fluid as fd
from sphinxsys_jax.physics import general as gd
from sphinxsys_jax.physics import oldroyd as ob
from sphinxsys_jax.physics import riemann as rs
from sphinxsys_jax.physics import viscosity as vc

# throat.cpp:20-41
DH = 4.0     # channel height
DT = 1.0     # throat height
DL = 24.0    # channel length (periodic)
DX = 0.1
BW = 4 * DX
RHO0_F = 1.0
GRAVITY_G = 1.0
RE = 0.001
MU_F = RHO0_F * math.sqrt(0.5 * RHO0_F * (0.5 * DH) ** 3 * GRAVITY_G / RE)
U_C = 0.5 * (0.5 * DH) ** 2 * GRAVITY_G * RHO0_F / MU_F
U_F = U_C * DH / DT
C_F = 10.0 * max(U_F, math.sqrt(MU_F / RHO0_F * U_F / DT))
MODEL = vc.OldroydBViscosity(mu=MU_F, relaxation_time=10.0, mu_p=0.6 * MU_F)


class SimState(NamedTuple):
    fluid: Any
    nl_inner: Any
    nl_wall: Any
    time: jnp.ndarray
    n_adv: jnp.ndarray
    overflow: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class ThroatCase:
    dx: float
    adaptation: SPHAdaptation
    grid: Any
    eos: WeaklyCompressibleFluid
    riemann: Any
    wall: Any
    wall_table: Any
    wall_shape: Any
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


def _fluid_shape():
    """Three add-polygons (throat.cpp FluidBlock): wide left, throat band
    (overlapping the blocks by BW), wide right."""
    return G.make_complex(
        ("add", G.Box(G.Transform(translation=(-DL / 3.0, 0.0)),
                      halfsize=(DL / 6.0, DH / 2.0))),
        ("add", G.Box(G.Transform(translation=(0.0, 0.0)),
                      halfsize=(DL / 6.0 + BW, DT / 2.0))),
        ("add", G.Box(G.Transform(translation=(DL / 3.0, 0.0)),
                      halfsize=(DL / 6.0, DH / 2.0))))


def _wall_shape():
    """Bounding box minus the fluid channel, the fluid blocks extended
    past the periodic seam (throat.cpp WallBoundary)."""
    return G.make_complex(
        ("add", G.Box(G.Transform(translation=(0.0, 0.0)),
                      halfsize=(DL / 2.0 + BW, DH / 2.0 + BW))),
        ("sub", G.Box(G.Transform(translation=(-DL / 3.0 - BW, 0.0)),
                      halfsize=(DL / 6.0 + BW, DH / 2.0))),
        ("sub", G.Box(G.Transform(translation=(0.0, 0.0)),
                      halfsize=(DL / 6.0 + BW, DT / 2.0))),
        ("sub", G.Box(G.Transform(translation=(DL / 3.0 + BW, 0.0)),
                      halfsize=(DL / 6.0 + BW, DH / 2.0))))


def build_case(dx: float = DX, dtype=jnp.float32, cell_cap: int = 24,
               k_inner: int = 40, k_wall: int = 24):
    adaptation = SPHAdaptation(spacing=dx, dim=2)
    dom_lo = (-DL / 2.0, -DH / 2.0 - BW)
    dom_hi = (DL / 2.0, DH / 2.0 + BW)

    pos_f, vol = generate_lattice(_fluid_shape(), dom_lo, dom_hi, dx)
    # periodic domain: keep x strictly inside [-DL/2, DL/2)
    keep = (pos_f[:, 0] >= -DL / 2.0) & (pos_f[:, 0] < DL / 2.0)
    pos_f = pos_f[keep]
    fluid = dict(make_fluid_state(pos_f, vol, RHO0_F, dtype=dtype))
    n = len(pos_f)
    g = jnp.zeros_like(fluid["Velocity"]).at[:, 0].set(GRAVITY_G)
    fluid["ForcePrior"] = g * fluid["Mass"][:, None]
    fluid = ob.register_variables(fluid, 2)

    wall_shape = _wall_shape()
    pos_w, _ = generate_lattice(wall_shape, (-DL / 2.0 - BW, dom_lo[1]),
                                (DL / 2.0 + BW, dom_hi[1]), dx)
    keep_w = (pos_w[:, 0] >= -DL / 2.0) & (pos_w[:, 0] < DL / 2.0)
    pos_w = pos_w[keep_w]
    wall = dict(make_solid_state(pos_w, vol, RHO0_F, dtype=dtype))
    wall = gd.normal_direction_from_shape(wall, wall_shape)

    grid = grid_from_bounds(dom_lo, dom_hi, adaptation.cutoff,
                            periodic=(True, False))
    eos = WeaklyCompressibleFluid(rho0=RHO0_F, c0=C_F)
    wall_table = jax.jit(partial(build_cell_table, grid=grid, cap=cell_cap))(
        wall["Position"], wall["NReal"])
    case = ThroatCase(dx=dx, adaptation=adaptation, grid=grid, eos=eos,
                      riemann=rs.acoustic_riemann(eos), wall=wall,
                      wall_table=wall_table, wall_shape=wall_shape,
                      n_fluid=n, cell_cap=cell_cap, k_inner=k_inner,
                      k_wall=k_wall)
    return case, fluid


def rebuild_lists(case: ThroatCase, fluid: State):
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


def init_sim(case: ThroatCase, fluid: State) -> SimState:
    pos, nl, nlw = jax.jit(partial(rebuild_lists, case))(fluid)
    fluid = dict(fluid)
    fluid["Position"] = pos
    return SimState(fluid=fluid, nl_inner=nl, nl_wall=nlw,
                    time=jnp.zeros((), pos.dtype),
                    n_adv=jnp.zeros((), jnp.int32),
                    overflow=jnp.zeros((), bool))


def _distance_from_wall(case: ThroatCase, pos):
    """Exact SDF-based DistanceFromWall: vector from the nearest wall
    surface point to the particle (positive sd = in the fluid)."""
    sd1 = lambda p: case.wall_shape.signed_distance(p[None])[0]
    sd = case.wall_shape.signed_distance(pos)
    n = jax.vmap(jax.grad(sd1))(pos)
    n = n / (jnp.linalg.norm(n, axis=-1, keepdims=True) + 1e-12)
    return sd[:, None] * n


def _advection_step(case: ThroatCase, s: SimState) -> SimState:
    kernel, dim = case.kernel, 2
    h = case.adaptation.h
    box = case.box
    fluid = s.fluid
    wall = case.wall
    walls = [(wall, s.nl_wall)]

    dt_adv = fd.advection_time_step(fluid, h, U_F)
    fluid = fd.density_summation(fluid, s.nl_inner, kernel, dim, RHO0_F,
                                 case.adaptation.sigma0,
                                 contacts=[(wall, s.nl_wall, RHO0_F)],
                                 free_surface=False, box=box)
    fluid = fd.transport_velocity_correction(fluid, s.nl_inner, kernel, dim,
                                             h, limiter_slope=100.0,
                                             walls=walls, box=box)
    dfw = _distance_from_wall(case, fluid["Position"])

    def ac_body(carry):
        f, rt = carry
        dt = jnp.minimum(fd.acoustic_time_step(f, case.eos, h), dt_adv)
        # implicit viscous damping (inner + from wall), throat.cpp:248.
        # Deep-implicit regime (Re = 1e-3: nu dt/h^2 ~ 40): the exact CG
        # backward-Euler solve — the Jacobi splitting saturates at ~40%
        # of the nominal viscosity here (see dissipation.damping_implicit_cg
        # and PROGRESS.md r5), which was the +30% KE plateau of r3/r4
        f = dp.damping_implicit_cg(f, "Velocity", s.nl_inner, kernel, dim,
                                   MU_F, dt, walls=[(wall, s.nl_wall, None)],
                                   box=box)
        # Oldroyd-B 1st half
        f = ob.stress_half_step(f, dt)
        f_mid = dict(f)
        f_mid["Position"] = f["Position"] + f["Velocity"] * (0.5 * dt)
        ef = ob.elastic_stress_force(f_mid, s.nl_inner, kernel, dim,
                                     wall=wall, nl_wall=s.nl_wall, box=box)
        f = fd.acoustic_step_1st_half(f, s.nl_inner, kernel, dim, case.eos,
                                      case.riemann, dt, wall=wall,
                                      nl_wall=s.nl_wall, box=box,
                                      extra_force=ef)
        # velocity gradient between the halves (throat.cpp:250)
        f = dict(f)
        f["VelocityGradient"] = gd.velocity_gradient(
            f, s.nl_inner, kernel, dim, box=box, walls=walls,
            distance_from_wall=dfw)
        # Oldroyd-B 2nd half
        f = fd.acoustic_step_2nd_half(f, s.nl_inner, kernel, dim,
                                      case.riemann, dt, wall=wall,
                                      nl_wall=s.nl_wall, box=box)
        f = ob.stress_rate(f, MODEL)
        f = ob.stress_half_step(f, dt)
        return (f, rt + dt)

    fluid, relax_t = jax.lax.while_loop(
        lambda c: c[1] < dt_adv, ac_body, (fluid, jnp.zeros_like(dt_adv)))

    pos, nl, nlw = rebuild_lists(case, fluid)
    fluid = dict(fluid)
    fluid["Position"] = pos
    return SimState(fluid=fluid, nl_inner=nl, nl_wall=nlw,
                    time=s.time + relax_t, n_adv=s.n_adv + 1,
                    overflow=s.overflow | nl.overflow | nlw.overflow)


def make_run_chunk(case: ThroatCase):
    @jax.jit
    def run_chunk(s: SimState, t_target) -> SimState:
        return jax.lax.while_loop(lambda st: st.time < t_target,
                                  lambda st: _advection_step(case, st), s)

    return run_chunk


def kinetic_energy(s: SimState) -> float:
    """ReducedQuantityRecording<TotalKineticEnergy> (throat.cpp:205)."""
    f = s.fluid
    v2 = jnp.sum(f["Velocity"] ** 2, axis=-1)
    return float(0.5 * jnp.sum(f["Mass"] * v2))
