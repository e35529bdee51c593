"""2D standing wave in a closed tank + wave-gauge probe.

Mirrors /root/reference/tests/2d_examples/test_2d_standing_wave/
standing_wave.cpp: a 2 x 2 tank filled to the cosine-perturbed surface
y = 1 + 0.1 cos(pi x); rho0 = 1000, g = 9.81, dx = 0.02, the dambreak
dual-criteria loop verbatim.  Observables (both with committed reference
DTW databases): WaterBody_TotalMechanicalEnergy and a wave gauge at
x = 1 reporting FreeSurfaceHeight — the UpperFrontInAxisDirection reduce
over a BodyRegionByCell column of half-width 1.3 dx
(general_reduce.h:78-100).

Oracle: the first-mode standing wave has omega^2 = g k tanh(k h) with
k = pi, h = 1  =>  T = 2 pi / sqrt(9.81 pi tanh(pi)) ~ 1.135 s; the
gauge sits at the cos(pi x) trough antinode and oscillates at that
period.
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
from sphinxsys_jax.core.materials import WeaklyCompressibleFluid
from sphinxsys_jax.core.state import State, make_fluid_state, make_solid_state
from sphinxsys_jax.neighbors import (build_cell_table, build_neighbor_list,
                                     grid_from_bounds)
from sphinxsys_jax.physics import fluid as fd
from sphinxsys_jax.physics import general as gd
from sphinxsys_jax.physics import riemann as rs

DL = 2.0
DH = 2.0
LH = 1.0                    # mean water depth
AMP = 0.1                   # surface perturbation amplitude
RHO0_F = 1000.0
GRAVITY_G = 9.81
U_REF = 2.0 * math.sqrt(GRAVITY_G * LH)
C_F = 10.0 * U_REF
# analytic first-mode period (finite-depth dispersion)
K1 = math.pi
OMEGA1 = math.sqrt(GRAVITY_G * K1 * math.tanh(K1 * LH))
T1 = 2.0 * math.pi / OMEGA1


class SimState(NamedTuple):
    fluid: Any
    nl_inner: Any
    nl_wall: Any
    time: jnp.ndarray
    n_adv: jnp.ndarray
    n_ac: jnp.ndarray
    overflow: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class StandingWaveCase:
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


def build_case(dx: float = 0.02, dtype=jnp.float32, cell_cap: int = 24,
               k_inner: int = 64, k_wall: int = 40):
    BW = 4 * dx
    adaptation = SPHAdaptation(spacing=dx, dim=2)

    # lattice under the perturbed surface (standing_wave.cpp:50-73)
    xs = np.arange(dx / 2, DL, dx)
    ys = np.arange(dx / 2, DH, dx)
    pos = np.stack(np.meshgrid(xs, ys, indexing="ij"), -1).reshape(-1, 2)
    surf = LH + AMP * np.cos(np.pi * pos[:, 0])
    pos_f = pos[pos[:, 1] < surf]

    outer = G.Box(G.Transform(translation=(DL / 2, DH / 2)),
                  halfsize=(DL / 2 + BW, DH / 2 + BW))
    inner = G.Box(G.Transform(translation=(DL / 2, DH / 2)),
                  halfsize=(DL / 2, DH / 2))
    wall_shape = G.make_complex(("add", outer), ("sub", inner))
    dom_lo, dom_hi = (-BW, -BW), (DL + BW, DH + BW)
    from sphinxsys_jax.core.generators import generate_lattice

    pos_w, _ = generate_lattice(wall_shape, dom_lo, dom_hi, dx)

    fluid = make_fluid_state(pos_f, dx * dx, RHO0_F, dtype=dtype)
    fluid = dict(fluid)
    fluid["LinearGradientCorrectionMatrix"] = jnp.tile(
        jnp.eye(2, dtype=dtype), (len(pos_f), 1, 1))
    wall = make_solid_state(pos_w, dx * dx, RHO0_F, dtype=dtype)
    wall = gd.normal_direction_from_shape(wall, wall_shape)

    eos = WeaklyCompressibleFluid(rho0=RHO0_F, c0=C_F)
    gravity = gd.Gravity(acceleration=(0.0, -GRAVITY_G))
    fluid = gd.gravity_force(fluid, gravity)

    grid = grid_from_bounds(dom_lo, dom_hi, adaptation.cutoff)
    wall_table = jax.jit(partial(build_cell_table, grid=grid,
                                 cap=cell_cap))(wall["Position"],
                                                wall["NReal"])

    case = StandingWaveCase(dx=dx, adaptation=adaptation, grid=grid, eos=eos,
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
    nl_wall = build_neighbor_list(pos, n, case.wall["Position"],
                                  case.wall["NReal"], case.wall_table,
                                  case.grid, cutoff, k_max=case.k_wall,
                                  include_self=True)
    return nl_inner, nl_wall


def init_sim(case, fluid: State) -> SimState:
    nl_inner, nl_wall = jax.jit(partial(rebuild_relations, case))(fluid)
    dtype = fluid["Position"].dtype
    return SimState(fluid=fluid, nl_inner=nl_inner, nl_wall=nl_wall,
                    time=jnp.zeros((), dtype), n_adv=jnp.zeros((), jnp.int32),
                    n_ac=jnp.zeros((), jnp.int32),
                    overflow=jnp.zeros((), bool))


def _advection_step(case, s: SimState) -> SimState:
    kernel, dim = case.kernel, 2
    h = case.adaptation.h
    sigma0 = case.adaptation.sigma0
    fluid = s.fluid

    # the reference scales the advection criterion by 0.3 AND runs the
    # kernel-gradient-CORRECTED pressure relaxation with the alpha=0.5
    # regularized correction matrix (standing_wave.cpp:151-153,226-228) —
    # both are load-bearing for wave-energy conservation: the uncorrected
    # force at the full advection dt damps the gauge amplitude from
    # ~0.11 sustained to ~0.04 by t=10
    dt_adv = 0.3 * fd.advection_time_step(fluid, h, U_REF)
    fluid = fd.density_summation(fluid, s.nl_inner, kernel, dim, RHO0_F,
                                 sigma0,
                                 contacts=[(case.wall, s.nl_wall, RHO0_F)],
                                 free_surface=True)
    fluid = fd.kernel_correction_matrix(fluid, s.nl_inner, kernel, dim,
                                        wall=case.wall, nl_wall=s.nl_wall,
                                        alpha=0.5)

    def ac_cond(carry):
        _, rt, _ = carry
        return rt < dt_adv

    def ac_body(carry):
        f, rt, k = carry
        dt = fd.acoustic_time_step(f, case.eos, h)
        f = fd.acoustic_step_1st_half(f, s.nl_inner, kernel, dim, case.eos,
                                      case.riemann, dt, wall=case.wall,
                                      nl_wall=s.nl_wall, correction=True)
        f = fd.acoustic_step_2nd_half(f, s.nl_inner, kernel, dim,
                                      case.riemann, dt, wall=case.wall,
                                      nl_wall=s.nl_wall)
        return (f, rt + dt, k + 1)

    fluid, relax_t, n_ac = jax.lax.while_loop(
        ac_cond, ac_body,
        (fluid, jnp.zeros_like(dt_adv), jnp.zeros((), jnp.int32)))

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


def free_surface_height(case, fluid: State, x_gauge: float = 1.0,
                        half_width: float | None = None):
    """FreeSurfaceHeight wave gauge (standing_wave.cpp:85-101 +
    general_reduce.h UpperFrontInAxisDirection): the max y over particles
    inside the gauge column |x - x_gauge| <= 1.3 dx."""
    hw = half_width if half_width is not None else 1.3 * case.dx
    pos = fluid["Position"]
    n = fluid["NReal"]
    valid = jnp.arange(pos.shape[0]) < n
    in_col = valid & (jnp.abs(pos[:, 0] - x_gauge) <= hw)
    return jnp.max(jnp.where(in_col, pos[:, 1], -jnp.inf))
