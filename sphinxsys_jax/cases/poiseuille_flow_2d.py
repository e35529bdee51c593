"""Gravity-driven Poiseuille channel flow (test_2d_poiseuille_flow).

Counterpart of /root/reference/tests/2d_examples/test_2d_poiseuille_flow/
poiseuille_flow.cpp: x-periodic channel DL=6, DH=1, dx=DH/20, rho0=1,
mu=0.1, driven by g = 12 mu U_f / rho / DH^2 (so the steady Poiseuille
centerline speed is 1.5 U_f), kernel-gradient-corrected pressure
relaxation (Integration1stHalfCorrectionWithWallRiemann), 2nd half
no-Riemann, density summation (no free surface), viscous + transport-
velocity corrections.  TotalKineticEnergy is the regression quantity
(steady plateau 3.66 = 0.5 rho DL integral of the parabola squared).

DOCUMENTED DEVIATION: the reference's viscous/TVC use their Corrected
variants (B-matrix weighted); ours are the plain forms — at dx=DH/20
with 4 wall layers the support is complete and the steady balance is
identical; the startup profile is asserted against the analytic Fourier
transient in tests/test_poiseuille.py.
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
from sphinxsys_jax.physics import fluid as fd
from sphinxsys_jax.physics import general as gd
from sphinxsys_jax.physics import riemann as rs

DL = 6.0
DH = 1.0
DX = DH / 20.0
N_WALL_LAYERS = 4

RHO0_F = 1.0
MU_F = 1.0e-1
U_F = 1.0
GRAVITY_G = 12.0 * MU_F * U_F / RHO0_F / DH / DH
U_MAX = 1.5 * U_F
C_F = 10.0 * U_MAX

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
class PoiseuilleCase:
    dx: float
    adaptation: SPHAdaptation
    grid: Any
    eos: WeaklyCompressibleFluid
    riemann: Any
    no_riemann: Any
    wall: Any
    wall_table: Any
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
    xs = np.arange(dx / 2, DL, dx)
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


def build_case(dx: float = DX, dtype=jnp.float32, cell_cap: int = 24,
               k_inner: int = 40, k_wall: int = 24):
    adaptation = SPHAdaptation(spacing=dx, dim=2)
    xs = np.arange(dx / 2, DL, dx)
    ys = np.arange(dx / 2, DH, dx)
    pos = np.stack(np.meshgrid(xs, ys, indexing="ij"), -1).reshape(-1, 2)
    fluid = dict(make_fluid_state(pos, dx * dx, RHO0_F, dtype=dtype))
    g = jnp.zeros_like(fluid["Velocity"]).at[:, 0].set(GRAVITY_G)
    fluid["ForcePrior"] = g * fluid["Mass"][:, None]
    fluid["ViscousForce"] = jnp.zeros((len(pos), 2), dtype)
    fluid["ViscousForcePrev"] = jnp.zeros((len(pos), 2), dtype)
    fluid["LinearGradientCorrectionMatrix"] = jnp.tile(
        jnp.eye(2, dtype=dtype), (len(pos), 1, 1))

    grid = grid_from_bounds(
        (0.0, -(N_WALL_LAYERS + 0.5) * dx),
        (DL, DH + (N_WALL_LAYERS + 0.5) * dx),
        adaptation.cutoff, periodic=(True, False))
    wall = _make_walls(dx, dtype)
    eos = WeaklyCompressibleFluid(rho0=RHO0_F, c0=C_F)
    wall_table = jax.jit(partial(build_cell_table, grid=grid, cap=cell_cap))(
        wall["Position"], wall["NReal"])
    case = PoiseuilleCase(
        dx=dx, adaptation=adaptation, grid=grid, eos=eos,
        riemann=rs.acoustic_riemann(eos), no_riemann=rs.no_riemann(eos),
        wall=wall, wall_table=wall_table, n_fluid=len(pos),
        cell_cap=cell_cap, k_inner=k_inner, k_wall=k_wall)
    return case, fluid


def rebuild_lists(case: PoiseuilleCase, fluid: State):
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


def init_sim(case: PoiseuilleCase, fluid: State) -> SimState:
    pos, nl, nlw = jax.jit(partial(rebuild_lists, case))(fluid)
    fluid = dict(fluid)
    fluid["Position"] = pos
    dtype = pos.dtype
    return SimState(fluid=fluid, nl_inner=nl, nl_wall=nlw,
                    time=jnp.zeros((), dtype),
                    n_adv=jnp.zeros((), jnp.int32),
                    n_ac=jnp.zeros((), jnp.int32),
                    overflow=jnp.zeros((), bool))


def _advection_step(case: PoiseuilleCase, s: SimState) -> SimState:
    kernel, dim = case.kernel, 2
    h = case.adaptation.h
    sigma0 = case.adaptation.sigma0
    box = case.box
    fluid = s.fluid
    wall = case.wall

    dt_adv = fd.advection_viscous_time_step(fluid, h, U_F, RHO0_F, MU_F)
    fluid = fd.density_summation(fluid, s.nl_inner, kernel, dim, RHO0_F,
                                 sigma0, contacts=[(wall, s.nl_wall, RHO0_F)],
                                 free_surface=False, box=box)
    fluid = fd.kernel_correction_matrix(fluid, s.nl_inner, kernel, dim,
                                        wall=wall, nl_wall=s.nl_wall,
                                        alpha=0.5, box=box)
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
        dt = jnp.minimum(fd.acoustic_time_step(f, case.eos, h), dt_adv)
        f = fd.acoustic_step_1st_half(f, s.nl_inner, kernel, dim, case.eos,
                                      case.riemann, dt, wall=wall,
                                      nl_wall=s.nl_wall, box=box,
                                      correction=True)
        f = fd.acoustic_step_2nd_half(f, s.nl_inner, kernel, dim,
                                      case.no_riemann, dt, wall=wall,
                                      nl_wall=s.nl_wall, box=box)
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


def make_run_chunk(case: PoiseuilleCase):
    @jax.jit
    def run_chunk(s: SimState, t_target) -> SimState:
        return jax.lax.while_loop(lambda st: st.time < t_target,
                                  lambda st: _advection_step(case, st), s)

    return run_chunk


def kinetic_energy(s: SimState) -> float:
    f = s.fluid
    valid = np.arange(f["Position"].shape[0]) < int(f["NReal"])
    v2 = np.sum(np.asarray(f["Velocity"])[valid] ** 2, axis=-1)
    m = np.asarray(f["Mass"])[valid]
    return float(0.5 * np.sum(m * v2))


def analytic_profile(y, t, n_terms: int = 60):
    """Startup Poiseuille transient (series solution):
    u(y,t) = (g/2 nu) y (H - y)
             - sum_{n odd} 4 g H^2/(nu pi^3 n^3) sin(n pi y/H) e^{-n^2 pi^2 nu t/H^2}."""
    nu = MU_F / RHO0_F
    u = GRAVITY_G / (2.0 * nu) * y * (DH - y)
    for n in range(1, 2 * n_terms, 2):
        u = u - (4.0 * GRAVITY_G * DH * DH / (nu * math.pi**3 * n**3)
                 * np.sin(n * math.pi * y / DH)
                 * math.exp(-n * n * math.pi**2 * nu * t / DH / DH))
    return u


def mean_profile(case: PoiseuilleCase, s: SimState, n_bins: int | None = None):
    n_bins = n_bins or int(round(DH / case.dx))
    y = np.asarray(s.fluid["Position"][:, 1])
    u = np.asarray(s.fluid["Velocity"][:, 0])
    edges = np.linspace(0.0, DH, n_bins + 1)
    idx = np.clip(np.digitize(y, edges) - 1, 0, n_bins - 1)
    prof = np.zeros(n_bins)
    for b in range(n_bins):
        prof[b] = u[idx == b].mean()
    return 0.5 * (edges[:-1] + edges[1:]), prof
