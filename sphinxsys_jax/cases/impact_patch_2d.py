"""2D impact patch — two half-columns of fluid slamming into each other.

Counterpart of /root/reference/tests/2d_examples/test_2d_impact_patch/
impact_patch.cpp: a free LL x LH (0.667 x 2) rectangle of weakly
compressible fluid (c = 100) centered at the origin with vy = -1 on the
top half and vy = +1 on the bottom half (InitialVelocity, cpp:56-75).
The halves collide at y = 0; the vertical momentum cancels and two
lateral jets form while the total kinetic energy drops from 2/3 to the
reference DB's ~0.546 plateau (WaterBody_TotalKineticEnergy).

Op set per the reference (cpp:126-133): alpha=0.5 kernel-gradient
correction, spatial-temporal free-surface indication,
Integration1stHalfCorrectionInnerRiemann / 2ndHalfInnerRiemann,
DensitySummationFreeSurfaceInner, bulk-scoped transport-velocity
correction, advection dt scaled by 0.3 (cpp:201).
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
from sphinxsys_jax.core.state import State, make_fluid_state
from sphinxsys_jax.neighbors import (build_cell_table, build_neighbor_list,
                                     grid_from_bounds)
from sphinxsys_jax.physics import fluid as fd
from sphinxsys_jax.physics import riemann as rs

LL = 0.667          # column width (impact_patch.cpp:12)
LH = 2.0            # column height
RHO0_F = 1.0
U_MAX = 1.0
C_F = 100.0         # impact_patch.cpp:22


class SimState(NamedTuple):
    fluid: Any
    nl_inner: Any
    time: jnp.ndarray
    n_adv: jnp.ndarray
    n_ac: jnp.ndarray
    overflow: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class ImpactPatchCase:
    dx: float
    adaptation: SPHAdaptation
    grid: Any
    eos: WeaklyCompressibleFluid
    riemann: Any
    n_fluid: int
    cell_cap: int
    k_inner: int

    @property
    def kernel(self):
        return self.adaptation.kernel


def build_case(dx: float = LL / 25.0, dtype=jnp.float32, cell_cap: int = 24,
               k_inner: int = 48, half_span: float = 3.2):
    adaptation = SPHAdaptation(spacing=dx, dim=2)
    xs = np.arange(-LL / 2 + dx / 2, LL / 2, dx)
    ys = np.arange(-LH / 2 + dx / 2, LH / 2, dx)
    pos = np.stack(np.meshgrid(xs, ys, indexing="ij"), -1).reshape(-1, 2)
    fluid = dict(make_fluid_state(pos, dx * dx, RHO0_F, dtype=dtype))
    vel = np.zeros_like(pos)
    vel[:, 1] = np.where(pos[:, 1] >= 0.0, -1.0, 1.0)
    fluid["Velocity"] = jnp.asarray(vel, dtype)
    n = len(pos)
    fluid["Indicator"] = jnp.zeros((n,), jnp.int32)
    fluid["PreviousSurfaceIndicator"] = jnp.ones((n,), jnp.int32)
    fluid["PositionDivergence"] = jnp.zeros((n,), dtype)
    fluid["LinearGradientCorrectionMatrix"] = jnp.tile(
        jnp.eye(2, dtype=dtype), (n, 1, 1))

    grid = grid_from_bounds((-half_span, -half_span), (half_span, half_span),
                            adaptation.cutoff)
    eos = WeaklyCompressibleFluid(rho0=RHO0_F, c0=C_F)
    case = ImpactPatchCase(dx=dx, adaptation=adaptation, grid=grid, eos=eos,
                           riemann=rs.acoustic_riemann(eos), n_fluid=n,
                           cell_cap=cell_cap, k_inner=k_inner)
    return case, fluid


def rebuild_lists(case: ImpactPatchCase, fluid: State):
    pos = fluid["Position"]
    n = fluid["NReal"]
    table = build_cell_table(pos, n, case.grid, cap=case.cell_cap)
    return build_neighbor_list(pos, n, pos, n, table, case.grid,
                               case.adaptation.cutoff, k_max=case.k_inner,
                               include_self=False)


def init_sim(case: ImpactPatchCase, fluid: State) -> SimState:
    nl = jax.jit(partial(rebuild_lists, case))(fluid)
    dtype = fluid["Position"].dtype
    return SimState(fluid=fluid, nl_inner=nl, time=jnp.zeros((), dtype),
                    n_adv=jnp.zeros((), jnp.int32),
                    n_ac=jnp.zeros((), jnp.int32),
                    overflow=jnp.zeros((), bool))


def _advection_step(case: ImpactPatchCase, s: SimState) -> SimState:
    kernel, dim = case.kernel, 2
    h = case.adaptation.h
    sigma0 = case.adaptation.sigma0
    fluid = s.fluid

    dt_adv = 0.3 * fd.advection_time_step(fluid, h, U_MAX)  # cpp:201
    fluid = fd.free_surface_indication(fluid, s.nl_inner, kernel, dim,
                                       spatial_temporal=True)
    fluid = fd.density_summation(fluid, s.nl_inner, kernel, dim, RHO0_F,
                                 sigma0, free_surface=True)
    fluid = fd.kernel_correction_matrix(fluid, s.nl_inner, kernel, dim,
                                        alpha=0.5)
    fluid = fd.transport_velocity_correction(
        fluid, s.nl_inner, kernel, dim, h, limiter_slope=None,
        scope_mask=fluid["Indicator"] == 0)

    def ac_cond(carry):
        _, rt, _ = carry
        return rt < dt_adv

    def ac_body(carry):
        f, rt, k = carry
        dt = jnp.minimum(fd.acoustic_time_step(f, case.eos, h), dt_adv)
        f = fd.acoustic_step_1st_half(f, s.nl_inner, kernel, dim, case.eos,
                                      case.riemann, dt, correction=True)
        f = fd.acoustic_step_2nd_half(f, s.nl_inner, kernel, dim,
                                      case.riemann, dt)
        return (f, rt + dt, k + 1)

    fluid, relax_t, n_ac = jax.lax.while_loop(
        ac_cond, ac_body,
        (fluid, jnp.zeros_like(dt_adv), jnp.zeros((), jnp.int32)))

    nl = rebuild_lists(case, fluid)
    return SimState(fluid=fluid, nl_inner=nl, time=s.time + relax_t,
                    n_adv=s.n_adv + 1, n_ac=s.n_ac + n_ac,
                    overflow=s.overflow | nl.overflow)


def make_run_chunk(case: ImpactPatchCase):
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
