"""Rotating square patch (test_2d_rotation_patch).

Counterpart of /root/reference/tests/2d_examples/test_2d_rotation_patch/
rotation_patch.cpp: a free 1x1 square of weakly compressible fluid
centered at the origin, started in rigid rotation (omega = 1) with the
consistent initial pressure field (the double-sine series that satisfies
the pressure Poisson equation for the rotating square,
rotation_patch.cpp:66-90), and left to deform freely: the corners are
thrown outward into four arms while the total kinetic energy stays at
its initial 1/12 (the reference's DB holds 0.0830-0.0837 over t=0..8).

Op set per the reference (cpp:147-152): spatial-temporal free-surface
indication, alpha=0.5 kernel-gradient correction,
Integration1stHalfCorrectionInnerRiemann / 2ndHalfInnerRiemann,
free-stream density summation, bulk-scoped no-limiter transport-velocity
correction — all inner-only (no walls).
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
from sphinxsys_jax.core.state import State, make_fluid_state
from sphinxsys_jax.neighbors import (build_cell_table, build_neighbor_list,
                                     grid_from_bounds)
from sphinxsys_jax.physics import fluid as fd
from sphinxsys_jax.physics import riemann as rs

LL = 1.0
OMEGA = 1.0
RHO0_F = 1.0
U_MAX = 1.0
C_F = 10.0 * U_MAX

TINY = 1.0e-12


class SimState(NamedTuple):
    fluid: Any
    nl_inner: Any
    time: jnp.ndarray
    n_adv: jnp.ndarray
    n_ac: jnp.ndarray
    overflow: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class RotationPatchCase:
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


def _initial_pressure(pos, n_modes: int = 21):
    """Consistent initial pressure for the rotating square
    (rotation_patch.cpp:73-86): p = sum_{m,n odd} rho (-32 omega^2) /
    (m n pi^2 ((m pi/L)^2 + (n pi/L)^2)) sin(m pi x*/L) sin(n pi y*/L)."""
    x = np.asarray(pos[:, 0]) + LL / 2
    y = np.asarray(pos[:, 1]) + LL / 2
    p = np.zeros(len(x))
    for m in range(1, n_modes + 1, 2):
        for n in range(1, n_modes + 1, 2):
            c1 = m * n * math.pi**2 * ((m * math.pi / LL) ** 2
                                       + (n * math.pi / LL) ** 2)
            p += (RHO0_F * (-32.0 * OMEGA**2) / c1
                  * np.sin(m * math.pi * x / LL) * np.sin(n * math.pi * y / LL))
    return p


def build_case(dx: float = LL / 100.0, dtype=jnp.float32, cell_cap: int = 24,
               k_inner: int = 48, half_span: float = 2.5):
    """half_span: the background grid covers [-half_span, half_span]^2 —
    the deforming arms stay within ~2 LL over t=0..8."""
    adaptation = SPHAdaptation(spacing=dx, dim=2)
    xs = np.arange(-LL / 2 + dx / 2, LL / 2, dx)
    pos = np.stack(np.meshgrid(xs, xs, indexing="ij"), -1).reshape(-1, 2)
    fluid = dict(make_fluid_state(pos, dx * dx, RHO0_F, dtype=dtype))
    vel = np.stack([OMEGA * pos[:, 1], -OMEGA * pos[:, 0]], axis=-1)
    fluid["Velocity"] = jnp.asarray(vel, dtype)
    fluid["Pressure"] = jnp.asarray(_initial_pressure(pos), dtype)
    # start from the EoS-consistent density so the initial pressure field
    # actually acts (rho = rho0 (p/c^2 + 1) inverted Tait-linear)
    fluid["Density"] = RHO0_F + fluid["Pressure"] / (C_F * C_F)
    fluid["Indicator"] = jnp.zeros((len(pos),), jnp.int32)
    fluid["PreviousSurfaceIndicator"] = jnp.ones((len(pos),), jnp.int32)
    fluid["PositionDivergence"] = jnp.zeros((len(pos),), dtype)
    fluid["LinearGradientCorrectionMatrix"] = jnp.tile(
        jnp.eye(2, dtype=dtype), (len(pos), 1, 1))

    grid = grid_from_bounds((-half_span, -half_span), (half_span, half_span),
                            adaptation.cutoff)
    eos = WeaklyCompressibleFluid(rho0=RHO0_F, c0=C_F)
    case = RotationPatchCase(dx=dx, adaptation=adaptation, grid=grid,
                             eos=eos, riemann=rs.acoustic_riemann(eos),
                             n_fluid=len(pos), cell_cap=cell_cap,
                             k_inner=k_inner)
    return case, fluid


def rebuild_lists(case: RotationPatchCase, fluid: State):
    pos = fluid["Position"]
    n = fluid["NReal"]
    table = build_cell_table(pos, n, case.grid, cap=case.cell_cap)
    return build_neighbor_list(pos, n, pos, n, table, case.grid,
                               case.adaptation.cutoff, k_max=case.k_inner,
                               include_self=False)


def init_sim(case: RotationPatchCase, fluid: State) -> SimState:
    nl = jax.jit(partial(rebuild_lists, case))(fluid)
    dtype = fluid["Position"].dtype
    return SimState(fluid=fluid, nl_inner=nl,
                    time=jnp.zeros((), dtype),
                    n_adv=jnp.zeros((), jnp.int32),
                    n_ac=jnp.zeros((), jnp.int32),
                    overflow=jnp.zeros((), bool))


def _advection_step(case: RotationPatchCase, s: SimState) -> SimState:
    kernel, dim = case.kernel, 2
    h = case.adaptation.h
    sigma0 = case.adaptation.sigma0
    fluid = s.fluid

    dt_adv = fd.advection_time_step(fluid, h, U_MAX)
    fluid = fd.free_surface_indication(fluid, s.nl_inner, kernel, dim,
                                       spatial_temporal=True)
    fluid = fd.density_summation_freestream(fluid, s.nl_inner, kernel, dim,
                                            RHO0_F, sigma0)
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
    return SimState(fluid=fluid, nl_inner=nl,
                    time=s.time + relax_t, n_adv=s.n_adv + 1,
                    n_ac=s.n_ac + n_ac,
                    overflow=s.overflow | nl.overflow)


def make_run_chunk(case: RotationPatchCase):
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
