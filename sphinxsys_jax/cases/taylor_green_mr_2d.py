"""Multi-resolution Taylor-Green vortex — adaptive-h DYNAMIC fluid.

The MR fluid loop (the reference's ParticleWithLocalRefinement fluids,
e.g. test_2d_free_stream_around_cylinder_mr): a 2x-refined disk embedded
in the coarse periodic Taylor-Green box, with the multi-level neighbor
search rebuilt EVERY advection step (the particles move; their h is
carried, Lagrangian) and every fluid op evaluated with per-particle
smoothing lengths (physics/fluid_adaptive.py).

Oracle: the analytic viscous decay |v| ~ exp(-8 pi^2 nu t) must hold for
the MIXED-resolution field just as it does for the uniform case — any
inconsistency at the resolution interface shows up as spurious decay or
growth.
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
from sphinxsys_jax.neighbors.cell_list import wrap_positions, grid_from_bounds
from sphinxsys_jax.neighbors.multilevel import (build_adaptive_neighbor_list,
                                                build_multilevel_tables)
from sphinxsys_jax.physics import fluid as fd
from sphinxsys_jax.physics import fluid_adaptive as fa
from sphinxsys_jax.physics import riemann as rs

DL = 1.0
DH = 1.0
RHO0_F = 1.0
U_F = 1.0
C_F = 10.0 * U_F
RE = 100.0
MU_F = RHO0_F * U_F * DL / RE
REFINE_CENTER = (0.5, 0.5)
REFINE_R = 0.25
RAMP_W = 0.1    # smoothing-length transition band: fine particles ramp
                # hr 2 -> 1 toward the interface so no kernel support is
                # ever starved (the reference's smoothly varying smoothing
                # length field; a sharp 2x h jump is unstable)


class SimState(NamedTuple):
    fluid: Any
    nl_inner: Any
    time: jnp.ndarray
    n_adv: jnp.ndarray
    n_ac: jnp.ndarray
    overflow: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class TGMRCase:
    dx: float
    adaptation: SPHAdaptation
    eos: WeaklyCompressibleFluid
    riemann: Any
    no_riemann: Any
    n_fluid: int
    cap: int
    k_levels: tuple

    @property
    def kernel(self):
        return self.adaptation.kernel

    @property
    def box(self):
        return (DL, DH)


def build_case(dx: float = 0.02, dtype=jnp.float32, cap: int = 48,
               k_levels=(96, 128)):
    adaptation = SPHAdaptation(spacing=dx, dim=2)
    c = np.asarray(REFINE_CENTER)

    def in_disk(p):
        return np.linalg.norm(p - c, axis=1) < REFINE_R

    xs_c = np.arange(dx / 2, DL, dx)
    pos_c = np.stack(np.meshgrid(xs_c, xs_c, indexing="ij"), -1).reshape(-1, 2)
    keep_c = ~in_disk(pos_c)
    xs_f = np.arange(dx / 4, DL, dx / 2)
    pos_f = np.stack(np.meshgrid(xs_f, xs_f, indexing="ij"), -1).reshape(-1, 2)
    keep_f = in_disk(pos_f)
    pos = np.concatenate([pos_c[keep_c], pos_f[keep_f]])
    vols = np.concatenate([np.full(keep_c.sum(), dx * dx),
                           np.full(keep_f.sum(), (dx / 2) ** 2)])
    # smooth hr: 2 deep inside the disk, ramping to 1 at the interface
    d = np.linalg.norm(pos - c, axis=1)
    hr_ramp = 1.0 + np.clip((REFINE_R - d) / RAMP_W, 0.0, 1.0)
    h_ratio = np.where(np.concatenate([np.zeros(keep_c.sum(), bool),
                                       np.ones(keep_f.sum(), bool)]),
                       hr_ramp, 1.0)

    fluid = dict(make_fluid_state(pos, vols, RHO0_F, dtype=dtype))
    fluid["VolumetricMeasure"] = jnp.asarray(vols, dtype)
    fluid["Mass"] = jnp.asarray(RHO0_F * vols, dtype)
    fluid["SmoothingLengthRatio"] = jnp.asarray(h_ratio, dtype)

    vel = np.stack([
        -np.cos(2 * math.pi * pos[:, 0]) * np.sin(2 * math.pi * pos[:, 1]),
        np.sin(2 * math.pi * pos[:, 0]) * np.cos(2 * math.pi * pos[:, 1]),
    ], axis=-1)
    fluid["Velocity"] = jnp.asarray(vel, dtype)
    fluid["ViscousForce"] = jnp.zeros_like(fluid["Velocity"])
    fluid["ViscousForcePrev"] = jnp.zeros_like(fluid["Velocity"])

    eos = WeaklyCompressibleFluid(rho0=RHO0_F, c0=C_F)
    case = TGMRCase(dx=dx, adaptation=adaptation, eos=eos,
                    riemann=rs.acoustic_riemann(eos),
                    no_riemann=rs.no_riemann(eos), n_fluid=len(pos),
                    cap=cap, k_levels=tuple(k_levels))
    return case, fluid


def rebuild_inner(case: TGMRCase, fluid: State):
    """Periodic wrap + multi-level rebuild + adaptive pair search — every
    advection step (the MR fluid's updateCellLinkedList equivalent)."""
    grid0 = grid_from_bounds((0.0, 0.0), (DL, DH), case.adaptation.cutoff,
                             periodic=(True, True))
    pos = wrap_positions(fluid["Position"], grid0)
    hr = fluid["SmoothingLengthRatio"]
    n = pos.shape[0]
    ml = build_multilevel_tables(pos, jnp.int32(n), hr, (0.0, 0.0),
                                 (DL, DH), case.adaptation.h,
                                 kernel_size=2.0, n_levels=2, cap=case.cap,
                                 periodic=(True, True))
    nl = build_adaptive_neighbor_list(pos, jnp.int32(n), hr, pos, hr, ml,
                                      2.0, case.adaptation.h,
                                      k_max_per_level=list(case.k_levels),
                                      box=case.box)
    return pos, nl


def init_sim(case: TGMRCase, fluid: State) -> SimState:
    pos, nl = jax.jit(partial(rebuild_inner, case))(fluid)
    fluid = dict(fluid)
    fluid["Position"] = pos
    dtype = pos.dtype
    return SimState(fluid=fluid, nl_inner=nl, time=jnp.zeros((), dtype),
                    n_adv=jnp.zeros((), jnp.int32),
                    n_ac=jnp.zeros((), jnp.int32),
                    overflow=jnp.zeros((), bool))


def _advection_step(case: TGMRCase, s: SimState) -> SimState:
    kernel, dim = case.kernel, 2
    h_fine = case.adaptation.h / 2.0      # dt at the finest resolution
    box = case.box
    fluid = s.fluid

    dt_adv = fd.advection_viscous_time_step(fluid, h_fine, U_F, RHO0_F, MU_F)
    fluid = fa.density_summation_adaptive(fluid, s.nl_inner, kernel, dim,
                                          RHO0_F, box=box)
    fluid = fa.viscous_force_adaptive(fluid, s.nl_inner, kernel, dim, MU_F,
                                      case.adaptation.h, box=box)
    fluid = fa.transport_velocity_correction_adaptive(
        fluid, s.nl_inner, kernel, dim, case.adaptation.h, box=box)

    def ac_cond(carry):
        _, rt, _ = carry
        return rt < dt_adv

    def ac_body(carry):
        f, rt, k = carry
        dt = jnp.minimum(fd.acoustic_time_step(f, case.eos, h_fine), dt_adv)
        f = fa.acoustic_step_1st_half_adaptive(f, s.nl_inner, kernel, dim,
                                               case.eos, case.riemann, dt,
                                               box=box)
        f = fa.acoustic_step_2nd_half_adaptive(f, s.nl_inner, kernel, dim,
                                               case.no_riemann, dt, box=box)
        return (f, rt + dt, k + 1)

    fluid, relax_t, n_ac = jax.lax.while_loop(
        ac_cond, ac_body,
        (fluid, jnp.zeros_like(dt_adv), jnp.zeros((), jnp.int32)))

    pos, nl = rebuild_inner(case, fluid)
    fluid = dict(fluid)
    fluid["Position"] = pos
    return SimState(fluid=fluid, nl_inner=nl, time=s.time + relax_t,
                    n_adv=s.n_adv + 1, n_ac=s.n_ac + n_ac,
                    overflow=s.overflow | nl.overflow)


def make_run_chunk(case: TGMRCase):
    @jax.jit
    def run_chunk(s: SimState, t_target) -> SimState:
        return jax.lax.while_loop(lambda st: st.time < t_target,
                                  lambda st: _advection_step(case, st), s)

    return run_chunk


def max_speed(s: SimState) -> float:
    return float(jnp.max(jnp.linalg.norm(s.fluid["Velocity"], axis=-1)))
