"""Oscillating beam, UPDATED-Lagrangian formulation with generalized
hourglass control.

Counterpart of /root/reference/tests/2d_examples/test_2d_oscillating_beam_UL/
oscillating_beam_UL.cpp: the same first-mode-kicked cantilever as the
total-Lagrangian oscillating_beam case, but integrated on the CURRENT
configuration — WCSPH pressure/density halves carry the volumetric part
(p = -tr(sigma)/3 via the linear EoS), the deviatoric shear stress evolves
with a Jaumann rate, and the zero-energy (hourglass) modes are suppressed
by the co-rotating pair-velocity penalty
(continuum_dynamics::ShearStressRelaxationHourglassControl).

Loop structure (oscillating_beam_UL.cpp:179-210): outer advection step
(cell lists + correction matrix + volume update), inner acoustic loop of
  pressure relaxation -> constraint -> shear stress -> shear acceleration
  -> density relaxation.
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
from sphinxsys_jax.core.state import State
from sphinxsys_jax.neighbors import (build_cell_table, build_neighbor_list,
                                     grid_from_bounds)
from sphinxsys_jax.physics import continuum as cn
from sphinxsys_jax.physics import fluid as fd
from sphinxsys_jax.physics import riemann as rs
from sphinxsys_jax.physics import solid as sd

PL = 0.2
PH = 0.02
SL = 0.06
DX = PH / 10.0
BW = 4 * DX
RHO0 = 1.0e3
YOUNGS = 2.0e6
POISSON = 0.3975
C0 = math.sqrt(YOUNGS / (3.0 * (1.0 - 2.0 * POISSON) * RHO0))
KL = 1.875
_M = math.sin(KL) + math.sinh(KL)
_N = math.cos(KL) + math.cosh(KL)
_Q = 2.0 * (math.cos(KL) * math.sinh(KL) - math.sin(KL) * math.cosh(KL))
VF = 0.05
U_REF = abs(VF * C0 * (_M * (math.cos(KL) - math.cosh(KL))
                       - _N * (math.sin(KL) - math.sinh(KL))) / _Q)


class SimState(NamedTuple):
    beam: Any
    time: jnp.ndarray
    n_steps: jnp.ndarray
    overflow: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class ULBeamCase:
    dx: float
    adaptation: SPHAdaptation
    grid: Any
    material: cn.GeneralContinuum
    eos: WeaklyCompressibleFluid
    riemann_p: Any
    riemann_rho: Any
    base_mask: Any
    n: int
    cell_cap: int
    k_inner: int

    @property
    def kernel(self):
        return self.adaptation.kernel


def build_case(dx: float = DX, dtype=jnp.float32, cell_cap: int = 16,
               k_inner: int = 32):
    adaptation = SPHAdaptation(spacing=dx, dim=2)
    material = cn.GeneralContinuum(rho0=RHO0, c0=C0, youngs_modulus=YOUNGS,
                                   poisson_ratio=POISSON)
    eos = WeaklyCompressibleFluid(rho0=RHO0, c0=C0)

    # lattice: clamp frame [-SL-BW, 0] x [-PH/2-BW, PH/2+BW] union beam
    # [-SL, PL] x [-PH/2, PH/2] (beam_base_shape + beam_shape)
    xs = np.arange(-SL - BW + dx / 2, PL, dx)
    pts = []
    for x in xs:
        if x < 0.0:
            ys = np.arange(-PH / 2 - BW + dx / 2, PH / 2 + BW, dx)
        else:
            ys = np.arange(-PH / 2 + dx / 2, PH / 2, dx)
        for y in ys:
            if x < 0.0 or abs(y) < PH / 2:
                pts.append((x, y))
    pos = np.asarray(pts)
    n = len(pos)

    beam = cn.make_ul_solid_state(pos, dx * dx, material, dtype=dtype)
    beam["InitialPosition"] = beam["Position"]

    # first-mode kick on x > 0 (BeamInitialCondition)
    x = pos[:, 0] / PL
    vy = np.where(x > 0.0,
                  VF * C0 / _Q * (_M * (np.cos(KL * x) - np.cosh(KL * x))
                                  - _N * (np.sin(KL * x) - np.sinh(KL * x))),
                  0.0)
    vel = np.zeros_like(pos)
    vel[:, 1] = vy
    beam["Velocity"] = jnp.asarray(vel, dtype)

    # constrained: base region minus the beam strip (createBeamConstrainShape)
    base_mask = jnp.asarray((pos[:, 0] < 0.0)
                            & ((pos[:, 0] < -SL) | (np.abs(pos[:, 1]) > PH / 2)))

    lo = (-SL - BW - 4 * dx, -0.7 * PL)
    hi = (1.1 * PL, 0.7 * PL)
    grid = grid_from_bounds(lo, hi, adaptation.cutoff)

    case = ULBeamCase(dx=dx, adaptation=adaptation, grid=grid,
                      material=material, eos=eos,
                      riemann_p=rs.no_riemann(eos),
                      riemann_rho=rs.dissipative_riemann(eos),
                      base_mask=base_mask, n=n, cell_cap=cell_cap,
                      k_inner=k_inner)
    return case, beam


def init_sim(case: ULBeamCase, beam: State) -> SimState:
    return SimState(beam=beam, time=jnp.zeros((), beam["Position"].dtype),
                    n_steps=jnp.zeros((), jnp.int32),
                    overflow=jnp.zeros((), bool))


def _acoustic_step(case: ULBeamCase, beam: State, nl, dt) -> State:
    kernel, dim = case.kernel, 2
    beam = fd.acoustic_step_1st_half(beam, nl, kernel, dim, case.eos,
                                     case.riemann_p, dt,
                                     extra_force=cn.ul_shear_force(beam))
    beam = sd.fix_constraint(beam, case.base_mask)
    beam = cn.shear_stress_hourglass_1st_half(beam, nl, kernel, dim,
                                              case.material, dt)
    beam = cn.shear_acceleration_hourglass_2nd_half(beam, nl, kernel, dim,
                                                    case.material, dt)
    beam = fd.acoustic_step_2nd_half(beam, nl, kernel, dim, case.riemann_rho,
                                     dt)
    return beam


def _advection_step(case: ULBeamCase, s: SimState) -> SimState:
    beam = cn.volume_update(s.beam)
    table = build_cell_table(beam["Position"], beam["NReal"], case.grid,
                             cap=case.cell_cap)
    nl = build_neighbor_list(beam["Position"], beam["NReal"],
                             beam["Position"], beam["NReal"], table,
                             case.grid, case.adaptation.cutoff,
                             k_max=case.k_inner, include_self=False)
    beam = cn.correction_matrix_current(beam, nl, case.kernel, 2, alpha=0.0)

    adv_dt = fd.advection_time_step(beam, case.adaptation.h, U_REF, cfl=0.2)

    def cond(carry):
        b, t_rel = carry
        return t_rel < adv_dt

    def body(carry):
        b, t_rel = carry
        dt = fd.acoustic_time_step(b, case.eos, case.adaptation.h, cfl=0.4)
        b = _acoustic_step(case, b, nl, dt)
        return (b, t_rel + dt)

    beam, t_rel = jax.lax.while_loop(cond, body, (beam, jnp.zeros_like(adv_dt)))
    return SimState(beam=beam, time=s.time + t_rel, n_steps=s.n_steps + 1,
                    overflow=s.overflow | nl.overflow)


def make_run_chunk(case: ULBeamCase):
    @jax.jit
    def run_chunk(s: SimState, t_target) -> SimState:
        return jax.lax.while_loop(lambda st: st.time < t_target,
                                  lambda st: _advection_step(case, st), s)

    return run_chunk


def tip_observer(case: ULBeamCase, beam: State):
    """Frozen-weight observer at (PL, 0) (oscillating_beam_UL.cpp:52)."""
    pos0 = np.asarray(beam["InitialPosition"])
    r = np.linalg.norm(pos0 - np.asarray([PL, 0.0]), axis=1)
    idx = np.nonzero(r < case.adaptation.cutoff)[0]
    w = np.asarray([float(case.kernel.W(jnp.asarray(ri, pos0.dtype), 2))
                    for ri in r[idx]])
    w = w * np.asarray(beam["VolumetricMeasure"])[idx]
    return jnp.asarray(idx), jnp.asarray(w / (w.sum() + 1e-15), pos0.dtype)


def observe_tip(s: SimState, idx, weights) -> np.ndarray:
    return np.asarray(jnp.sum(s.beam["Position"][idx] * weights[:, None],
                              axis=0))


def kinetic_energy(s: SimState) -> float:
    """TotalKineticEnergy (the reference's DTW-regressed reduced quantity)."""
    b = s.beam
    n = b["Position"].shape[0]
    valid = jnp.arange(n) < b["NReal"]
    ke = 0.5 * b["Mass"] * jnp.sum(b["Velocity"] ** 2, axis=-1)
    return float(jnp.sum(jnp.where(valid, ke, 0.0)))
