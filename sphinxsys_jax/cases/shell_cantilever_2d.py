"""2D shell cantilever strip — thin-structure validation case.

A single row of shell particles along x (the 2D analog of the reference's
oscillating-plate shell tests) with the SAME material, length, thickness
and first-mode initial velocity as cases/oscillating_beam_2d.py — so the
shell discretization must reproduce the solid-beam tip oscillation
(period ~0.28 s) with ~50x fewer particles.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from sphinxsys_jax.core.adaptation import SPHAdaptation
from sphinxsys_jax.core.materials import SaintVenantKirchhoffSolid
from sphinxsys_jax.neighbors import grid_from_bounds, build_cell_table, build_neighbor_list
from sphinxsys_jax.physics import shell as sh
from sphinxsys_jax.physics import solid as sd

PL = 0.2    # cantilever length
SL = 0.06   # clamped insert
PH = 0.02   # thickness
RHO0 = 1.0e3
YOUNGS = 2.0e6
POISSON = 0.3975

KL = 1.875
_M = math.sin(KL) + math.sinh(KL)
_N = math.cos(KL) + math.cosh(KL)
_Q = 2.0 * (math.cos(KL) * math.sinh(KL) - math.sin(KL) * math.cosh(KL))
VF = 0.05


class ShellSim(NamedTuple):
    shell: Any
    time: jnp.ndarray
    n_steps: jnp.ndarray
    dt: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class ShellCase:
    dx: float
    adaptation: SPHAdaptation
    material: SaintVenantKirchhoffSolid
    rp: sd.ReferencePairs
    base_mask: jnp.ndarray
    n_shell: int

    @property
    def kernel(self):
        return self.adaptation.kernel


def build_case(dx: float = PL / 40.0, dtype=jnp.float32):
    adaptation = SPHAdaptation(spacing=dx, dim=2)
    xs = np.arange(-SL, PL + dx / 2, dx)
    pos = np.stack([xs, np.zeros_like(xs)], -1)
    normal = np.tile(np.asarray([0.0, 1.0]), (len(xs), 1))

    material = SaintVenantKirchhoffSolid(rho0=RHO0, youngs_modulus=YOUNGS,
                                         poisson_ratio=POISSON)
    shell = sh.make_shell_state(pos, normal, dx, PH, material, dtype=dtype)

    grid = grid_from_bounds((-SL - 0.05, -0.1), (PL + 0.05, 0.1),
                            adaptation.cutoff)
    n = len(xs)
    table = build_cell_table(shell["Position"], jnp.int32(n), grid, cap=16)
    nl = build_neighbor_list(shell["Position"], jnp.int32(n), shell["Position"],
                             jnp.int32(n), table, grid, adaptation.cutoff,
                             k_max=16, include_self=False)
    # surface particles use the dimension-reduced kernel (reduceOnce)
    rp = sd.freeze_reference_pairs(shell["Position"], nl,
                                   sh.ReducedKernel(adaptation.kernel), 2)
    shell = sh.shell_correct_configuration(shell, rp)

    # clamp x <= 0; first-mode velocity for x > 0 (oscillating_beam.cpp IC)
    base_mask = jnp.asarray(xs <= 0.0)
    x = xs / PL
    c0 = material.sound_speed
    vy = np.where(x > 0.0,
                  VF * c0 * (_M * (np.cos(KL * x) - np.cosh(KL * x))
                             - _N * (np.sin(KL * x) - np.sinh(KL * x))) / _Q,
                  0.0)
    vel = np.zeros_like(pos)
    vel[:, 1] = vy
    shell["Velocity"] = jnp.asarray(vel, dtype=dtype)

    case = ShellCase(dx=dx, adaptation=adaptation, material=material, rp=rp,
                     base_mask=base_mask, n_shell=n)
    sim = ShellSim(shell=shell, time=jnp.zeros((), dtype),
                   n_steps=jnp.zeros((), jnp.int32), dt=jnp.zeros((), dtype))
    return case, sim


def _constrain(shell, mask):
    out = dict(shell)
    m = mask[:, None]
    out["Position"] = jnp.where(m, shell["InitialPosition"], shell["Position"])
    out["Velocity"] = jnp.where(m, 0.0, shell["Velocity"])
    out["Rotation"] = jnp.where(m, 0.0, shell["Rotation"])
    out["AngularVelocity"] = jnp.where(m, 0.0, shell["AngularVelocity"])
    return out


def _step(case: ShellCase, s: ShellSim) -> ShellSim:
    h = case.adaptation.h
    shell = sh.shell_stress_relaxation_1st_half(s.shell, case.rp,
                                                case.material, s.dt, h)
    shell = _constrain(shell, case.base_mask)
    shell = sh.shell_stress_relaxation_2nd_half(shell, case.rp, s.dt)
    dt_next = sh.shell_acoustic_time_step(shell, case.material, h)
    return ShellSim(shell=shell, time=s.time + dt_next,
                    n_steps=s.n_steps + 1, dt=dt_next)


def make_run_chunk(case: ShellCase):
    @jax.jit
    def run_chunk(s: ShellSim, t_target) -> ShellSim:
        return jax.lax.while_loop(lambda st: st.time < t_target,
                                  lambda st: _step(case, st), s)

    return run_chunk


def tip_displacement(case: ShellCase, s: ShellSim):
    i = case.n_shell - 1
    return float(s.shell["Position"][i, 1] - s.shell["InitialPosition"][i, 1])
