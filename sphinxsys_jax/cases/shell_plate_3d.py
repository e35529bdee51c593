"""3D shell plate cantilever — thin-structure validation in 3D.

A rectangular strip of shell particles in the z=0 plane (normal +z),
clamped at x<=0, given the first-mode beam velocity profile in z: with
nu = 0 cylindrical plate bending reduces exactly to Euler-Bernoulli beam
theory, so the tip must oscillate with

    omega = (1.875/L)^2 sqrt(E t^2 / (12 rho))   (T ~ 0.277 s here)

This is the 3D counterpart of cases/shell_cantilever_2d.py and exercises
the two-angle rotation algebra (thin_structure_math.cpp Vec3d overloads).
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

PL = 0.2    # cantilever length (x)
SL = 0.06   # clamped insert
PW = 0.06   # strip width (y)
PH = 0.02   # thickness
RHO0 = 1.0e3
YOUNGS = 2.0e6
POISSON = 0.0   # nu=0: cylindrical bending == beam theory

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
class PlateCase:
    dx: float
    adaptation: SPHAdaptation
    material: SaintVenantKirchhoffSolid
    rp: sd.ReferencePairs
    base_mask: jnp.ndarray
    tip_mask: jnp.ndarray
    n_shell: int

    @property
    def kernel(self):
        return self.adaptation.kernel


def theoretical_period():
    return 2.0 * math.pi / ((KL / PL) ** 2
                            * math.sqrt(YOUNGS * PH * PH / (12.0 * RHO0)))


def build_case(dx: float = PL / 20.0, dtype=jnp.float32):
    adaptation = SPHAdaptation(spacing=dx, dim=3)
    xs = np.arange(-SL, PL + dx / 2, dx)
    ys = np.arange(0.0, PW + dx / 2, dx)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    pos = np.stack([X.ravel(), Y.ravel(), np.zeros(X.size)], -1)
    normal = np.tile(np.asarray([0.0, 0.0, 1.0]), (len(pos), 1))

    material = SaintVenantKirchhoffSolid(rho0=RHO0, youngs_modulus=YOUNGS,
                                         poisson_ratio=POISSON)
    shell = sh.make_shell_state(pos, normal, dx, PH, material, dtype=dtype)

    grid = grid_from_bounds((-SL - 0.05, -0.05, -0.05),
                            (PL + 0.05, PW + 0.05, 0.05), adaptation.cutoff)
    n = len(pos)
    table = build_cell_table(shell["Position"], jnp.int32(n), grid, cap=32)
    nl = build_neighbor_list(shell["Position"], jnp.int32(n),
                             shell["Position"], jnp.int32(n), table, grid,
                             adaptation.cutoff, k_max=32, include_self=False)
    rp = sd.freeze_reference_pairs(shell["Position"], nl,
                                   sh.ReducedKernel(adaptation.kernel), 3)
    shell = sh.shell_correct_configuration(shell, rp)

    base_mask = jnp.asarray(pos[:, 0] <= 0.0)
    tip_mask = jnp.asarray(pos[:, 0] > PL - dx / 2)
    x = pos[:, 0] / PL
    c0 = material.sound_speed
    vz = np.where(x > 0.0,
                  VF * c0 * (_M * (np.cos(KL * x) - np.cosh(KL * x))
                             - _N * (np.sin(KL * x) - np.sinh(KL * x))) / _Q,
                  0.0)
    vel = np.zeros_like(pos)
    vel[:, 2] = vz
    shell["Velocity"] = jnp.asarray(vel, dtype=dtype)

    case = PlateCase(dx=dx, adaptation=adaptation, material=material, rp=rp,
                     base_mask=base_mask, tip_mask=tip_mask, n_shell=n)
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


def _step(case: PlateCase, s: ShellSim) -> ShellSim:
    h = case.adaptation.h
    shell = sh.shell_stress_relaxation_1st_half(s.shell, case.rp,
                                                case.material, s.dt, h)
    shell = _constrain(shell, case.base_mask)
    shell = sh.shell_stress_relaxation_2nd_half(shell, case.rp, s.dt)
    dt_next = sh.shell_acoustic_time_step(shell, case.material, h)
    return ShellSim(shell=shell, time=s.time + dt_next,
                    n_steps=s.n_steps + 1, dt=dt_next)


def make_run_chunk(case: PlateCase):
    @jax.jit
    def run_chunk(s: ShellSim, t_target) -> ShellSim:
        return jax.lax.while_loop(lambda st: st.time < t_target,
                                  lambda st: _step(case, st), s)

    return run_chunk


def tip_displacement(case: PlateCase, s: ShellSim) -> float:
    dz = np.asarray(s.shell["Position"][:, 2] - s.shell["InitialPosition"][:, 2])
    return float(dz[np.asarray(case.tip_mask)].mean())
