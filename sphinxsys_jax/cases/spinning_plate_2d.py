"""Spinning square plate (test_2d_spinning_plate): tensile-instability and
angular-momentum-conservation test for the updated-Lagrangian
hourglass-controlled solid.

Mirrors /root/reference/tests/2d_examples/test_2d_spinning_plate/
spinning_plate.cpp: a free 1 x 1 GeneralContinuum square (rho 1100,
E 1.7e7, nu 0.45) given a rigid-rotation initial velocity field
omega_0 = -50 rad/s spins freely for t = 0.5 s; the recorded
TotalKineticEnergy trajectory is DTW-compared to the committed reference
database (6 runs).  Without hourglass control (or with a naive
total-Lagrangian treatment) the plate tears itself apart through the
tensile instability — KE staying on the reference curve is the pass
signal.

Note the reference's initial condition (cpp:58-66) computes
angle = atan2(x, y) (not atan2(y, x)) and sets
v = (omega r cos(angle), -omega r sin(angle)) = (omega y, -omega x):
a clockwise rigid rotation for omega > 0.
"""

from __future__ import annotations

import dataclasses
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

PL = 1.0
DX = PL / 20.0
RHO0 = 1.1e3
YOUNGS = 1.7e7
POISSON = 0.45
C0 = float(np.sqrt(YOUNGS / (3.0 * (1.0 - 2.0 * POISSON) * RHO0)))
ANGULAR_0 = -50.0
U_REF = float(abs(ANGULAR_0) * 0.5 * np.sqrt(2.0))


class SimState(NamedTuple):
    plate: Any
    time: jnp.ndarray
    n_steps: jnp.ndarray
    overflow: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class SpinCase:
    dx: float
    adaptation: SPHAdaptation
    grid: Any
    material: Any
    eos: Any
    riemann_p: Any
    riemann_rho: Any
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

    xs = np.arange(-PL / 2 + dx / 2, PL / 2, dx)
    pos = np.stack(np.meshgrid(xs, xs, indexing="ij"), -1).reshape(-1, 2)
    n = len(pos)
    plate = cn.make_ul_solid_state(pos, dx * dx, material, dtype=dtype)

    # SquareInitialCondition: v = (omega y, -omega x) — see module docstring
    vel = np.stack([ANGULAR_0 * pos[:, 1], -ANGULAR_0 * pos[:, 0]], axis=-1)
    plate["Velocity"] = jnp.asarray(vel, dtype)

    # free flight: the plate stays near the origin but spins; the domain
    # bound covers moderate deformation
    grid = grid_from_bounds((-PL, -PL), (PL, PL), adaptation.cutoff)
    case = SpinCase(dx=dx, adaptation=adaptation, grid=grid,
                    material=material, eos=eos,
                    riemann_p=rs.no_riemann(eos),
                    riemann_rho=rs.dissipative_riemann(eos),
                    n=n, cell_cap=cell_cap, k_inner=k_inner)
    return case, plate


def init_sim(case: SpinCase, plate: State) -> SimState:
    return SimState(plate=plate, time=jnp.zeros((), plate["Position"].dtype),
                    n_steps=jnp.zeros((), jnp.int32),
                    overflow=jnp.zeros((), bool))


def _advection_step(case: SpinCase, s: SimState) -> SimState:
    kernel, dim = case.kernel, 2
    plate = cn.volume_update(s.plate)
    table = build_cell_table(plate["Position"], plate["NReal"], case.grid,
                             cap=case.cell_cap)
    nl = build_neighbor_list(plate["Position"], plate["NReal"],
                             plate["Position"], plate["NReal"], table,
                             case.grid, case.adaptation.cutoff,
                             k_max=case.k_inner, include_self=False)
    plate = cn.correction_matrix_current(plate, nl, kernel, dim, alpha=0.0)

    adv_dt = fd.advection_time_step(plate, case.adaptation.h, U_REF, cfl=0.2)

    def cond(carry):
        _, t_rel = carry
        return t_rel < adv_dt

    def body(carry):
        b, t_rel = carry
        # AcousticTimeStep(square_body, 0.1) — acoustic CFL 0.1 (cpp:109)
        dt = fd.acoustic_time_step(b, case.eos, case.adaptation.h, cfl=0.1)
        b = fd.acoustic_step_1st_half(b, nl, kernel, dim, case.eos,
                                      case.riemann_p, dt,
                                      extra_force=cn.ul_shear_force(b))
        b = cn.shear_stress_hourglass_1st_half(b, nl, kernel, dim,
                                               case.material, dt)
        b = cn.shear_acceleration_hourglass_2nd_half(b, nl, kernel, dim,
                                                     case.material, dt)
        b = fd.acoustic_step_2nd_half(b, nl, kernel, dim, case.riemann_rho,
                                      dt)
        return (b, t_rel + dt)

    plate, t_rel = jax.lax.while_loop(cond, body,
                                      (plate, jnp.zeros_like(adv_dt)))
    return SimState(plate=plate, time=s.time + t_rel,
                    n_steps=s.n_steps + 1, overflow=s.overflow | nl.overflow)


def make_run_chunk(case: SpinCase):
    @jax.jit
    def run_chunk(s: SimState, t_target) -> SimState:
        return jax.lax.while_loop(lambda st: st.time < t_target,
                                  lambda st: _advection_step(case, st), s)

    return run_chunk


def kinetic_energy(s: SimState) -> float:
    """ReducedQuantityRecording<TotalKineticEnergy>."""
    p = s.plate
    v2 = jnp.sum(p["Velocity"] ** 2, axis=-1)
    return float(jnp.sum(0.5 * p["Mass"] * v2))
