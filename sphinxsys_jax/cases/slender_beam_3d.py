"""3D slender beam (bar) under a ramped distributed load — dynamic case.

Counterpart of tests/3d_examples/test_3d_slender_beam/
test_3d_slender_beam.cpp: a 40-particle bar of length 10 (square 1x1
cross-section), Saint-Venant-Kirchhoff E = 1.3024653e6, nu = 0.3, simply
supported (end-region particle VELOCITY zeroed each half step — rotations
stay free, ConstrainBarBodyRegionAlongAxis:321), loaded by the ramped
uniform acceleration q/(PT rho) - g over t_ramp = 0.1
(IncreaseToFullGravity), pairwise damping (physical viscosity 200) on
Velocity / AngularVelocity / BinormalAngularVelocity, run to end_time =
0.8.  Reference oracle: max mid-span displacement 1.8687 (+-10%).
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from sphinxsys_jax.core.adaptation import SPHAdaptation
from sphinxsys_jax.core.materials import SaintVenantKirchhoffSolid
from sphinxsys_jax.neighbors import (build_cell_table, build_neighbor_list,
                                     grid_from_bounds)
from sphinxsys_jax.physics import bar as bd
from sphinxsys_jax.physics import solid as sd
from sphinxsys_jax.physics.dissipation import damping_pairwise

PL = 10.0
PT = 1.0
PW = 1.0
N_PART = 40
DX = PL / N_PART
BWD = 1
BW = DX * BWD
RHO0 = 1.0
YOUNGS = 1.3024653e6
POISSON = 0.3
PHYS_VISC = 200.0
Q_LOAD = 100.0 * YOUNGS * 1.0e-4
T_RAMP = 0.1
GRAV = 0.009646
AZ_FULL = Q_LOAD / (PT * RHO0) - GRAV
DISPL_MAX_REFERENCE = 1.8687     # test_3d_slender_beam.cpp:43


class BarSim(NamedTuple):
    bar: Any
    time: jnp.ndarray
    n_steps: jnp.ndarray
    dt: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class BarCase:
    adaptation: SPHAdaptation
    material: SaintVenantKirchhoffSolid
    rp: sd.ReferencePairs
    nl: Any
    line_kernel: Any
    end_mask: jnp.ndarray
    n_bar: int

    def __hash__(self):
        return hash((self.n_bar,))

    def __eq__(self, other):
        return self is other


def build_case(dtype=jnp.float32):
    xs = DX * np.arange(N_PART + 2 * BWD) - BW + DX * 0.5
    pos = np.stack([xs, np.zeros_like(xs), np.zeros_like(xs)], -1)
    material = SaintVenantKirchhoffSolid(rho0=RHO0, youngs_modulus=YOUNGS,
                                         poisson_ratio=POISSON)
    bar = bd.make_bar_state(pos, (0.0, 0.0, 1.0), (0.0, 1.0, 0.0), DX,
                            PT, PW, material, dtype=dtype)

    adaptation = SPHAdaptation(spacing=DX, dim=3)
    grid = grid_from_bounds((-BW - 4 * DX, -4 * DX, -4 * DX),
                            (PL + BW + 4 * DX, 4 * DX, 4 * DX),
                            adaptation.cutoff)
    n = len(xs)
    table = build_cell_table(bar["Position"], jnp.int32(n), grid, cap=16)
    nl = build_neighbor_list(bar["Position"], jnp.int32(n), bar["Position"],
                             jnp.int32(n), table, grid, adaptation.cutoff,
                             k_max=16, include_self=False)
    lk = bd.LineKernel(adaptation.kernel)
    rp = sd.freeze_reference_pairs(bar["Position"], nl, lk, 3)
    bar = bd.bar_correct_configuration(bar, rp)
    # one eager zero-dt step registers the stress-resultant keys so the
    # jitted while_loop carry pytree is stable
    bar = bd.bar_stress_relaxation_1st_half(bar, rp, material, 0.0,
                                            adaptation.h)
    bar = bd.bar_stress_relaxation_2nd_half(bar, rp, 0.0)

    end_mask = jnp.asarray((xs < 0.0) | (xs > PL))
    case = BarCase(adaptation=adaptation, material=material, rp=rp, nl=nl,
                   line_kernel=lk, end_mask=end_mask, n_bar=n)
    sim = BarSim(bar=bar, time=jnp.zeros((), dtype),
                 n_steps=jnp.zeros((), jnp.int32), dt=jnp.zeros((), dtype))
    return case, sim


def _constrain_velocity(bar, mask):
    """ConstrainBarBodyRegionAlongAxis::update: zero translational
    velocity only (simply supported — rotations free)."""
    out = dict(bar)
    out["Velocity"] = jnp.where(mask[:, None], 0.0, bar["Velocity"])
    return out


def _step(case: BarCase, s: BarSim) -> BarSim:
    h = case.adaptation.h
    bar = dict(s.bar)
    # ramped distributed load (IncreaseToFullGravity)
    factor = jnp.minimum(s.time / T_RAMP, 1.0)
    az = factor * AZ_FULL
    fp = jnp.zeros_like(bar["Velocity"])
    fp = fp.at[:, 2].set(az * bar["Mass"])
    bar["ForcePrior"] = fp

    bar = bd.bar_stress_relaxation_1st_half(bar, case.rp, case.material,
                                            s.dt, h)
    bar = _constrain_velocity(bar, case.end_mask)
    for field in ("Velocity", "AngularVelocity", "BinormalAngularVelocity"):
        bar = damping_pairwise(bar, field, case.nl, case.line_kernel, 3,
                               PHYS_VISC, s.dt)
    bar = _constrain_velocity(bar, case.end_mask)
    bar = bd.bar_stress_relaxation_2nd_half(bar, case.rp, s.dt)
    dt_next = bd.bar_acoustic_time_step(bar, case.material,
                                        case.adaptation.h)
    return BarSim(bar=bar, time=s.time + dt_next, n_steps=s.n_steps + 1,
                  dt=dt_next)


def make_run_chunk(case: BarCase):
    @jax.jit
    def run_chunk(s: BarSim, t_target) -> BarSim:
        return jax.lax.while_loop(lambda st: st.time < t_target,
                                  lambda st: _step(case, st), s)

    return run_chunk


def midspan_displacement(case: BarCase, s: BarSim) -> float:
    """Observer at (PL/2, 0, 0): mean z-displacement of the two center
    particles (the lattice straddles x = 5)."""
    x0 = np.asarray(s.bar["InitialPosition"][:, 0])
    order = np.argsort(np.abs(x0 - 0.5 * PL))[:2]
    dz = np.asarray(s.bar["Position"][:, 2] - s.bar["InitialPosition"][:, 2])
    return float(dz[order].mean())
