"""2D oscillating beam — the canonical total-Lagrangian solid case.

Scene and constants mirror the reference case
/root/reference/tests/2d_examples/test_2d_oscillating_beam/oscillating_beam.cpp:
  * beam 0.2 x 0.02, clamped insert of depth 0.06, dx = PH/10
  * SaintVenantKirchhoff: rho0 = 1e3, E = 2e6, nu = 0.3975
  * first-mode initial velocity profile, tip observer at (PL, 0)
  * loop: 1st half -> fix constraint -> 2nd half; dt from the elastic
    acoustic criterion (computed after the step, first dt = 0)

XLA-native: the solid neighbor topology is the frozen initial
configuration (one static pair tensor), so a whole time chunk runs as a
single jitted lax.while_loop with zero neighbor rebuilds.
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
from sphinxsys_jax.core.generators import generate_lattice
from sphinxsys_jax.core.materials import SaintVenantKirchhoffSolid
from sphinxsys_jax.core.state import State
from sphinxsys_jax.neighbors import grid_from_bounds, build_cell_table, build_neighbor_list
from sphinxsys_jax.physics import solid as sd
from sphinxsys_jax.utils.hosteval import host_eval

# case constants (oscillating_beam.cpp:14-36)
PL = 0.2
PH = 0.02
SL = 0.06
RHO0_S = 1.0e3
YOUNGS = 2.0e6
POISSON = 0.3975

KL = 1.875
_M = math.sin(KL) + math.sinh(KL)
_N = math.cos(KL) + math.cosh(KL)
_Q = 2.0 * (math.cos(KL) * math.sinh(KL) - math.sin(KL) * math.cosh(KL))
VF = 0.05


class BeamSim(NamedTuple):
    solid: Any
    time: jnp.ndarray
    n_steps: jnp.ndarray
    dt: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class BeamCase:
    dx: float
    adaptation: SPHAdaptation
    material: SaintVenantKirchhoffSolid
    rp: sd.ReferencePairs
    base_mask: jnp.ndarray  # constrained particles
    n_solid: int
    grid: Any = None        # background grid (slab decomposition domain)
    integrator: str = "pk2"  # "pk2" | "cauchy" (Integration1stHalfCauchy)

    @property
    def kernel(self):
        return self.adaptation.kernel


def build_case(dx: float | None = None, dtype=jnp.float32, k_inner: int = 64,
               integrator: str = "pk2"):
    dx = dx or PH / 10.0
    adaptation = SPHAdaptation(spacing=dx, dim=2)
    BW = dx * 4

    # base band x in [-SL-BW, 0], beam x in [-SL, PL] (oscillating_beam.cpp:41-47)
    base_shape = G.Box(G.Transform(translation=(-(SL + BW) / 2, 0.0)),
                       halfsize=((SL + BW) / 2, PH / 2 + BW))
    beam_shape = G.Box(G.Transform(translation=((PL - SL) / 2, 0.0)),
                       halfsize=((PL + SL) / 2, PH / 2))
    body_shape = G.make_complex(("add", base_shape), ("add", beam_shape))

    dom_lo = (-SL - BW, -PL / 2)
    dom_hi = (PL + 3 * BW, PL / 2)
    pos, vol = generate_lattice(body_shape, dom_lo, dom_hi, dx)

    material = SaintVenantKirchhoffSolid(rho0=RHO0_S, youngs_modulus=YOUNGS,
                                         poisson_ratio=POISSON)
    solid = sd.make_elastic_solid_state(pos, vol, material, dtype=dtype)

    # frozen initial-configuration topology
    grid = grid_from_bounds(dom_lo, dom_hi, adaptation.cutoff)
    table = build_cell_table(solid["Position"], solid["NReal"], grid,
                             cap=32)
    nl = build_neighbor_list(solid["Position"], solid["NReal"], solid["Position"],
                             solid["NReal"], table, grid, adaptation.cutoff,
                             k_max=k_inner, include_self=False)
    assert not bool(nl.overflow), "raise k_inner / cell cap"
    rp = sd.freeze_reference_pairs(solid["Position"], nl, adaptation.kernel, 2)
    B = sd.linear_gradient_correction_matrix(rp, solid["VolumetricMeasure"])
    solid = dict(solid)
    solid["LinearGradientCorrectionMatrix"] = B

    # constrained region = base shape MINUS beam shape (createBeamConstrainShape,
    # oscillating_beam.cpp:89-96): the clamp frame around the inserted beam end
    in_base = host_eval(base_shape.contains, jnp.asarray(pos))
    in_beam = host_eval(beam_shape.contains, jnp.asarray(pos))
    base_mask = jnp.asarray(in_base & ~in_beam)

    # first-mode initial velocity (oscillating_beam.cpp BeamInitialCondition)
    x = np.asarray(pos)[:, 0] / PL
    c0 = material.sound_speed
    vy = np.where(
        x > 0.0,
        VF * c0 * (_M * (np.cos(KL * x) - np.cosh(KL * x))
                   - _N * (np.sin(KL * x) - np.sinh(KL * x))) / _Q,
        0.0)
    vel = np.zeros_like(np.asarray(pos))
    vel[:, 1] = vy
    solid["Velocity"] = jnp.asarray(vel, dtype=dtype)

    case = BeamCase(dx=dx, adaptation=adaptation, material=material, rp=rp,
                    base_mask=base_mask, n_solid=len(pos), grid=grid,
                    integrator=integrator)
    sim = BeamSim(solid=solid, time=jnp.zeros((), dtype),
                  n_steps=jnp.zeros((), jnp.int32), dt=jnp.zeros((), dtype))
    return case, sim


def _step(case: BeamCase, s: BeamSim) -> BeamSim:
    h = case.adaptation.h
    w0 = case.kernel.w0(2)
    pk1_fn = sd.cauchy_pk1_fn(case.material) if case.integrator == "cauchy" else None
    solid = sd.integration_1st_half_pk2(s.solid, case.rp, case.material, s.dt,
                                        h, w0, pk1_fn=pk1_fn)
    solid = sd.fix_constraint(solid, case.base_mask)
    solid = sd.integration_2nd_half(solid, case.rp, s.dt)
    dt_next = sd.solid_acoustic_time_step(solid, case.material.sound_speed, h)
    return BeamSim(solid=solid, time=s.time + dt_next, n_steps=s.n_steps + 1,
                   dt=dt_next)


def make_run_chunk(case: BeamCase):
    @jax.jit
    def run_chunk(s: BeamSim, t_target) -> BeamSim:
        return jax.lax.while_loop(lambda st: st.time < t_target,
                                  lambda st: _step(case, st), s)

    return run_chunk


def tip_displacement(case: BeamCase, s: BeamSim):
    """y-displacement of the particle nearest the tip observer (PL, 0)."""
    pos0 = np.asarray(s.solid["InitialPosition"])[: case.n_solid]
    i = int(np.argmin(np.linalg.norm(pos0 - np.asarray([PL, 0.0]), axis=1)))
    return float(s.solid["Position"][i, 1] - s.solid["InitialPosition"][i, 1])
