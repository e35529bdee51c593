"""Multi-resolution oscillating cantilever beam (adaptive-h solid).

Counterpart of tests/2d_examples/test_2d_mr_cantilever_beam/
test_2d_mr_cantilever_beam.cpp: the SAME beam as cases/oscillating_beam_2d
(0.2 x 0.02, SaintVenantKirchhoff, first-mode release) but with the TIP
HALF refined (AdaptiveWithinShape, refinement_region = the outer
0.5 * length, cpp:172-195): particle spacing dx/2 and smoothing length
h/2 inside the refinement region, dx outside.

The total-Lagrangian topology is frozen ONCE from the adaptive multi-level
neighbor search (neighbors/multilevel.py), with every pair evaluated at
the pair smoothing length max(h_i, h_j)
(solid.freeze_adaptive_reference_pairs); the solid integrators then run
unchanged.  Oracle: the MR beam reproduces the uniform beam's tip
oscillation period.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from sphinxsys_jax.core import geometry as G
from sphinxsys_jax.core.adaptation import SPHAdaptation
from sphinxsys_jax.core.generators import generate_lattice
from sphinxsys_jax.core.materials import SaintVenantKirchhoffSolid
from sphinxsys_jax.neighbors.multilevel import (build_adaptive_neighbor_list,
                                                build_multilevel_tables)
from sphinxsys_jax.physics import solid as sd
from sphinxsys_jax.utils.hosteval import host_eval

PL = 0.2
PH = 0.02
SL = 0.06
RHO0_S = 1.0e3
YOUNGS = 2.0e6
POISSON = 0.3975
REFINE_X0 = 0.5 * PL       # refinement region: x >= PL/2 (tip half)

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
class MRBeamCase:
    dx: float
    adaptation: SPHAdaptation
    material: SaintVenantKirchhoffSolid
    rp: sd.ReferencePairs
    base_mask: jnp.ndarray
    n_solid: int

    @property
    def kernel(self):
        return self.adaptation.kernel


def build_case(dx: float | None = None, dtype=jnp.float32,
               k_levels=(160, 224)):
    dx = dx or PH / 8.0
    adaptation = SPHAdaptation(spacing=dx, dim=2)
    BW = dx * 4

    base_shape = G.Box(G.Transform(translation=(-(SL + BW) / 2, 0.0)),
                       halfsize=((SL + BW) / 2, PH / 2 + BW))
    beam_shape = G.Box(G.Transform(translation=((PL - SL) / 2, 0.0)),
                       halfsize=((PL + SL) / 2, PH / 2))
    body_shape = G.make_complex(("add", base_shape), ("add", beam_shape))

    dom_lo = (-SL - BW, -PL / 2)
    dom_hi = (PL + 3 * BW, PL / 2)
    # coarse lattice outside the refinement region, fine (dx/2) inside
    pos_c, vol_c = generate_lattice(body_shape, dom_lo, dom_hi, dx)
    pos_f, vol_f = generate_lattice(body_shape, dom_lo, dom_hi, dx / 2)
    keep_c = pos_c[:, 0] < REFINE_X0
    keep_f = pos_f[:, 0] >= REFINE_X0
    pos = np.concatenate([pos_c[keep_c], pos_f[keep_f]])
    vols = np.concatenate([np.full(keep_c.sum(), vol_c),
                           np.full(keep_f.sum(), vol_f)])
    h_ratio = np.concatenate([np.ones(keep_c.sum()),
                              np.full(keep_f.sum(), 2.0)])

    material = SaintVenantKirchhoffSolid(rho0=RHO0_S, youngs_modulus=YOUNGS,
                                         poisson_ratio=POISSON)
    solid = dict(sd.make_elastic_solid_state(pos, vols, material,
                                             dtype=dtype))
    solid["SmoothingLengthRatio"] = jnp.asarray(h_ratio, dtype)

    # adaptive frozen topology (multi-level search once)
    n = len(pos)
    hr = jnp.asarray(h_ratio, dtype)
    ml = build_multilevel_tables(solid["Position"], jnp.int32(n), hr,
                                 dom_lo, dom_hi, adaptation.h,
                                 kernel_size=2.0, n_levels=2, cap=64)
    nl = build_adaptive_neighbor_list(solid["Position"], jnp.int32(n), hr,
                                      solid["Position"], hr, ml, 2.0,
                                      adaptation.h,
                                      k_max_per_level=list(k_levels))
    assert not bool(nl.overflow), "raise k_levels"
    rp = sd.freeze_adaptive_reference_pairs(solid["Position"], hr, nl,
                                            adaptation.kernel, 2)
    solid["LinearGradientCorrectionMatrix"] = \
        sd.linear_gradient_correction_matrix(rp, solid["VolumetricMeasure"])

    in_base = host_eval(base_shape.contains, jnp.asarray(pos))
    in_beam = host_eval(beam_shape.contains, jnp.asarray(pos))
    base_mask = jnp.asarray(in_base & ~in_beam)

    x = np.asarray(pos)[:, 0] / PL
    c0 = material.sound_speed
    vy = np.where(x > 0.0,
                  VF * c0 * (_M * (np.cos(KL * x) - np.cosh(KL * x))
                             - _N * (np.sin(KL * x) - np.sinh(KL * x))) / _Q,
                  0.0)
    vel = np.zeros_like(np.asarray(pos))
    vel[:, 1] = vy
    solid["Velocity"] = jnp.asarray(vel, dtype)

    case = MRBeamCase(dx=dx, adaptation=adaptation, material=material, rp=rp,
                      base_mask=base_mask, n_solid=n)
    sim = BeamSim(solid=solid, time=jnp.zeros((), dtype),
                  n_steps=jnp.zeros((), jnp.int32), dt=jnp.zeros((), dtype))
    return case, sim


def _step(case: MRBeamCase, rp: sd.ReferencePairs, s: BeamSim) -> BeamSim:
    h_fine = case.adaptation.h / 2.0    # dt and damping at the finest level
    solid = sd.integration_1st_half_pk2(s.solid, rp, case.material,
                                        s.dt, h_fine, 1.0)
    solid = sd.fix_constraint(solid, case.base_mask)
    solid = sd.integration_2nd_half(solid, rp, s.dt)
    dt_next = sd.solid_acoustic_time_step(solid, case.material.sound_speed,
                                          h_fine)
    return BeamSim(solid=solid, time=s.time + dt_next,
                   n_steps=s.n_steps + 1, dt=dt_next)


def make_run_chunk(case: MRBeamCase):
    # the frozen pairs enter as TRACED arguments — as jit closure constants
    # XLA spends minutes constant-folding gathers over the (N, K) tensors
    @jax.jit
    def _run(s: BeamSim, t_target, rp: sd.ReferencePairs) -> BeamSim:
        return jax.lax.while_loop(lambda st: st.time < t_target,
                                  lambda st: _step(case, rp, st), s)

    def run_chunk(s: BeamSim, t_target) -> BeamSim:
        return _run(s, t_target, case.rp)

    return run_chunk


def tip_displacement(case: MRBeamCase, s: BeamSim):
    pos0 = np.asarray(s.solid["InitialPosition"])[: case.n_solid]
    i = int(np.argmin(np.linalg.norm(pos0 - np.asarray([PL, 0.0]), axis=1)))
    return float(s.solid["Position"][i, 1] - s.solid["InitialPosition"][i, 1])
