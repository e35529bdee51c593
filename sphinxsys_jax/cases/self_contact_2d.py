"""2D dynamic self contact — a whipping thin beam folds onto itself.

Counterpart of /root/reference/tests/2d_examples/test_2d_self_contact/
self_contact.cpp: an extremely flexible cantilever (0.2 x 0.01, E=1e5,
first-mode kick vf=0.15) curls through more than a half turn and presses
against its own flank.  Self contact pairs = particles currently within
the kernel cutoff whose INITIAL separation exceeds it
(NeighborBuilderSelfContact, neighborhood.cpp:128-141), loaded with the
offset penetration factor + symmetric penalty + acoustic impedance
(SelfContactFactorSummation / SelfContactForce).  Integration is the
Kirchhoff-decomposed form (DecomposedIntegration1stHalf) as in the
reference (self_contact.cpp:102).

Deviation: the reference restricts self-contact candidates to a surface
layer (SelfSurfaceContactRelation) purely as an optimization; the dense
sweep here checks all pairs — the initial-distance filter makes the two
equivalent.
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
from sphinxsys_jax.core.materials import SaintVenantKirchhoffSolid
from sphinxsys_jax.core.state import State
from sphinxsys_jax.neighbors import (build_cell_table, build_neighbor_list,
                                     grid_from_bounds)
from sphinxsys_jax.physics import contact as ct
from sphinxsys_jax.physics import solid as sd

PL = 0.2
PH = 0.01
SL = 0.04
DX = PH / 10.0
BW = 4 * DX
RHO0 = 1.0e3
YOUNGS = 1.0e5
POISSON = 0.45
KL = 1.875
_M = math.sin(KL) + math.sinh(KL)
_N = math.cos(KL) + math.cosh(KL)
_Q = 2.0 * (math.cos(KL) * math.sinh(KL) - math.sin(KL) * math.cosh(KL))
VF = 0.15


class SimState(NamedTuple):
    beam: Any
    time: jnp.ndarray
    n_steps: jnp.ndarray
    overflow: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class SelfContactCase:
    dx: float
    adaptation: SPHAdaptation
    grid: Any
    material: SaintVenantKirchhoffSolid
    rp: sd.ReferencePairs
    base_mask: Any
    n: int
    cell_cap: int
    k_contact: int

    @property
    def kernel(self):
        return self.adaptation.kernel


def build_case(dx: float = DX, dtype=jnp.float32, cell_cap: int = 24,
               k_inner: int = 32, k_contact: int = 48):
    # folded flanks stack two material layers in one cell: capacities must
    # hold ~2x the resting occupancy (~9/cell, ~21/kernel-disc at rest)
    adaptation = SPHAdaptation(spacing=dx, dim=2)
    material = SaintVenantKirchhoffSolid(rho0=RHO0, youngs_modulus=YOUNGS,
                                         poisson_ratio=POISSON)

    # beam lattice incl. the clamp frame (createBeamBaseShape + beam)
    xs = np.arange(-SL - BW + dx / 2, PL, dx)
    ys_beam = np.arange(-PH / 2 + dx / 2, PH / 2, dx)
    ys_frame = np.arange(-PH / 2 - BW + dx / 2, PH / 2 + BW, dx)
    pts = []
    for x in xs:
        ys = ys_frame if x < 0.0 else ys_beam
        for y in ys:
            if x < 0.0 or abs(y) < PH / 2:
                pts.append((x, y))
    pos = np.asarray(pts)
    n = len(pos)

    beam = dict(sd.make_elastic_solid_state(pos, dx * dx, material,
                                            dtype=dtype))
    n_arr = beam["Position"].shape[0]
    beam.update({
        "RepulsionForce": jnp.zeros((n_arr, 2), dtype),
        "PreviousRepulsionForce": jnp.zeros((n_arr, 2), dtype),
    })
    # first-mode kick (BeamInitialCondition, self_contact.cpp:70-79)
    x = pos[:, 0] / PL
    c0 = material.sound_speed
    vy = np.where(x > 0.0,
                  VF * c0 / _Q * (_M * (np.cos(KL * x) - np.cosh(KL * x))
                                  - _N * (np.sin(KL * x) - np.sinh(KL * x))),
                  0.0)
    vel = np.zeros_like(pos)
    vel[:, 1] = vy
    beam["Velocity"] = jnp.asarray(vel, dtype)

    # constrained region: the frame minus the beam strip (x < 0, |y| > ...)
    base_mask = jnp.asarray((pos[:, 0] < 0.0) & (np.abs(pos[:, 1]) > PH / 2))

    # the beam curls within a PL-radius ball around the clamp at x=0 —
    # including LEFT past the frame (tip reaches x ~ -0.19 by t=0.35)
    lo = (-1.2 * PL, -1.2 * PL)
    hi = (1.2 * PL, 1.2 * PL)
    grid = grid_from_bounds(lo, hi, adaptation.cutoff)
    table = jax.jit(partial(build_cell_table, grid=grid, cap=cell_cap))(
        beam["Position"], beam["NReal"])
    nl = jax.jit(partial(
        build_neighbor_list, grid=grid, cutoff=adaptation.cutoff,
        k_max=k_inner, include_self=False))(
        beam["Position"], beam["NReal"], beam["Position"], beam["NReal"],
        table)
    assert not bool(nl.overflow), "raise k_inner: frozen pairs must be exact"
    rp = sd.freeze_reference_pairs(beam["Position"], nl, adaptation.kernel, 2)
    beam["LinearGradientCorrectionMatrix"] = \
        sd.linear_gradient_correction_matrix(rp, beam["VolumetricMeasure"])

    case = SelfContactCase(dx=dx, adaptation=adaptation, grid=grid,
                           material=material, rp=rp, base_mask=base_mask,
                           n=n, cell_cap=cell_cap, k_contact=k_contact)
    return case, beam


def init_sim(case: SelfContactCase, beam: State) -> SimState:
    return SimState(beam=beam, time=jnp.zeros((), beam["Position"].dtype),
                    n_steps=jnp.zeros((), jnp.int32),
                    overflow=jnp.zeros((), bool))


def _step(case: SelfContactCase, s: SimState) -> SimState:
    kernel, dim = case.kernel, 2
    beam = s.beam
    cutoff = case.adaptation.cutoff

    # self-contact: current-position list, initial-distance filtered
    table = build_cell_table(beam["Position"], beam["NReal"], case.grid,
                             cap=case.cell_cap)
    nl = build_neighbor_list(beam["Position"], beam["NReal"],
                             beam["Position"], beam["NReal"], table,
                             case.grid, cutoff, k_max=case.k_contact,
                             include_self=False)
    nl_self = ct.filter_self_contact_pairs(nl, beam["InitialPosition"],
                                           cutoff)
    factor = ct.repulsion_factor_self(beam, nl_self, kernel, dim, case.dx)
    beam = ct.repulsion_force_self(beam, nl_self, kernel, dim, factor, RHO0,
                                   ct.contact_stiffness(case.material))

    dt = sd.solid_acoustic_time_step(beam, case.material.sound_speed,
                                     case.adaptation.h, cfl=0.6)
    beam = sd.decomposed_integration_1st_half(beam, case.rp, case.material,
                                              dt, case.adaptation.h)
    beam = sd.fix_constraint(beam, case.base_mask)
    beam = sd.integration_2nd_half(beam, case.rp, dt)
    return SimState(beam=beam, time=s.time + dt, n_steps=s.n_steps + 1,
                    overflow=s.overflow | nl.overflow)


def make_run_chunk(case: SelfContactCase):
    @jax.jit
    def run_chunk(s: SimState, t_target) -> SimState:
        return jax.lax.while_loop(lambda st: st.time < t_target,
                                  lambda st: _step(case, st), s)

    return run_chunk


def tip_observer(case: SelfContactCase, beam: State):
    """Frozen-weight observer at (PL, 0) (self_contact.cpp:97)."""
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
