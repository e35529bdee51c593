"""Mixed rigid-elastic bar under a twisting + bending end load.

Counterpart of /root/reference/tests/3d_examples/
test_3d_twisting_rigid_elastic_bar/test_3d_twisting_rigid_elastic_bar.cpp:
a NeoHookean bar (x in [-2, 3], 1 x 1 cross-section, z in [0, 1],
rho = 1e-3, E = 5, nu = 0.45, dp = 1/(4 res)) whose last unit length
(x > 2) is RIGID — a free 6-DOF mobilized body driven by the SPH coupling
force on its particles plus an external load (force (0, -P, 0), torque
(-P h, 0, 0), P ramping to 0.05 over t = 1) — while the elastic part runs
PK2 stress relaxation with the clamp at x < -2 and pairwise velocity
damping whose relation EXCLUDES rigid-involved pairs
(ExcludeRigidNeighbors, cpp:79-103).  The loop interleaves the rigid
constraint around every elastic sub-stage exactly as cpp:355-385.

Run to steady state (displacement change < 1e-2 over 5 consecutive 0.2 s
outputs, max t = 5); oracle: FEBio displacements at the 4 interface
corners (reference_data/displacement) within 15%
(https://help.febio.org/FEBioTheory/FEBio_tm_3-4-Section-7.10.html).
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from sphinxsys_jax.core.adaptation import SPHAdaptation
from sphinxsys_jax.core.materials import NeoHookeanSolid
from sphinxsys_jax.neighbors import (build_cell_table, build_neighbor_list,
                                     grid_from_bounds)
from sphinxsys_jax.physics import dissipation as dpp
from sphinxsys_jax.physics import rigid as rgd
from sphinxsys_jax.physics import solid as sd

ELASTIC_L = 4.0
RIGID_L = 1.0
HEIGHT = 1.0
WIDTH = 1.0
X0 = -2.0
RHO0 = 1000.0 * 1e-6          # 1000 * unit_mm^2
YOUNGS = 5.0
POISSON = 0.45
P_MAX = 0.05
MAX_END_TIME = 5.0


def physical_viscosity(shape_constant: float = 0.4) -> float:
    import math
    return shape_constant / 4.0 * math.sqrt(RHO0 * YOUNGS) * HEIGHT


class BarSim(NamedTuple):
    bar: Any
    rb: Any               # RigidBody3D
    time: jnp.ndarray
    n_steps: jnp.ndarray
    dt: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class BarCase:
    dp: float
    adaptation: SPHAdaptation
    material: NeoHookeanSolid
    rp: sd.ReferencePairs
    nl_damp: Any           # damping relation, rigid-involved pairs excluded
    clamp_mask: Any
    rigid_mask: Any
    rb0: Any
    initial_pos: Any
    n_bar: int

    @property
    def kernel(self):
        return self.adaptation.kernel


def force_p(t):
    """Load ramp (cpp:228-231): P = 0.05 min(t, 1)."""
    return P_MAX * jnp.minimum(t, 1.0)


def build_case(res_factor: int = 2, dtype=jnp.float64, k_inner: int = 96,
               cell_cap: int = 40):
    dp = WIDTH / (4.0 * res_factor)
    adaptation = SPHAdaptation(spacing=dp, dim=3)
    material = NeoHookeanSolid(rho0=RHO0, youngs_modulus=YOUNGS,
                               poisson_ratio=POISSON)

    # full bar incl. one clamp layer: x in [X0 - dp, X0 + 5]
    xs = np.arange(X0 - dp + dp / 2, X0 + ELASTIC_L + RIGID_L, dp)
    ys = np.arange(-0.5 * HEIGHT + dp / 2, 0.5 * HEIGHT, dp)
    zs = np.arange(dp / 2, WIDTH, dp)
    pos = np.stack(np.meshgrid(xs, ys, zs, indexing="ij"), -1).reshape(-1, 3)
    n = len(pos)

    bar = dict(sd.make_elastic_solid_state(pos, dp ** 3, material,
                                           dtype=dtype))

    clamp_mask = jnp.asarray(pos[:, 0] < X0)
    rigid_mask = jnp.asarray(pos[:, 0] > X0 + ELASTIC_L)

    lo = (X0 - 6 * dp, -HEIGHT - 3.0, -WIDTH - 3.0)
    hi = (X0 + ELASTIC_L + RIGID_L + 3.0, HEIGHT + 3.0, WIDTH + 3.0)
    grid = grid_from_bounds(lo, hi, adaptation.cutoff)
    table = build_cell_table(bar["Position"], bar["NReal"], grid,
                             cap=cell_cap)
    nl = build_neighbor_list(bar["Position"], bar["NReal"], bar["Position"],
                             bar["NReal"], table, grid, adaptation.cutoff,
                             k_max=k_inner, include_self=False)
    assert not bool(nl.overflow), "raise k_inner"
    rp = sd.freeze_reference_pairs(bar["Position"], nl, adaptation.kernel, 3)
    bar["LinearGradientCorrectionMatrix"] = \
        sd.linear_gradient_correction_matrix(rp, bar["VolumetricMeasure"])

    # damping relation: drop pairs where EITHER side is rigid
    rigid_np = np.asarray(rigid_mask)
    idx = np.asarray(nl.idx)
    j_rigid = np.where(idx < n, rigid_np[np.minimum(idx, n - 1)], False)
    drop = j_rigid | rigid_np[:, None]
    nl_damp = nl._replace(idx=jnp.asarray(np.where(drop, n, idx)))

    rb0 = rgd.rigid_body_from_particles_3d(bar, rigid_mask)

    case = BarCase(dp=dp, adaptation=adaptation, material=material, rp=rp,
                   nl_damp=nl_damp, clamp_mask=clamp_mask,
                   rigid_mask=rigid_mask, rb0=rb0,
                   initial_pos=bar["Position"], n_bar=n)
    sim = BarSim(bar=bar, rb=rb0, time=jnp.zeros((), dtype),
                 n_steps=jnp.zeros((), jnp.int32),
                 dt=jnp.asarray(1e-5, dtype))
    return case, sim


def _constrain_rigid(case, bar, rb):
    return rgd.constrain_by_rigid_body_3d(bar, case.rigid_mask, rb,
                                          case.initial_pos, case.rb0.com)


def _step(case: BarCase, s: BarSim) -> BarSim:
    h = case.adaptation.h
    kernel = case.kernel
    w0 = kernel.w0(3)
    dt = s.dt
    bar, rb = dict(s.bar), s.rb

    bar = sd.integration_1st_half_pk2(bar, case.rp, case.material, dt, h, w0)
    bar = _constrain_rigid(case, bar, rb)

    bar = sd.fix_constraint(bar, case.clamp_mask)
    # DampingWithRandomChoice(0.5, ..., 2 eta): every step at 2 eta/0.5
    eta = 2.0 * physical_viscosity() / 0.5
    bar = dpp.damping_pairwise(bar, "Velocity", case.nl_damp, kernel, 3,
                               eta, dt)
    bar = sd.fix_constraint(bar, case.clamp_mask)
    bar = _constrain_rigid(case, bar, rb)

    # rigid update from the coupling force + external load (cpp:232-243)
    f_c, tq_c = rgd.total_force_and_torque_3d(bar, case.rigid_mask, rb)
    P = force_p(s.time)
    f_ext = jnp.stack([jnp.zeros_like(P), -P, jnp.zeros_like(P)])
    tq_ext = jnp.stack([-P * HEIGHT, jnp.zeros_like(P), jnp.zeros_like(P)])
    rb = rgd.rigid_step_3d(rb, f_c + f_ext, tq_c + tq_ext, dt)
    bar = _constrain_rigid(case, bar, rb)

    bar = sd.integration_2nd_half(bar, case.rp, dt)
    bar = _constrain_rigid(case, bar, rb)

    dt_next = sd.solid_acoustic_time_step(bar, case.material.sound_speed, h)
    return BarSim(bar=bar, rb=rb, time=s.time + dt, n_steps=s.n_steps + 1,
                  dt=dt_next)


def make_run_chunk(case: BarCase):
    @jax.jit
    def run_chunk(s: BarSim, t_target) -> BarSim:
        return jax.lax.while_loop(lambda st: st.time < t_target,
                                  lambda st: _step(case, st), s)

    return run_chunk


# FEBio reference (reference_data/displacement at reference_data/
# initial_position): interface corner points (x=2) -> displacement
OBSERVERS = np.asarray([
    (2.0, 0.5, 0.0),
    (2.0, 0.5, 1.0),
    (2.0, -0.5, 0.0),
    (2.0, -0.5, 1.0),
])
# line-by-line with reference_data/initial_position (read_ref_data drops
# the leading ID column)
FEBIO_DISP = {
    (2.0, 0.5, 0.0): (-0.504557, -2.60476, 0.0948022),
    (2.0, 0.5, 1.0): (-0.244248, -2.16765, -0.0442815),
    (2.0, -0.5, 0.0): (-1.21962, -2.11663, 0.570901),
    (2.0, -0.5, 1.0): (-0.959311, -1.67953, 0.431817),
}


def observer_displacements(case: BarCase, s: BarSim) -> np.ndarray:
    """Nearest-material-particle displacement at the 4 interface corners
    (the reference observer uses corrected kernel interpolation; at the
    corner the nearest particle is within dp/2)."""
    pos0 = np.asarray(case.initial_pos)
    pos = np.asarray(s.bar["Position"])
    out = []
    for p in OBSERVERS:
        i = int(np.argmin(np.linalg.norm(pos0 - p, axis=1)))
        out.append(pos[i] - pos0[i])
    return np.asarray(out)
