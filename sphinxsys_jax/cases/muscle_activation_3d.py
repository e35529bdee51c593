"""3D muscle activation — prescribed linear active-stress ramp contracts
a myocardium cube.

Counterpart of /root/reference/tests/3d_examples/test_3d_muscle_activation/
src/muscle_activation.cpp: a unit Muscle cube (a0=(0.059,..), b0=(8.023,..),
fiber x, bulk 450) with an SL-holder at x<0 held in x only
(FixedInAxisDirection diag(0,1,1) zeroes vel_x), activated by
  Ta_i += -0.5 * 30 * x0_i/PL * dt   for t <= 1  (cpp:43-52)
so the fiber stress Ta f(x)f(x) is COMPRESSIVE (Ta < 0) and strongest at
the free end: the material pushes outward along the fiber and the cube
ELONGATES in x to t_end=1.2 (a positive Ta would contract it).  No
reference DB ships; oracle = monotone x-elongation of the free face with
y/z symmetry.  Deviation: CFL 0.3 (0.6 goes unstable near full
activation where the active stress ~ -14 dwarfs the a0=0.059 passive
shear stiffness).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from sphinxsys_jax.core.adaptation import SPHAdaptation
from sphinxsys_jax.core.materials import Muscle
from sphinxsys_jax.core.state import State
from sphinxsys_jax.neighbors import (build_cell_table, build_neighbor_list,
                                     grid_from_bounds)
from sphinxsys_jax.physics import solid as sd

PL = PH = PW = 1.0
DX = PH / 25.0
SL = 4.0 * DX
RHO0 = 1.0
A0 = (0.059, 0.0, 0.0, 0.0)
B0 = (8.023, 0.0, 0.0, 0.0)
REF_VOLTAGE = 30.0
STRESS_FACTOR = -0.5
BULK = 30.0 * REF_VOLTAGE * abs(STRESS_FACTOR)


class SimState(NamedTuple):
    body: Any
    time: jnp.ndarray
    n_steps: jnp.ndarray
    overflow: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class MuscleActivationCase:
    dx: float
    adaptation: SPHAdaptation
    material: Muscle
    rp: sd.ReferencePairs
    holder_mask: Any
    n: int

    @property
    def kernel(self):
        return self.adaptation.kernel


def build_case(dx: float = DX, dtype=jnp.float32, cell_cap: int = 36,
               k_inner: int = 96):
    adaptation = SPHAdaptation(spacing=dx, dim=3)
    material = Muscle(rho0=RHO0, bulk_modulus_param=BULK,
                      f0=(1.0, 0.0, 0.0), s0=(0.0, 1.0, 0.0),
                      a0=A0, b0=B0)

    xs = np.arange(-SL + dx / 2, PL, dx)
    ys = np.arange(dx / 2, PH, dx)
    zs = np.arange(dx / 2, PW, dx)
    pos = np.stack(np.meshgrid(xs, ys, zs, indexing="ij"), -1).reshape(-1, 3)
    n = len(pos)

    body = dict(sd.make_elastic_solid_state(pos, dx ** 3, material,
                                            dtype=dtype))
    body["ActiveContractionStress"] = jnp.zeros((n,), dtype)
    body["Fiber"] = jnp.broadcast_to(jnp.asarray(material.f0, dtype),
                                     (n, 3))
    holder_mask = jnp.asarray(pos[:, 0] < 0.0)

    lo = (-SL - 4 * dx, -SL, -SL)
    hi = (PL + SL, PH + SL, PW + SL)
    grid = grid_from_bounds(lo, hi, adaptation.cutoff)
    table = jax.jit(partial(build_cell_table, grid=grid, cap=cell_cap))(
        body["Position"], body["NReal"])
    nl = jax.jit(partial(
        build_neighbor_list, grid=grid, cutoff=adaptation.cutoff,
        k_max=k_inner, include_self=False))(
        body["Position"], body["NReal"], body["Position"], body["NReal"],
        table)
    assert not bool(nl.overflow), "raise k_inner: frozen pairs must be exact"
    rp = sd.freeze_reference_pairs(body["Position"], nl, adaptation.kernel, 3)
    body["LinearGradientCorrectionMatrix"] = \
        sd.linear_gradient_correction_matrix(rp, body["VolumetricMeasure"])

    case = MuscleActivationCase(dx=dx, adaptation=adaptation,
                                material=material, rp=rp,
                                holder_mask=holder_mask, n=n)
    return case, body


def init_sim(case: MuscleActivationCase, body: State) -> SimState:
    return SimState(body=body, time=jnp.zeros((), body["Position"].dtype),
                    n_steps=jnp.zeros((), jnp.int32),
                    overflow=jnp.zeros((), bool))


def _activation(case: MuscleActivationCase, body: State, t, dt) -> State:
    """MyocardiumActivation::update (muscle_activation.cpp:43-52)."""
    x0 = body["InitialPosition"][:, 0]
    voltage = jnp.where(x0 <= 0.0, 0.0, REF_VOLTAGE * x0 / PL)
    ramp = jnp.where(t <= 1.0, STRESS_FACTOR * voltage * dt, 0.0)
    out = dict(body)
    out["ActiveContractionStress"] = body["ActiveContractionStress"] + ramp
    return out


def _fix_x(body: State, mask) -> State:
    """FixedInAxisDirection diag(0,1,1): zero vel_x on the holder."""
    out = dict(body)
    vel = body["Velocity"]
    out["Velocity"] = vel.at[:, 0].set(jnp.where(mask, 0.0, vel[:, 0]))
    return out


def _step(case: MuscleActivationCase, s: SimState) -> SimState:
    body = s.body
    dt = sd.solid_acoustic_time_step(body, case.material.sound_speed,
                                     case.adaptation.h, cfl=0.3)
    body = _activation(case, body, s.time, dt)
    body = sd.integration_1st_half_pk2(body, case.rp, case.material, dt,
                                       case.adaptation.h,
                                       case.kernel.w0(3),
                                       active_stress_fn=sd.active_fiber_stress())
    body = _fix_x(body, case.holder_mask)
    body = sd.integration_2nd_half(body, case.rp, dt)
    return SimState(body=body, time=s.time + dt, n_steps=s.n_steps + 1,
                    overflow=s.overflow)


def make_run_chunk(case: MuscleActivationCase):
    @jax.jit
    def run_chunk(s: SimState, t_target) -> SimState:
        return jax.lax.while_loop(lambda st: st.time < t_target,
                                  lambda st: _step(case, st), s)

    return run_chunk


def free_end_x(s: SimState) -> float:
    """Mean current x of the initially free face (x0 > PL - dx)."""
    x0 = s.body["InitialPosition"][:, 0]
    face = x0 > jnp.max(x0) - 1e-6
    return float(jnp.sum(jnp.where(face, s.body["Position"][:, 0], 0.0))
                 / jnp.sum(face))
