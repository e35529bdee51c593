"""3D passive cantilever — anisotropic Muscle material under an oblique
initial kick.

Counterpart of /root/reference/tests/3d_examples/test_3d_passive_cantilever/
passive_cantilever.cpp: a 6x1x1 cantilever (dx=1/12) of passive Muscle
material (a0=(G,0,0,0), b0=(1,0,0,0), fiber x, sheet y, K=E/3(1-2nu)),
clamped by an SL=0.5 holder at x<0, kicked with v=(0, 5 sqrt(3), 5) on
x>0 and left to whip freely to t=3 (Integration1stHalfPK2 + holder
constraint + 2nd half, passive_cantilever.cpp:93-117).  The corner
observer at (PL, PH, PW) swings through y in [-2.9, 4.2] in the
reference's committed DB.
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
from sphinxsys_jax.core.materials import Muscle
from sphinxsys_jax.core.state import State
from sphinxsys_jax.neighbors import (build_cell_table, build_neighbor_list,
                                     grid_from_bounds)
from sphinxsys_jax.physics import solid as sd

PL, PH, PW = 6.0, 1.0, 1.0
SL = 0.5
DX = PH / 12.0
RHO0 = 1100.0
POISSON = 0.45
YOUNGS = 1.7e7
A_ISO = YOUNGS / (2.0 * (1.0 + POISSON))
BULK = YOUNGS / 3.0 / (1.0 - 2.0 * POISSON)
OBSERVER = (PL, PH, PW)


class SimState(NamedTuple):
    body: Any
    time: jnp.ndarray
    n_steps: jnp.ndarray
    overflow: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class CantileverCase:
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
                      a0=(A_ISO, 0.0, 0.0, 0.0), b0=(1.0, 0.0, 0.0, 0.0))

    xs = np.arange(-SL + dx / 2, PL, dx)
    ys = np.arange(dx / 2, PH, dx)
    zs = np.arange(dx / 2, PW, dx)
    pos = np.stack(np.meshgrid(xs, ys, zs, indexing="ij"), -1).reshape(-1, 3)

    body = dict(sd.make_elastic_solid_state(pos, dx ** 3, material,
                                            dtype=dtype))
    vel = np.zeros_like(pos)
    kick = pos[:, 0] > 0.0
    vel[:, 1] = np.where(kick, 5.0 * math.sqrt(3.0), 0.0)
    vel[:, 2] = np.where(kick, 5.0, 0.0)
    body["Velocity"] = jnp.asarray(vel, dtype)
    holder_mask = jnp.asarray(pos[:, 0] < 0.0)

    lo = (-SL - 4 * dx, -PH, -PW)
    hi = (PL + 4 * dx, 2 * PH, 2 * PW)
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

    case = CantileverCase(dx=dx, adaptation=adaptation, material=material,
                          rp=rp, holder_mask=holder_mask, n=len(pos))
    return case, body


def init_sim(case: CantileverCase, body: State) -> SimState:
    return SimState(body=body, time=jnp.zeros((), body["Position"].dtype),
                    n_steps=jnp.zeros((), jnp.int32),
                    overflow=jnp.zeros((), bool))


def _step(case: CantileverCase, s: SimState) -> SimState:
    body = s.body
    dt = sd.solid_acoustic_time_step(body, case.material.sound_speed,
                                     case.adaptation.h, cfl=0.6)
    body = sd.integration_1st_half_pk2(body, case.rp, case.material, dt,
                                       case.adaptation.h,
                                       case.kernel.w0(3))
    body = sd.fix_constraint(body, case.holder_mask)
    body = sd.integration_2nd_half(body, case.rp, dt)
    return SimState(body=body, time=s.time + dt, n_steps=s.n_steps + 1,
                    overflow=s.overflow)


def make_run_chunk(case: CantileverCase):
    @jax.jit
    def run_chunk(s: SimState, t_target) -> SimState:
        return jax.lax.while_loop(lambda st: st.time < t_target,
                                  lambda st: _step(case, st), s)

    return run_chunk


def corner_observer(case: CantileverCase, body: State):
    """Frozen-weight observer at (PL, PH, PW) (passive_cantilever.cpp:19)."""
    pos0 = np.asarray(body["InitialPosition"])
    r = np.linalg.norm(pos0 - np.asarray(OBSERVER), axis=1)
    idx = np.nonzero(r < case.adaptation.cutoff)[0]
    w = np.asarray([float(case.kernel.W(jnp.asarray(ri, pos0.dtype), 3))
                    for ri in r[idx]])
    w = w * np.asarray(body["VolumetricMeasure"])[idx]
    return jnp.asarray(idx), jnp.asarray(w / (w.sum() + 1e-15), pos0.dtype)


def observe_corner(s: SimState, idx, weights) -> np.ndarray:
    return np.asarray(jnp.sum(s.body["Position"][idx] * weights[:, None],
                              axis=0))
