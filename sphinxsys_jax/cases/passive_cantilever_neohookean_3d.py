"""3D NeoHookean cantilever sagging under gravity with physical damping.

Counterpart of /root/reference/tests/3d_examples/
test_3d_passive_cantilever_neohookean/passive_cantilever_neohookean.cpp:
a 0.1 x 0.04 x 0.04 NeoHookean block (rho 1265, E 5e4, nu 0.45), clamped
by an SL=0.02 holder at x<0, dropped into full gravity (0,-9.8,0) at
t=0 with pairwise velocity damping eta=50 (the reference's
DampingWithRandomChoice(0.1, ..., physical_viscosity) equals plain
per-step damping in expectation).  Corner observer at (PL, PH, PW);
reference DB (CantileverObserver_Position): first minimum y ~ -0.00117
at t ~ 0.17, settled y ~ 0.00382 (static droop ~0.0322) by t = 1.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from sphinxsys_jax.core.adaptation import SPHAdaptation
from sphinxsys_jax.core.materials import NeoHookeanSolid
from sphinxsys_jax.core.state import State
from sphinxsys_jax.neighbors import (build_cell_table, build_neighbor_list,
                                     grid_from_bounds)
from sphinxsys_jax.physics import dissipation as dp
from sphinxsys_jax.physics import solid as sd

PL, PH, PW = 0.1, 0.04, 0.04
SL = 0.02
DX = PH / 6.0
RHO0 = 1265.0
POISSON = 0.45
YOUNGS = 5.0e4
ETA = 50.0                       # physical_viscosity
GRAVITY = (0.0, -9.8, 0.0)
OBSERVER = (PL, PH, PW)


class SimState(NamedTuple):
    body: Any
    time: jnp.ndarray
    n_steps: jnp.ndarray
    overflow: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class NeoHookeanCantileverCase:
    dx: float
    adaptation: SPHAdaptation
    material: NeoHookeanSolid
    rp: sd.ReferencePairs
    nl: Any
    holder_mask: Any
    n: int

    @property
    def kernel(self):
        return self.adaptation.kernel


def build_case(dx: float = DX, dtype=jnp.float32, cell_cap: int = 36,
               k_inner: int = 96):
    adaptation = SPHAdaptation(spacing=dx, dim=3)
    material = NeoHookeanSolid(rho0=RHO0, youngs_modulus=YOUNGS,
                               poisson_ratio=POISSON)

    xs = np.arange(-SL + dx / 2, PL, dx)
    ys = np.arange(dx / 2, PH, dx)
    zs = np.arange(dx / 2, PW, dx)
    pos = np.stack(np.meshgrid(xs, ys, zs, indexing="ij"), -1).reshape(-1, 3)

    body = dict(sd.make_elastic_solid_state(pos, dx ** 3, material,
                                            dtype=dtype))
    g = jnp.asarray(GRAVITY, dtype)
    body["ForcePrior"] = body["Mass"][:, None] * g
    holder_mask = jnp.asarray(pos[:, 0] < 0.0)

    lo = (-SL - 4 * dx, -2 * PH, -PW)
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

    case = NeoHookeanCantileverCase(dx=dx, adaptation=adaptation,
                                    material=material, rp=rp, nl=nl,
                                    holder_mask=holder_mask, n=len(pos))
    return case, body


def init_sim(case: NeoHookeanCantileverCase, body: State) -> SimState:
    return SimState(body=body, time=jnp.zeros((), body["Position"].dtype),
                    n_steps=jnp.zeros((), jnp.int32),
                    overflow=jnp.zeros((), bool))


def _step(case: NeoHookeanCantileverCase, s: SimState) -> SimState:
    body = s.body
    dt = sd.solid_acoustic_time_step(body, case.material.sound_speed,
                                     case.adaptation.h, cfl=0.6)
    body = sd.integration_1st_half_pk2(body, case.rp, case.material, dt,
                                       case.adaptation.h,
                                       case.kernel.w0(3))
    body = sd.fix_constraint(body, case.holder_mask)
    # muscle_damping: pairwise implicit on Velocity (passive_cantilever_
    # neohookean.cpp:90-91); 2 sweeps carry eta exactly (dissipation.py)
    body = dp.damping_pairwise(body, "Velocity", case.nl, case.kernel, 3,
                               ETA, dt)
    body = sd.fix_constraint(body, case.holder_mask)
    body = sd.integration_2nd_half(body, case.rp, dt)
    return SimState(body=body, time=s.time + dt, n_steps=s.n_steps + 1,
                    overflow=s.overflow)


def make_run_chunk(case: NeoHookeanCantileverCase):
    @jax.jit
    def run_chunk(s: SimState, t_target) -> SimState:
        return jax.lax.while_loop(lambda st: st.time < t_target,
                                  lambda st: _step(case, st), s)

    return run_chunk


def corner_observer(case: NeoHookeanCantileverCase, body: State):
    """Frozen-weight observer at (PL, PH, PW)."""
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
