"""3D twisting column — Kirchhoff-decomposed total-Lagrangian solid.

Counterpart of /root/reference/tests/3d_examples/test_3d_twisting_column/
twisting_column.cpp: a 6x1x1 NeoHookean column (rho=1100, E=1.7e7,
nu=0.45), clamped by a one-layer holder at x<0, given a violent initial
twist (angular velocity -400 sin(pi x / 2L) about the x-axis) and left to
oscillate freely to t=0.5.  The tip swings axially between x~3.2 and
x~9.6 — a standard robustness benchmark for the shear/volumetric
decomposed integration (solid.decomposed_integration_1st_half,
DOI 10.1016/j.cma.2014.09.024).

Observer: frozen-weight material interpolation at the free-end center
(PL, 0, 0), reproducing the never-updated observer contact relation
(twisting_column.cpp:100,122-124).
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
from sphinxsys_jax.core.materials import NeoHookeanSolid
from sphinxsys_jax.core.state import State
from sphinxsys_jax.neighbors import (build_cell_table, build_neighbor_list,
                                     grid_from_bounds)
from sphinxsys_jax.physics import solid as sd

PL, PH, PW = 6.0, 1.0, 1.0
DX = PH / 10.0
SL = DX                  # one-layer holder
RHO0 = 1100.0
POISSON = 0.45
YOUNGS = 1.7e7
ANGULAR_0 = -400.0


class SimState(NamedTuple):
    column: Any
    time: jnp.ndarray
    n_steps: jnp.ndarray
    overflow: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class TwistingCase:
    dx: float
    adaptation: SPHAdaptation
    material: NeoHookeanSolid
    rp: Any                    # ReferencePairs (gather engine) or None
    holder_mask: Any
    n_column: int
    lat: Any = None            # solid_lattice.LatticeSolid (lattice engine)

    @property
    def kernel(self):
        return self.adaptation.kernel

    @property
    def engine(self):
        return "lattice" if self.lat is not None else "gather"


def build_case(dx: float = DX, dtype=jnp.float32, cell_cap: int = 36,
               k_inner: int = 96, engine: str = "gather"):
    """engine="gather": frozen (N, K) pair lists (physics/solid.py);
    engine="lattice": the stencil fast path (physics/solid_lattice.py) —
    same physics, per-offset-constant frozen pair data, no neighbor
    tensors (the production path; see tests/test_solid_lattice.py for
    the pairwise-equality gate)."""
    adaptation = SPHAdaptation(spacing=dx, dim=3)
    material = NeoHookeanSolid(rho0=RHO0, youngs_modulus=YOUNGS,
                               poisson_ratio=POISSON)

    # lattice covering the column + holder (twisting_column.cpp:20-23)
    xs = np.arange(-SL + dx / 2, PL, dx)
    ys = np.arange(-PH / 2 + dx / 2, PH / 2, dx)
    zs = np.arange(-PW / 2 + dx / 2, PW / 2, dx)
    pos = np.stack(np.meshgrid(xs, ys, zs, indexing="ij"), -1).reshape(-1, 3)
    lat_shape = (len(xs), len(ys), len(zs))

    column = dict(sd.make_elastic_solid_state(pos, dx ** 3, material,
                                              dtype=dtype))
    # initial twist (InitialCondition, twisting_column.cpp:53-68)
    x, y, z = pos[:, 0], pos[:, 1], pos[:, 2]
    omega = ANGULAR_0 * np.sin(math.pi * x / (2.0 * PL))
    radius = np.sqrt(y * y + z * z)
    ang = np.arctan2(y, z)
    vel = np.zeros_like(pos)
    active = x > 0.0
    vel[:, 1] = np.where(active, omega * radius * np.cos(ang), 0.0)
    vel[:, 2] = np.where(active, -omega * radius * np.sin(ang), 0.0)
    column["Velocity"] = jnp.asarray(vel, dtype)

    holder_mask = jnp.asarray(x < 0.0)

    if engine == "lattice":
        from sphinxsys_jax.physics import solid_lattice as sl
        lat = sl.make_lattice(adaptation.kernel, dx, lat_shape)
        column["LatticeValid"] = jnp.ones(len(pos), bool)
        column["LinearGradientCorrectionMatrix"] = jnp.asarray(
            sl.lattice_correction_matrix(lat, column["LatticeValid"],
                                         dtype=jnp.float64), dtype)
        return TwistingCase(dx=dx, adaptation=adaptation, material=material,
                            rp=None, holder_mask=holder_mask,
                            n_column=len(pos), lat=lat), column

    lo = (-SL - 4 * dx, -PH, -PW)
    hi = (PL + 4 * dx, PH, PW)
    grid = grid_from_bounds(lo, hi, adaptation.cutoff)
    table = jax.jit(partial(build_cell_table, grid=grid, cap=cell_cap))(
        column["Position"], column["NReal"])
    nl = jax.jit(partial(
        build_neighbor_list, grid=grid, cutoff=adaptation.cutoff,
        k_max=k_inner, include_self=False))(
        column["Position"], column["NReal"], column["Position"],
        column["NReal"], table)
    assert not bool(nl.overflow), "raise k_inner: frozen pairs must be exact"
    rp = sd.freeze_reference_pairs(column["Position"], nl, adaptation.kernel,
                                   3)
    column["LinearGradientCorrectionMatrix"] = \
        sd.linear_gradient_correction_matrix(rp, column["VolumetricMeasure"])

    case = TwistingCase(dx=dx, adaptation=adaptation, material=material,
                        rp=rp, holder_mask=holder_mask, n_column=len(pos))
    return case, column


def init_sim(case: TwistingCase, column: State) -> SimState:
    return SimState(column=column,
                    time=jnp.zeros((), column["Position"].dtype),
                    n_steps=jnp.zeros((), jnp.int32),
                    overflow=jnp.zeros((), bool))


def _step(case: TwistingCase, s: SimState) -> SimState:
    col = s.column
    dt = sd.solid_acoustic_time_step(col, case.material.sound_speed,
                                     case.adaptation.h, cfl=0.5)
    if case.lat is not None:
        from sphinxsys_jax.physics import solid_lattice as sl
        col = sl.decomposed_integration_1st_half_lattice(
            col, case.lat, case.material, dt, case.adaptation.h)
        col = sd.fix_constraint(col, case.holder_mask)
        col = sl.integration_2nd_half_lattice(col, case.lat, dt)
    else:
        col = sd.decomposed_integration_1st_half(col, case.rp, case.material,
                                                 dt, case.adaptation.h)
        col = sd.fix_constraint(col, case.holder_mask)
        col = sd.integration_2nd_half(col, case.rp, dt)
    return SimState(column=col, time=s.time + dt, n_steps=s.n_steps + 1,
                    overflow=s.overflow)


def make_run_chunk(case: TwistingCase):
    @jax.jit
    def run_chunk(s: SimState, t_target) -> SimState:
        return jax.lax.while_loop(lambda st: st.time < t_target,
                                  lambda st: _step(case, st), s)

    return run_chunk


def tip_observer(case: TwistingCase, column: State):
    """Frozen-weight observer at (PL, 0, 0) (twisting_column.cpp:89)."""
    tip = np.asarray([PL, 0.0, 0.0])
    pos0 = np.asarray(column["InitialPosition"])
    r = np.linalg.norm(pos0 - tip, axis=1)
    idx = np.nonzero(r < case.adaptation.cutoff)[0]
    kernel = case.kernel
    w = np.asarray([float(kernel.W(jnp.asarray(ri, pos0.dtype), 3))
                    for ri in r[idx]])
    w = w * np.asarray(column["VolumetricMeasure"])[idx]
    return jnp.asarray(idx), jnp.asarray(w / (w.sum() + 1e-15), pos0.dtype)


def observe_tip(s: SimState, idx, weights) -> np.ndarray:
    return np.asarray(jnp.sum(s.column["Position"][idx] * weights[:, None],
                              axis=0))
