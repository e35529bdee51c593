"""2D Eulerian Taylor-Green vortex with the Laguerre-Gauss kernel.

Counterpart of /root/reference/tests/2d_examples/
test_2d_eulerian_taylor_green_LG/2d_eulerian_taylor_green_LG.cpp: static
control volumes on a doubly periodic unit box, compressible HLLC
two-half integration (gamma = 1.4, c = 10 U so the flow is effectively
incompressible at Ma = 0.1), viscous momentum source at Re = 100, and
the 5th-order Laguerre-Gauss kernel (kernel_laguerre_gauss.cpp) the case
is named for.  Initial field u = -cos(2 pi x) sin(2 pi y),
v = sin(2 pi x) cos(2 pi y) (cpp:55-66).

Because the particles never move, the neighbor topology is built ONCE —
the Eulerian path exercises the frozen-relation fast configuration the
reference gets from its static CellLinkedList.

Oracle: the analytic decay KE(t) = KE(0) exp(-16 pi^2 nu t); the
reference's own ensemble DB (WaterBody_TotalKineticEnergy) tracks the
same law.
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
from sphinxsys_jax.core.kernels import LaguerreGauss
from sphinxsys_jax.core.materials import CompressibleFluid
from sphinxsys_jax.core.state import State
from sphinxsys_jax.neighbors import (build_cell_table, build_neighbor_list,
                                     grid_from_bounds)
from sphinxsys_jax.physics import eulerian as eu
from sphinxsys_jax.physics import fluid as fd

DL = 1.0
RHO0_F = 1.0
U_F = 1.0
C_F = 10.0 * U_F
RE = 100.0
MU_F = RHO0_F * U_F * DL / RE
GAMMA = 1.4


class SimState(NamedTuple):
    fluid: Any
    time: jnp.ndarray
    n_steps: jnp.ndarray
    overflow: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class EulerianTGCase:
    dx: float
    adaptation: SPHAdaptation
    gas: CompressibleFluid
    nl: Any
    box: Any
    n_fluid: int

    @property
    def kernel(self):
        return self.adaptation.kernel


def build_case(dx: float = DL / 50.0, dtype=jnp.float32, cell_cap: int = 24,
               k_inner: int = 48):
    adaptation = SPHAdaptation(spacing=dx, dim=2,
                               kernel_cls=LaguerreGauss)
    xs = np.arange(dx / 2, DL, dx)
    pos = np.stack(np.meshgrid(xs, xs, indexing="ij"), -1).reshape(-1, 2)
    x, y = pos[:, 0], pos[:, 1]
    vel = np.stack([-np.cos(2 * math.pi * x) * np.sin(2 * math.pi * y),
                    np.sin(2 * math.pi * x) * np.cos(2 * math.pi * y)], -1)
    gas = CompressibleFluid(rho0=RHO0_F, gamma=GAMMA)
    p0 = C_F * C_F * RHO0_F / GAMMA  # cpp:59
    fluid = eu.make_compressible_eulerian_state(pos, dx * dx, gas, RHO0_F,
                                                p0, vel0=vel, dtype=dtype)
    fluid["ViscousForce"] = jnp.zeros_like(fluid["Velocity"])
    fluid["ViscousForcePrev"] = jnp.zeros_like(fluid["Velocity"])

    grid = grid_from_bounds((0.0, 0.0), (DL, DL), adaptation.cutoff,
                            periodic=(True, True))
    table = jax.jit(partial(build_cell_table, grid=grid, cap=cell_cap))(
        fluid["Position"], fluid["NReal"])
    nl = jax.jit(partial(build_neighbor_list, grid=grid,
                         cutoff=adaptation.cutoff, k_max=k_inner,
                         include_self=False))(
        fluid["Position"], fluid["NReal"], fluid["Position"],
        fluid["NReal"], table)
    assert not bool(nl.overflow)

    case = EulerianTGCase(dx=dx, adaptation=adaptation, gas=gas, nl=nl,
                          box=grid.periodic_lengths, n_fluid=len(pos))
    return case, fluid


def init_sim(case: EulerianTGCase, fluid: State) -> SimState:
    dtype = fluid["Position"].dtype
    return SimState(fluid=dict(fluid), time=jnp.zeros((), dtype),
                    n_steps=jnp.zeros((), jnp.int32),
                    overflow=jnp.zeros((), bool))


def _step(case: EulerianTGCase, s: SimState) -> SimState:
    kernel, dim = case.kernel, 2
    h = case.adaptation.h
    f = s.fluid
    dt = eu.compressible_time_step(f, case.gas, h, cfl=0.6, dim=dim)
    f = fd.viscous_force(f, case.nl, kernel, dim, MU_F, h, box=case.box)
    f = eu.compressible_integration_1st_half(f, case.nl, kernel, dim,
                                             case.gas, dt, box=case.box,
                                             limiter=1.0)
    f = eu.compressible_integration_2nd_half(f, case.nl, kernel, dim,
                                             case.gas, dt, box=case.box,
                                             limiter=1.0)
    return SimState(fluid=f, time=s.time + dt, n_steps=s.n_steps + 1,
                    overflow=s.overflow)


def make_run_chunk(case: EulerianTGCase):
    @jax.jit
    def run_chunk(s: SimState, t_target) -> SimState:
        return jax.lax.while_loop(lambda st: st.time < t_target,
                                  lambda st: _step(case, st), s)

    return run_chunk


def kinetic_energy(s: SimState) -> float:
    f = s.fluid
    v2 = np.sum(np.asarray(f["Velocity"]) ** 2, axis=-1)
    m = np.asarray(f["Mass"])
    return float(0.5 * np.sum(m * v2))
