"""Filling a plane tank from an inlet jet — emitter injection benchmark.

Counterpart of /root/reference/tests/2d_examples/test_2d_filling_tank/
filling_tank.cpp: the 5.366^2 tank starts EMPTY except for the small
emitter box (LL=8dx x LH=0.125) in the left wall at height 1; the
emitter's particles are forced to v=(2,0), rho=rho0, p=p(rho0) every
acoustic half step (EmitterInflowCondition, filling_tank.cpp:55-66,
fluid_boundary.cpp:50-59) and recycled through the inlet with a clone
activated per crossing (EmitterInflowInjection -> physics/boundary.py).
The jet falls under gravity, pools, and fills the tank to t=30;
WaterBody_TotalMechanicalEnergy is the DTW regression quantity.

Deviation: the reference tags the emitter as a fixed particle SET
(BodyPartByParticle); here the condition applies to alive particles
currently inside the emitter box — the same particles, since emitter
particles wrap back into the box on crossing and everything else has
left it.
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
from sphinxsys_jax.core.materials import WeaklyCompressibleFluid
from sphinxsys_jax.core.state import FAR_AWAY, State, make_fluid_state, make_solid_state
from sphinxsys_jax.neighbors import (build_cell_table, build_neighbor_list,
                                     grid_from_bounds)
from sphinxsys_jax.physics import boundary as bd
from sphinxsys_jax.physics import fluid as fd
from sphinxsys_jax.physics import general as gd
from sphinxsys_jax.physics import riemann as rs

DL = 5.366
DH = 5.366
DX = 0.025
BW = 4 * DX
LL = 2.0 * BW            # inlet length (x)
LH = 0.125               # inlet height (y)
INLET_HEIGHT = 1.0
RHO0_F = 1.0
GRAVITY_G = 1.0
U_JET = 2.0
U_F = 2.0 * math.sqrt(GRAVITY_G * (INLET_HEIGHT + LH))
C_F = 10.0 * U_F
RESERVE = 350.0          # ParticleBuffer<ReserveSizeFactor>(350)


class SimState(NamedTuple):
    fluid: Any
    nl_inner: Any
    nl_wall: Any
    time: jnp.ndarray
    n_adv: jnp.ndarray
    overflow: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class FillingTankCase:
    dx: float
    adaptation: SPHAdaptation
    grid: Any
    eos: WeaklyCompressibleFluid
    riemann: Any
    gravity: gd.Gravity
    wall: State
    wall_table: Any
    emitter: bd.AlignedBoxRegion
    n_seed: int
    cell_cap: int
    k_inner: int
    k_wall: int

    @property
    def kernel(self):
        return self.adaptation.kernel


def build_case(dx: float = DX, dtype=jnp.float32, cell_cap: int = 24,
               k_inner: int = 48, k_wall: int = 32):
    adaptation = SPHAdaptation(spacing=dx, dim=2)
    bw = 4 * dx

    # emitter box: x in [-BW, -BW+LL], y in [INLET_HEIGHT, +LH]
    # (inlet_translation/halfsize, filling_tank.cpp:11-13)
    emitter = bd.AlignedBoxRegion(lower=(-bw, INLET_HEIGHT),
                                  upper=(-bw + LL, INLET_HEIGHT + LH), axis=0)

    # seed particles fill the emitter box only
    xs = np.arange(-bw + dx / 2, -bw + LL, dx)
    ys = np.arange(INLET_HEIGHT + dx / 2, INLET_HEIGHT + LH, dx)
    pos_seed = np.stack(np.meshgrid(xs, ys, indexing="ij"), -1).reshape(-1, 2)
    n_seed = len(pos_seed)
    cap = int(n_seed * RESERVE)
    pos_full = np.full((cap, 2), float(FAR_AWAY))
    pos_full[:n_seed] = pos_seed
    fluid = dict(make_fluid_state(pos_full, dx * dx, RHO0_F, dtype=dtype))
    fluid["Alive"] = jnp.arange(cap) < n_seed
    fluid["NReal"] = jnp.asarray(cap, jnp.int32)
    fluid["Velocity"] = fluid["Velocity"].at[:, 0].set(U_JET)

    # wall = frame minus tank interior minus the inlet notch
    outer = G.Box(G.Transform(translation=(DL / 2, DH / 2)),
                  halfsize=(DL / 2 + bw, DH / 2 + bw))
    inner = G.Box(G.Transform(translation=(DL / 2, DH / 2)),
                  halfsize=(DL / 2, DH / 2))
    notch = G.Box(G.Transform(translation=(-bw + LL / 2,
                                           INLET_HEIGHT + LH / 2)),
                  halfsize=(LL / 2, LH / 2))
    wall_shape = G.make_complex(("add", outer), ("sub", inner),
                                ("sub", notch))
    pos_w, _ = generate_lattice(wall_shape, (-bw - dx, -bw - dx),
                                (DL + bw + dx, DH + bw + dx), dx)
    wall = dict(make_solid_state(pos_w, dx * dx, RHO0_F, dtype=dtype))
    wall = gd.normal_direction_from_shape(wall, wall_shape)

    grid = grid_from_bounds((-bw - 2 * dx, -bw - 2 * dx),
                            (DL + bw + 2 * dx, DH + bw + 2 * dx),
                            adaptation.cutoff)
    wall_table = jax.jit(partial(build_cell_table, grid=grid, cap=cell_cap))(
        wall["Position"], wall["NReal"])

    eos = WeaklyCompressibleFluid(rho0=RHO0_F, c0=C_F)
    gravity = gd.Gravity(acceleration=(0.0, -GRAVITY_G))
    fluid = gd.gravity_force(fluid, gravity)

    case = FillingTankCase(dx=dx, adaptation=adaptation, grid=grid, eos=eos,
                           riemann=rs.acoustic_riemann(eos), gravity=gravity,
                           wall=wall, wall_table=wall_table, emitter=emitter,
                           n_seed=n_seed, cell_cap=cell_cap, k_inner=k_inner,
                           k_wall=k_wall)
    return case, fluid


def rebuild_relations(case: FillingTankCase, fluid: State):
    alive = fluid["Alive"]
    pos = fluid["Position"]
    cutoff = case.adaptation.cutoff
    table = build_cell_table(pos, alive, case.grid, cap=case.cell_cap)
    nl_inner = build_neighbor_list(pos, alive, pos, alive, table, case.grid,
                                   cutoff, k_max=case.k_inner,
                                   include_self=False)
    nl_wall = build_neighbor_list(pos, alive, case.wall["Position"],
                                  case.wall["NReal"], case.wall_table,
                                  case.grid, cutoff, k_max=case.k_wall,
                                  include_self=True)
    return nl_inner, nl_wall


def init_sim(case: FillingTankCase, fluid: State) -> SimState:
    nl_inner, nl_wall = jax.jit(partial(rebuild_relations, case))(fluid)
    return SimState(fluid=fluid, nl_inner=nl_inner, nl_wall=nl_wall,
                    time=jnp.zeros((), fluid["Position"].dtype),
                    n_adv=jnp.zeros((), jnp.int32),
                    overflow=jnp.zeros((), bool))


def _inflow_condition(case: FillingTankCase, fluid: State) -> State:
    """EmitterInflowCondition (fluid_boundary.cpp:50-59): force velocity,
    density and pressure on the emitter-box particles."""
    out = dict(fluid)
    in_box = fluid["Alive"] & case.emitter.contains(fluid["Position"])
    vel = jnp.where(in_box[:, None],
                    jnp.asarray([U_JET, 0.0], fluid["Velocity"].dtype),
                    fluid["Velocity"])
    out["Velocity"] = vel
    out["Density"] = jnp.where(in_box, RHO0_F, fluid["Density"])
    out["Pressure"] = jnp.where(in_box, case.eos.pressure(
        jnp.asarray(RHO0_F, fluid["Pressure"].dtype)), fluid["Pressure"])
    return out


def _advection_step(case: FillingTankCase, s: SimState) -> SimState:
    kernel, dim = case.kernel, 2
    h = case.adaptation.h
    fluid = s.fluid
    pos_prev = fluid["Position"]

    dt_adv = fd.advection_time_step(fluid, h, U_F)
    fluid = fd.density_summation(
        fluid, s.nl_inner, kernel, dim, RHO0_F, case.adaptation.sigma0,
        contacts=[(case.wall, s.nl_wall, RHO0_F)], free_surface=True)

    def ac_body(carry):
        f, rt = carry
        dt = jnp.minimum(fd.acoustic_time_step(f, case.eos, h), dt_adv)
        f = fd.acoustic_step_1st_half(f, s.nl_inner, kernel, dim, case.eos,
                                      case.riemann, dt, wall=case.wall,
                                      nl_wall=s.nl_wall)
        f = _inflow_condition(case, f)
        f = fd.acoustic_step_2nd_half(f, s.nl_inner, kernel, dim,
                                      case.riemann, dt, wall=case.wall,
                                      nl_wall=s.nl_wall)
        f = _inflow_condition(case, f)
        return (f, rt + dt)

    fluid, relax_t = jax.lax.while_loop(
        lambda c: c[1] < dt_adv, ac_body, (fluid, jnp.zeros_like(dt_adv)))

    fluid = bd.emitter_inflow_injection(fluid, case.emitter,
                                        prev_pos=pos_prev)
    inj_ovf = fluid.pop("_InjectionOverflow", jnp.zeros((), bool))

    nl_inner, nl_wall = rebuild_relations(case, fluid)
    return SimState(fluid=fluid, nl_inner=nl_inner, nl_wall=nl_wall,
                    time=s.time + relax_t, n_adv=s.n_adv + 1,
                    overflow=s.overflow | nl_inner.overflow
                    | nl_wall.overflow | inj_ovf)


def make_run_chunk(case: FillingTankCase):
    @jax.jit
    def run_chunk(s: SimState, t_target) -> SimState:
        return jax.lax.while_loop(lambda st: st.time < t_target,
                                  lambda st: _advection_step(case, st), s)

    return run_chunk


def n_alive(s: SimState) -> int:
    return int(jnp.sum(s.fluid["Alive"]))


def mechanical_energy(case: FillingTankCase, s: SimState) -> float:
    return float(gd.total_mechanical_energy(s.fluid, case.gravity))
