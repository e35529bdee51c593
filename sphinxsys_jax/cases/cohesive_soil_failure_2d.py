"""2D cohesive soil failure (Drucker-Prager with cohesion).

Counterpart of /root/reference/tests/2d_examples/
test_2d_cohesive_soil_failure/cohesive_soil_failure.{h,cpp}: a 4 x 2 m
soil column (rho=1850, E=1.8e6, nu=0.3, friction 25 deg, cohesion 5 kPa)
in a 5 x 2.5 m tank slumps under gravity and ARRESTS with most of the
column standing — cohesion holds what a cohesionless pile of the same
friction angle would spread along the floor.  The reference's
GranularBody_TotalMechanicalEnergy DB (16 runs) starts at the exact
initial potential energy 145040 J and settles at 129850-129920 J
(E/E0 ~ 0.896).

Op set per the reference (cpp:44-65): K0-type initial stress state
(SoilInitialCondition, .h:66-83: sigma_yy = -rho g y with lateral
coefficient 1 - sin(phi) — mirrored verbatim, including its use of the
height rather than the depth, since the stress state relaxes in the
first acoustic steps anyway), free-surface density summation,
all-particles transport-velocity correction (the cohesive column sees
tension, which plain WCSPH particle distributions can't carry), stress
diffusion, and plastic stress/density relaxation with wall Riemann
contacts.
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
from sphinxsys_jax.core.state import State, make_solid_state
from sphinxsys_jax.neighbors import (build_cell_table, build_neighbor_list,
                                     grid_from_bounds)
from sphinxsys_jax.physics import continuum as cm
from sphinxsys_jax.physics import fluid as fd
from sphinxsys_jax.physics import general as gd
from sphinxsys_jax.physics import riemann as rs

DL, DH = 5.0, 2.5
LL, LH = 4.0, 2.0
RHO0_S = 1850.0
GRAVITY_G = 9.8
YOUNGS = 1.8e6
POISSON = 0.3
C_S = math.sqrt(YOUNGS / (RHO0_S * 3.0 * (1.0 - 2.0 * POISSON)))
FRICTION = 25.0 * math.pi / 180.0
COHESION = 5.0e3
U_REF = math.sqrt(2.0 * GRAVITY_G * LH)


class SimState(NamedTuple):
    soil: Any
    nl_inner: Any
    nl_wall: Any
    time: jnp.ndarray
    n_adv: jnp.ndarray
    n_ac: jnp.ndarray
    overflow: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class CohesiveCase:
    dx: float
    adaptation: SPHAdaptation
    grid: Any
    material: cm.PlasticContinuum
    riemann: rs.AcousticRiemannSolver
    gravity: gd.Gravity
    wall: State
    wall_table: Any
    n_soil: int
    cell_cap: int
    k_inner: int
    k_wall: int

    @property
    def kernel(self):
        return self.adaptation.kernel


def build_case(dx: float | None = None, dtype=jnp.float32, cell_cap: int = 24,
               k_inner: int = 64, k_wall: int = 40):
    dx = dx or LL / 50.0
    bw = 4 * dx
    adaptation = SPHAdaptation(spacing=dx, dim=2)

    column = G.Box(G.Transform(translation=(LL / 2, LH / 2)),
                   halfsize=(LL / 2, LH / 2))
    outer = G.Box(G.Transform(translation=(DL / 2, DH / 2)),
                  halfsize=(DL / 2 + bw, DH / 2 + bw))
    inner = G.Box(G.Transform(translation=(DL / 2, DH / 2)),
                  halfsize=(DL / 2, DH / 2))
    wall_shape = G.make_complex(("add", outer), ("sub", inner))

    dom_lo, dom_hi = (-bw, -bw), (DL + bw, DH + bw)
    pos_s, vol = generate_lattice(column, dom_lo, dom_hi, dx)
    pos_w, _ = generate_lattice(wall_shape, dom_lo, dom_hi, dx)

    material = cm.PlasticContinuum(rho0=RHO0_S, c0=C_S, youngs_modulus=YOUNGS,
                                   poisson_ratio=POISSON,
                                   friction_angle=FRICTION, cohesion=COHESION)
    soil = dict(cm.make_continuum_state(pos_s, vol, material, dtype=dtype))
    soil["DensitySummation"] = soil["Density"]
    n = len(pos_s)
    soil["Indicator"] = jnp.zeros((n,), jnp.int32)
    soil["PreviousSurfaceIndicator"] = jnp.ones((n,), jnp.int32)
    soil["PositionDivergence"] = jnp.zeros((n,), dtype)
    # SoilInitialCondition (.h:66-83)
    y = jnp.asarray(pos_s[:, 1], dtype)
    gama = 1.0 - math.sin(FRICTION)
    syy = -RHO0_S * GRAVITY_G * y
    st = soil["StressTensor3D"]
    st = st.at[:, 1, 1].set(syy)
    st = st.at[:, 0, 0].set(syy * gama)
    st = st.at[:, 2, 2].set(syy * gama)
    soil["StressTensor3D"] = st
    gravity = gd.Gravity(acceleration=(0.0, -GRAVITY_G))
    soil = gd.gravity_force(soil, gravity)

    wall = make_solid_state(pos_w, vol, RHO0_S, dtype=dtype)
    wall = gd.normal_direction_from_shape(wall, wall_shape)

    grid = grid_from_bounds(dom_lo, dom_hi, adaptation.cutoff)
    wall_table = jax.jit(partial(build_cell_table, grid=grid, cap=cell_cap))(
        wall["Position"], wall["NReal"])

    case = CohesiveCase(dx=dx, adaptation=adaptation, grid=grid,
                        material=material,
                        riemann=rs.acoustic_riemann(material),
                        gravity=gravity, wall=wall, wall_table=wall_table,
                        n_soil=n, cell_cap=cell_cap, k_inner=k_inner,
                        k_wall=k_wall)
    return case, soil


def rebuild_relations(case: CohesiveCase, soil: State):
    pos = soil["Position"]
    n = soil["NReal"]
    cutoff = case.adaptation.cutoff
    table = build_cell_table(pos, n, case.grid, cap=case.cell_cap)
    nl_inner = build_neighbor_list(pos, n, pos, n, table, case.grid, cutoff,
                                   k_max=case.k_inner, include_self=False)
    nl_wall = build_neighbor_list(pos, n, case.wall["Position"],
                                  case.wall["NReal"], case.wall_table,
                                  case.grid, cutoff, k_max=case.k_wall,
                                  include_self=True)
    return nl_inner, nl_wall


def init_sim(case: CohesiveCase, soil: State) -> SimState:
    nl_inner, nl_wall = jax.jit(partial(rebuild_relations, case))(soil)
    dtype = soil["Position"].dtype
    z = jnp.zeros((), jnp.int32)
    return SimState(soil=soil, nl_inner=nl_inner, nl_wall=nl_wall,
                    time=jnp.zeros((), dtype), n_adv=z, n_ac=z,
                    overflow=jnp.zeros((), bool))


def _advection_step(case: CohesiveCase, s: SimState) -> SimState:
    kernel, dim = case.kernel, 2
    h = case.adaptation.h
    soil = s.soil

    dt_adv = fd.advection_time_step(soil, h, U_REF)
    soil = fd.density_summation(soil, s.nl_inner, kernel, dim, RHO0_S,
                                case.adaptation.sigma0,
                                contacts=[(case.wall, s.nl_wall, RHO0_S)],
                                free_surface=True)
    soil = fd.free_surface_indication(
        soil, s.nl_inner, kernel, dim,
        contacts=[(case.wall, s.nl_wall, RHO0_S)])
    # TransportVelocityCorrectionComplex<AllParticles> (cpp:53)
    soil = fd.transport_velocity_correction(
        soil, s.nl_inner, kernel, dim, h, limiter_slope=100.0,
        wall=case.wall, nl_wall=s.nl_wall, surface_projection=True)

    def ac_cond(carry):
        _, rt, _ = carry
        return rt < dt_adv

    def ac_body(carry):
        so, rt, k = carry
        dt = jnp.minimum(fd.acoustic_time_step(so, case.material, h, cfl=0.4),
                         dt_adv)
        so = cm.stress_diffusion(so, s.nl_inner, kernel, dim, case.material,
                                 h)
        so = cm.plastic_integration_1st_half(so, s.nl_inner, kernel, dim,
                                             case.material, case.riemann, dt,
                                             wall=case.wall, nl_wall=s.nl_wall)
        so = cm.plastic_integration_2nd_half(so, s.nl_inner, kernel, dim,
                                             case.material, case.riemann, dt,
                                             wall=case.wall, nl_wall=s.nl_wall)
        return (so, rt + dt, k + 1)

    soil, relax_t, n_ac = jax.lax.while_loop(
        ac_cond, ac_body,
        (soil, jnp.zeros_like(dt_adv), jnp.zeros((), jnp.int32)))

    nl_inner, nl_wall = rebuild_relations(case, soil)
    return SimState(soil=soil, nl_inner=nl_inner, nl_wall=nl_wall,
                    time=s.time + relax_t, n_adv=s.n_adv + 1,
                    n_ac=s.n_ac + n_ac,
                    overflow=s.overflow | nl_inner.overflow | nl_wall.overflow)


def make_run_chunk(case: CohesiveCase):
    @jax.jit
    def run_chunk(s: SimState, t_target) -> SimState:
        return jax.lax.while_loop(lambda st: st.time < t_target,
                                  lambda st: _advection_step(case, st), s)

    return run_chunk
