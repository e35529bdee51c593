"""Two soft balls bouncing inside a rigid box — one free, one internally
damped.

Counterpart of /root/reference/tests/2d_examples/test_2d_collision/
collision.cpp: two NeoHookean balls (r=0.5, E=5e4, nu=0.45) fall under
gravity g=1 inside an 8x4 box; the FreeBall keeps bouncing near-elastically
while the DampingBall (DampingWithRandomChoice eta=1e4 pairwise internal
damping, collision.cpp:202-203) sheds its kinetic energy and settles on the
floor.  Contact is the same frictionless penalty stack as sliding_2d
(ContactFactorSummation + ContactForceFromWall).

The balls never meet (centers x=2 and x=6, purely vertical motion), so each
integrates independently against the shared wall — exactly as the
reference's update loop does (collision.cpp:263-277).

The wall frame is generated at its BW=4*dx reference thickness; the
reference's optional level-set particle relaxation of the balls is off by
default (collision.cpp:86-88) and is off here.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from sphinxsys_jax.core import geometry as G
from sphinxsys_jax.core.adaptation import SPHAdaptation
from sphinxsys_jax.core.generators import generate_lattice
from sphinxsys_jax.core.materials import NeoHookeanSolid
from sphinxsys_jax.core.state import State, make_solid_state
from sphinxsys_jax.neighbors import (build_cell_table, build_neighbor_list,
                                     grid_from_bounds)
from sphinxsys_jax.physics import contact as ct
from sphinxsys_jax.physics import dissipation as dp
from sphinxsys_jax.physics import general as gd
from sphinxsys_jax.physics import solid as sd

DL, DH = 8.0, 4.0
BALL_R = 0.5
BALL_CENTER_1 = (2.0, 2.0)   # FreeBall
BALL_CENTER_2 = (6.0, 2.0)   # DampingBall
GRAVITY_G = 1.0
RHO0 = 1.0e3
YOUNGS = 5.0e4
POISSON = 0.45
PHYSICAL_VISCOSITY = 1.0e4


class SimState(NamedTuple):
    free_ball: Any
    damping_ball: Any
    time: jnp.ndarray
    n_steps: jnp.ndarray
    overflow: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class CollisionCase:
    dx: float
    adaptation: SPHAdaptation
    grid: Any
    material: NeoHookeanSolid
    wall: State
    wall_table: Any
    rp_free: sd.ReferencePairs
    rp_damp: sd.ReferencePairs
    nl_damp_inner: Any
    k_contact: int

    @property
    def kernel(self):
        return self.adaptation.kernel


def _make_ball(center, dx, material, adaptation, grid, cell_cap, k_inner,
               dtype):
    shape = G.Ball(center=center, radius=BALL_R)
    lo = (center[0] - BALL_R - 2 * dx, center[1] - BALL_R - 2 * dx)
    hi = (center[0] + BALL_R + 2 * dx, center[1] + BALL_R + 2 * dx)
    pos, vol = generate_lattice(shape, lo, hi, dx)
    ball = dict(sd.make_elastic_solid_state(pos, vol, material, dtype=dtype))
    n = len(pos)
    ball.update({
        "RepulsionForce": jnp.zeros((n, 2), dtype),
        "PreviousRepulsionForce": jnp.zeros((n, 2), dtype),
    })
    ball = gd.gravity_force(ball, gd.Gravity(acceleration=(0.0, -GRAVITY_G)))
    table = jax.jit(partial(build_cell_table, grid=grid, cap=cell_cap))(
        ball["Position"], ball["NReal"])
    nl = jax.jit(partial(
        build_neighbor_list, grid=grid, cutoff=adaptation.cutoff,
        k_max=k_inner, include_self=False))(
        ball["Position"], ball["NReal"], ball["Position"], ball["NReal"],
        table)
    rp = sd.freeze_reference_pairs(ball["Position"], nl, adaptation.kernel, 2)
    ball["LinearGradientCorrectionMatrix"] = sd.linear_gradient_correction_matrix(
        rp, ball["VolumetricMeasure"])
    return ball, rp, nl


def build_case(dx: float = 0.025, dtype=jnp.float32, cell_cap: int = 16,
               k_inner: int = 32, k_contact: int = 24):
    adaptation = SPHAdaptation(spacing=dx, dim=2)
    material = NeoHookeanSolid(rho0=RHO0, youngs_modulus=YOUNGS,
                               poisson_ratio=POISSON)
    bw = 4 * dx

    box_outer = G.Box(transform=G.Transform(translation=(DL / 2, DH / 2)),
                      halfsize=(DL / 2 + bw, DH / 2 + bw))
    box_inner = G.Box(transform=G.Transform(translation=(DL / 2, DH / 2)),
                      halfsize=(DL / 2, DH / 2))
    frame = G.make_complex(("add", box_outer), ("sub", box_inner))
    wall_pos, wall_vol = generate_lattice(frame, (-bw - dx, -bw - dx),
                                          (DL + bw + dx, DH + bw + dx), dx)
    wall = dict(make_solid_state(wall_pos, wall_vol, RHO0, dtype=dtype))

    lo = (-bw - 4 * dx, -bw - 4 * dx)
    hi = (DL + bw + 4 * dx, DH + bw + 4 * dx)
    grid = grid_from_bounds(lo, hi, adaptation.cutoff)
    wall_table = jax.jit(partial(build_cell_table, grid=grid, cap=cell_cap))(
        wall["Position"], wall["NReal"])

    free_ball, rp_free, _ = _make_ball(BALL_CENTER_1, dx, material,
                                       adaptation, grid, cell_cap, k_inner,
                                       dtype)
    damping_ball, rp_damp, nl_damp = _make_ball(BALL_CENTER_2, dx, material,
                                                adaptation, grid, cell_cap,
                                                k_inner, dtype)

    case = CollisionCase(dx=dx, adaptation=adaptation, grid=grid,
                         material=material, wall=wall, wall_table=wall_table,
                         rp_free=rp_free, rp_damp=rp_damp,
                         nl_damp_inner=nl_damp, k_contact=k_contact)
    return case, (free_ball, damping_ball)


def init_sim(case: CollisionCase, balls) -> SimState:
    free_ball, damping_ball = balls
    dtype = free_ball["Position"].dtype
    return SimState(free_ball=free_ball, damping_ball=damping_ball,
                    time=jnp.zeros((), dtype),
                    n_steps=jnp.zeros((), jnp.int32),
                    overflow=jnp.zeros((), bool))


def _ball_substep(case, ball, rp, dt):
    kernel, dim = case.kernel, 2
    nl = build_neighbor_list(ball["Position"], ball["NReal"],
                             case.wall["Position"], case.wall["NReal"],
                             case.wall_table, case.grid,
                             case.adaptation.cutoff, k_max=case.k_contact,
                             include_self=True)
    factor = ct.repulsion_factor_contact(ball, case.wall, nl, kernel, dim)
    ball = ct.repulsion_force_wall(ball, case.wall, nl, kernel, dim, factor,
                                   ct.contact_stiffness(case.material))
    ball = sd.integration_1st_half_pk2(ball, rp, case.material, dt,
                                       case.adaptation.h, kernel.w0(dim))
    return ball, nl.overflow


def _step(case: CollisionCase, s: SimState) -> SimState:
    h = case.adaptation.h
    dt = jnp.minimum(
        sd.solid_acoustic_time_step(s.free_ball, case.material.sound_speed,
                                    h, cfl=0.45),
        sd.solid_acoustic_time_step(s.damping_ball,
                                    case.material.sound_speed, h, cfl=0.45))

    free_ball, ovf1 = _ball_substep(case, s.free_ball, case.rp_free, dt)
    free_ball = sd.integration_2nd_half(free_ball, case.rp_free, dt)

    damping_ball, ovf2 = _ball_substep(case, s.damping_ball, case.rp_damp, dt)
    damping_ball = dp.damping_pairwise(damping_ball, "Velocity",
                                       case.nl_damp_inner, case.kernel, 2,
                                       PHYSICAL_VISCOSITY, dt)
    damping_ball = sd.integration_2nd_half(damping_ball, case.rp_damp, dt)

    return SimState(free_ball=free_ball, damping_ball=damping_ball,
                    time=s.time + dt, n_steps=s.n_steps + 1,
                    overflow=s.overflow | ovf1 | ovf2)


def make_run_chunk(case: CollisionCase):
    @jax.jit
    def run_chunk(s: SimState, t_target) -> SimState:
        return jax.lax.while_loop(lambda st: st.time < t_target,
                                  lambda st: _step(case, st), s)

    return run_chunk


def ball_center(ball: State) -> np.ndarray:
    return np.asarray(jnp.mean(ball["Position"], axis=0))
