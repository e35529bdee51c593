"""3D elastic ball bouncing inside a rigid cylindrical shell.

Counterpart of /root/reference/tests/3d_examples/
test_3d_elasticSolid_shell_collision/3d_elasticSolid_shell_collision.cpp:
a NeoHookean ball (E=2e4, nu=0.45) falls under gravity inside a 215-degree
cylindrical shell of SURFACE particles (radius 2, thickness = dx) and
bounces via the shell contact formulation: ShellContactFactor (offset +
Gauss-calibrated penetration measure) -> ContactForceFromWall ->
PairwiseFrictionFromWall.

The shell is rigid (Solid matter in the reference): only the ball
integrates; contact topology is rebuilt every acoustic step inside the
jitted loop against the static shell cell table.
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
from sphinxsys_jax.core.materials import NeoHookeanSolid
from sphinxsys_jax.core.state import State, make_solid_state
from sphinxsys_jax.neighbors import grid_from_bounds, build_cell_table, build_neighbor_list
from sphinxsys_jax.physics import contact as ct
from sphinxsys_jax.physics import general as gd
from sphinxsys_jax.physics import solid as sd

RADIUS = 2.0          # cylinder inner radius
HALF_HEIGHT = 1.0     # cylinder half height (y)
BALL_RADIUS = 0.5
GRAVITY_G = 1.0
RHO0 = 1.0e3
YOUNGS = 2.0e4
POISSON = 0.45
PHYSICAL_VISCOSITY = 1.0e6
ARC_DEG = 215.0       # shell arc


class SimState(NamedTuple):
    ball: Any
    nl_contact: Any
    time: jnp.ndarray
    n_steps: jnp.ndarray
    overflow: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class BallShellCase:
    dx: float
    adaptation: SPHAdaptation
    grid: Any
    material: NeoHookeanSolid
    shell: State
    shell_table: Any
    rp: sd.ReferencePairs
    n_ball: int
    cell_cap: int
    k_contact: int

    @property
    def kernel(self):
        return self.adaptation.kernel


def make_cylinder_shell(dx: float, dtype=jnp.float32) -> State:
    """Parametric mid-surface points of the 215-degree cylinder, axis
    along y, opening at the top (3d_elasticSolid_shell_collision.cpp
    ParticleGenerator<SurfaceParticles, Cylinder>)."""
    thickness = dx
    r_mid = RADIUS + thickness / 2.0
    n_arc = int(2.0 * r_mid * math.pi * ARC_DEG / 360.0 / dx)
    n_h = 2 * int(HALF_HEIGHT / dx)
    pos = []
    normals = []
    for i in range(n_arc + 2):
        phi = (162.5 / 180.0 * math.pi
               + (i - 1 + 0.5) * ARC_DEG / 360.0 * 2.0 * math.pi / n_arc)
        for j in range(n_h):
            x = r_mid * math.cos(phi)
            z = r_mid * math.sin(phi)
            y = (j - n_h / 2) * dx + dx * 0.5
            pos.append((x, y, z))
            normals.append((x / r_mid, 0.0, z / r_mid))
    pos = np.asarray(pos)
    shell = dict(make_solid_state(pos, dx * dx, RHO0, dtype=dtype))
    shell["NormalDirection"] = jnp.asarray(np.asarray(normals), dtype)
    return shell


def build_case(dx: float = 0.05, dtype=jnp.float32, cell_cap: int = 24,
               k_inner: int = 96, k_contact: int = 64):
    adaptation = SPHAdaptation(spacing=dx, dim=3)
    material = NeoHookeanSolid(rho0=RHO0, youngs_modulus=YOUNGS,
                               poisson_ratio=POISSON)

    ball_center = (RADIUS / 2.0, 0.0, 0.0)
    ball_shape = G.Ball(center=ball_center, radius=BALL_RADIUS)
    lo = (-RADIUS - 4 * dx, -HALF_HEIGHT - 4 * dx, -RADIUS - 4 * dx)
    hi = (RADIUS + 4 * dx, HALF_HEIGHT + 4 * dx, RADIUS + 4 * dx)
    pos_b, vol = generate_lattice(ball_shape, lo, hi, dx)

    ball = dict(sd.make_elastic_solid_state(pos_b, vol, material, dtype=dtype))
    n = len(pos_b)
    ball.update({
        "RepulsionForce": jnp.zeros((n, 3), dtype),
        "PreviousRepulsionForce": jnp.zeros((n, 3), dtype),
    })
    ball = gd.gravity_force(ball, gd.Gravity(acceleration=(0.0, 0.0, -GRAVITY_G)))

    shell = make_cylinder_shell(dx, dtype)

    grid = grid_from_bounds(lo, hi, adaptation.cutoff)
    shell_table = jax.jit(partial(build_cell_table, grid=grid, cap=cell_cap))(
        shell["Position"], shell["NReal"])

    # frozen total-Lagrangian inner topology + B correction for the ball
    ball_table = jax.jit(partial(build_cell_table, grid=grid, cap=cell_cap))(
        ball["Position"], ball["NReal"])
    nl_inner = jax.jit(partial(
        build_neighbor_list, grid=grid, cutoff=adaptation.cutoff,
        k_max=k_inner, include_self=False))(
        ball["Position"], ball["NReal"], ball["Position"], ball["NReal"],
        ball_table)
    rp = sd.freeze_reference_pairs(ball["Position"], nl_inner,
                                   adaptation.kernel, 3)
    B = sd.linear_gradient_correction_matrix(rp, ball["VolumetricMeasure"])
    ball["LinearGradientCorrectionMatrix"] = B

    case = BallShellCase(dx=dx, adaptation=adaptation, grid=grid,
                         material=material, shell=shell,
                         shell_table=shell_table, rp=rp, n_ball=n,
                         cell_cap=cell_cap, k_contact=k_contact)
    return case, ball


def init_sim(case: BallShellCase, ball: State) -> SimState:
    nl = jax.jit(partial(
        build_neighbor_list, grid=case.grid, cutoff=case.adaptation.cutoff,
        k_max=case.k_contact, include_self=True))(
        ball["Position"], ball["NReal"], case.shell["Position"],
        case.shell["NReal"], case.shell_table)
    dtype = ball["Position"].dtype
    return SimState(ball=ball, nl_contact=nl, time=jnp.zeros((), dtype),
                    n_steps=jnp.zeros((), jnp.int32), overflow=nl.overflow)


def _step(case: BallShellCase, s: SimState) -> SimState:
    kernel, dim = case.kernel, 3
    h = case.adaptation.h
    ball = s.ball

    nl = build_neighbor_list(ball["Position"], ball["NReal"],
                             case.shell["Position"], case.shell["NReal"],
                             case.shell_table, case.grid,
                             case.adaptation.cutoff, k_max=case.k_contact,
                             include_self=True)
    factor = ct.shell_contact_factor(ball, case.shell, nl, kernel, dim,
                                     case.dx)
    stiffness = ct.contact_stiffness(case.material)
    ball = ct.repulsion_force_wall(ball, case.shell, nl, kernel, dim,
                                   factor, stiffness)

    dt = sd.solid_acoustic_time_step(ball, case.material.sound_speed, h,
                                     cfl=0.45)
    ball = ct.pairwise_friction_from_wall(ball, case.shell, nl, kernel, dim,
                                          PHYSICAL_VISCOSITY, dt)
    ball = sd.integration_1st_half_pk2(ball, case.rp, case.material, dt, h,
                                       kernel.w0(dim))
    ball = sd.integration_2nd_half(ball, case.rp, dt)

    return SimState(ball=ball, nl_contact=nl, time=s.time + dt,
                    n_steps=s.n_steps + 1, overflow=s.overflow | nl.overflow)


def make_run_chunk(case: BallShellCase):
    @jax.jit
    def run_chunk(s: SimState, t_target) -> SimState:
        return jax.lax.while_loop(lambda st: st.time < t_target,
                                  lambda st: _step(case, st), s)

    return run_chunk


def ball_center_z(s: SimState) -> float:
    return float(jnp.mean(s.ball["Position"][:, 2]))


def max_radial_extent(s: SimState) -> float:
    """max over ball particles of sqrt(x^2+z^2) — penetration monitor."""
    p = s.ball["Position"]
    return float(jnp.max(jnp.sqrt(p[:, 0] ** 2 + p[:, 2] ** 2)))
