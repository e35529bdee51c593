"""Solid-to-shell tie coupling: NeoHookean cube resting on a clamped shell.

Counterpart of /root/reference/tests/3d_examples/test_3d_solid_to_shell_coupling/
test_3d_solid_to_shell_coupling.cpp (dp_1 CI configuration: res factors 1/1,
stiffness ratio 1, no relaxation): a 1x1x1 NeoHookean cube (E = 3 MPa,
nu = 0.45, mm units) sits on a 5 x 1 shell plate (thickness 0.2) clamped over
0.2 from both x-ends; gravity -10 y on the cube part above the shell
thickness.  Tie coupling per step (the reference main loop order):

    shell 1st half -> cube coupling force (ConservativeMapping of shell Force
    + BaseForcePrior) -> cube PK2 1st half + damping + 2nd half -> shell
    velocity ConsistentMapping (tied part) + clamp -> shell damping ->
    mapping + clamp again -> shell 2nd half.

The coupling contact pairs are FROZEN at the initial configuration (the
reference never updates the coupling contact relations).  Reference oracle:
center deflection -0.46 +- 10% at the semi-steady state (U_max < 5e-4,
t >= 5); the reference notes the value is a fully-solid-discretization
consistency check, not a converged benchmark.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from sphinxsys_jax.core.adaptation import SPHAdaptation
from sphinxsys_jax.core.materials import NeoHookeanSolid
from sphinxsys_jax.neighbors import (build_cell_table, build_neighbor_list,
                                     grid_from_bounds)
from sphinxsys_jax.physics import dissipation as dp
from sphinxsys_jax.physics import shell as sh
from sphinxsys_jax.physics import solid as sd
from sphinxsys_jax.physics import solid_shell as ss

UNIT_MM = 1e-3
CUBE_L = 1.0
SHELL_T = 0.2
SHELL_L = 5.0
SHELL_W = CUBE_L
CONSTRAINT_L = 2.0 * CUBE_L / 10.0
RHO0 = 1000.0 * UNIT_MM ** 2          # 1e-3
YOUNGS = 3.0                           # 3 MPa
POISSON = 0.45
GRAVITY = -10.0

# beta/4 sqrt(rho E) L, beta = 0.4 (test_3d_solid_to_shell_coupling.cpp
# get_physical_viscosity_general)
PHYSICAL_VISCOSITY = 0.1 * math.sqrt(RHO0 * YOUNGS) * CUBE_L


class SimState(NamedTuple):
    cube: Any
    shell: Any
    time: jnp.ndarray
    n_steps: jnp.ndarray
    dt: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class CouplingCase:
    dx: float
    adaptation: SPHAdaptation
    material: NeoHookeanSolid
    rp_cube: sd.ReferencePairs
    nl_cube: Any
    rp_shell: sd.ReferencePairs
    nl_shell: Any
    cp_shell: ss.CouplingPairs      # shell <- cube (TotalWeight, velocity)
    cp_cube: ss.CouplingPairs       # cube <- shell (force)
    shell_fixed: jnp.ndarray
    shell_tied_part: jnp.ndarray    # |x| < 0.5 cube_length
    grav_mask: jnp.ndarray          # cube y > shell thickness
    n_cube: int
    n_shell: int

    @property
    def kernel(self):
        return self.adaptation.kernel


def build_case(dx: float = CUBE_L / 10.0, dtype=jnp.float64):
    adaptation = SPHAdaptation(spacing=dx, dim=3)
    material = NeoHookeanSolid(rho0=RHO0, youngs_modulus=YOUNGS,
                               poisson_ratio=POISSON)

    # cube lattice: box x,z in (-L/2, L/2), y in (-dx/2, L + dx/2)
    ax = np.arange(-0.5 * CUBE_L + 0.5 * dx, 0.5 * CUBE_L, dx)
    ay = np.arange(0.0, CUBE_L + dx, dx)
    X, Y, Z = np.meshgrid(ax, ay, ax, indexing="ij")
    cube_pos = np.stack([X.ravel(), Y.ravel(), Z.ravel()], -1)

    # shell mid-surface at y = dx/2, normal +y
    sx = np.arange(-0.5 * SHELL_L + 0.5 * dx, 0.5 * SHELL_L, dx)
    sz = np.arange(-0.5 * SHELL_W + 0.5 * dx, 0.5 * SHELL_W, dx)
    SX, SZ = np.meshgrid(sx, sz, indexing="ij")
    shell_pos = np.stack([SX.ravel(), np.full(SX.size, 0.5 * dx),
                          SZ.ravel()], -1)
    shell_n = np.tile([0.0, 1.0, 0.0], (len(shell_pos), 1))

    cube = sd.make_elastic_solid_state(cube_pos, dx ** 3, material,
                                       dtype=dtype)
    shell = sh.make_shell_state(shell_pos, shell_n, dx, SHELL_T, material,
                                dtype=dtype)

    cutoff = adaptation.cutoff
    grid = grid_from_bounds((-0.5 * SHELL_L - 0.3, -0.3, -0.6),
                            (0.5 * SHELL_L + 0.3, CUBE_L + 0.3, 0.6), cutoff)
    n_c, n_s = len(cube_pos), len(shell_pos)
    tc = build_cell_table(cube["Position"], jnp.int32(n_c), grid, cap=36)
    ts = build_cell_table(shell["Position"], jnp.int32(n_s), grid, cap=36)

    # inner relations (frozen total-Lagrangian reference pairs)
    nl_cc = build_neighbor_list(cube["Position"], jnp.int32(n_c),
                                cube["Position"], jnp.int32(n_c), tc, grid,
                                cutoff, k_max=96, include_self=False)
    assert not bool(nl_cc.overflow)
    rp_cube = sd.freeze_reference_pairs(cube["Position"], nl_cc,
                                        adaptation.kernel, 3)
    cube["LinearGradientCorrectionMatrix"] = \
        sd.linear_gradient_correction_matrix(rp_cube,
                                             cube["VolumetricMeasure"])
    nl_ss = build_neighbor_list(shell["Position"], jnp.int32(n_s),
                                shell["Position"], jnp.int32(n_s), ts, grid,
                                cutoff, k_max=32, include_self=False)
    assert not bool(nl_ss.overflow)
    rp_shell = sd.freeze_reference_pairs(shell["Position"], nl_ss,
                                         sh.ReducedKernel(adaptation.kernel),
                                         3)
    shell = sh.shell_correct_configuration(shell, rp_shell)

    # frozen tie-coupling pairs at max-h cutoff (equal h here)
    nl_sc = build_neighbor_list(shell["Position"], jnp.int32(n_s),
                                cube["Position"], jnp.int32(n_c), tc, grid,
                                cutoff, k_max=64, include_self=False)
    nl_cs = build_neighbor_list(cube["Position"], jnp.int32(n_c),
                                shell["Position"], jnp.int32(n_s), ts, grid,
                                cutoff, k_max=32, include_self=False)
    assert not bool(nl_sc.overflow) and not bool(nl_cs.overflow)
    cp_shell = ss.freeze_coupling(shell["Position"], cube["Position"],
                                  cube["VolumetricMeasure"], nl_sc,
                                  adaptation.kernel, 3)
    cp_cube = ss.freeze_coupling(cube["Position"], shell["Position"],
                                 shell["VolumetricMeasure"], nl_cs,
                                 adaptation.kernel, 3)

    shell_fixed = jnp.asarray(
        (shell_pos[:, 0] < -0.5 * SHELL_L + CONSTRAINT_L)
        | (shell_pos[:, 0] > 0.5 * SHELL_L - CONSTRAINT_L))
    shell_tied = jnp.asarray((shell_pos[:, 0] > -0.5 * CUBE_L)
                             & (shell_pos[:, 0] < 0.5 * CUBE_L))
    grav_mask = jnp.asarray(cube_pos[:, 1] > SHELL_T)

    case = CouplingCase(dx=dx, adaptation=adaptation, material=material,
                        rp_cube=rp_cube, nl_cube=nl_cc, rp_shell=rp_shell,
                        nl_shell=nl_ss, cp_shell=cp_shell, cp_cube=cp_cube,
                        shell_fixed=shell_fixed, shell_tied_part=shell_tied,
                        grav_mask=grav_mask, n_cube=n_c, n_shell=n_s)
    sim = SimState(cube=cube, shell=shell,
                   time=jnp.zeros((), dtype),
                   n_steps=jnp.zeros((), jnp.int32),
                   dt=jnp.asarray(1e-5, dtype))
    return case, sim


def _clamp_shell(shell, mask):
    out = dict(shell)
    m = mask[:, None]
    out["Position"] = jnp.where(m, shell["InitialPosition"],
                                shell["Position"])
    out["Velocity"] = jnp.where(m, 0.0, shell["Velocity"])
    out["Rotation"] = jnp.where(m, 0.0, shell["Rotation"])
    out["AngularVelocity"] = jnp.where(m, 0.0, shell["AngularVelocity"])
    return out


def _step(case: CouplingCase, s: SimState) -> SimState:
    h = case.adaptation.h
    kernel = case.kernel
    dt = s.dt

    # 1. shell 1st half
    shell = sh.shell_stress_relaxation_1st_half(s.shell, case.rp_shell,
                                                case.material, dt, h)

    # 2. cube coupling force + gravity (BaseForcePrior net result)
    cube = dict(s.cube)
    f_cpl = ss.conservative_mapping(case.cp_cube, cube["VolumetricMeasure"],
                                    case.cp_shell.total_weight,
                                    shell["Force"])
    grav = jnp.where(case.grav_mask, cube["Mass"] * GRAVITY, 0.0)
    fp = f_cpl.at[:, 1].add(grav)
    cube["ForcePrior"] = fp

    # 3. cube PK2 integration + velocity damping
    cube = sd.integration_1st_half_pk2(cube, case.rp_cube, case.material,
                                       dt, h, kernel.w0(3))
    cube = dp.damping_pairwise(cube, "Velocity", case.nl_cube, kernel, 3,
                               PHYSICAL_VISCOSITY, dt)
    cube = sd.integration_2nd_half(cube, case.rp_cube, dt)

    # 4. shell kinematic tie + clamp + damping + tie + clamp + 2nd half
    shell["Velocity"] = ss.consistent_mapping(case.cp_shell,
                                              cube["Velocity"],
                                              shell["Velocity"],
                                              part_mask=case.shell_tied_part)
    shell = _clamp_shell(shell, case.shell_fixed)
    shell = dp.damping_pairwise(shell, "Velocity", case.nl_shell, kernel, 3,
                                PHYSICAL_VISCOSITY, dt)
    shell = dp.damping_pairwise(shell, "AngularVelocity", case.nl_shell,
                                kernel, 3, PHYSICAL_VISCOSITY, dt)
    shell["Velocity"] = ss.consistent_mapping(case.cp_shell,
                                              cube["Velocity"],
                                              shell["Velocity"],
                                              part_mask=case.shell_tied_part)
    shell = _clamp_shell(shell, case.shell_fixed)
    shell = sh.shell_stress_relaxation_2nd_half(shell, case.rp_shell, dt)

    dt_next = jnp.minimum(
        sd.solid_acoustic_time_step(cube, case.material.sound_speed, h),
        sh.shell_acoustic_time_step(shell, case.material, h))
    return SimState(cube=cube, shell=shell, time=s.time + dt,
                    n_steps=s.n_steps + 1, dt=dt_next)


def make_run_chunk(case: CouplingCase):
    @jax.jit
    def run_chunk(s: SimState, t_target) -> SimState:
        return jax.lax.while_loop(lambda st: st.time < t_target,
                                  lambda st: _step(case, st), s)

    return run_chunk


def center_deflection(case: CouplingCase, s: SimState) -> float:
    """y-displacement of the shell center (observer at (0, dx/2, 0))."""
    p0 = np.asarray(s.shell["InitialPosition"])
    dyv = np.asarray(s.shell["Position"][:, 1] - s.shell["InitialPosition"][:, 1])
    near = (np.abs(p0[:, 0]) < case.dx) & (np.abs(p0[:, 2]) < case.dx)
    return float(dyv[near].mean())


def u_max(s: SimState) -> float:
    return float(jnp.max(jnp.linalg.norm(s.cube["Velocity"], axis=-1)))
