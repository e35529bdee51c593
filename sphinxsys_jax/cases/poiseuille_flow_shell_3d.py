"""3D Poiseuille flow in a pipe bounded by a rigid SHELL wall.

Mirrors /root/reference/tests/3d_examples/test_3d_poiseuille_flow_shell/
poiseuille_flow_shell.cpp (the CI `10_particles` configuration): blood-like
fluid (rho 1050, mu 3.6e-3, Re = 100) driven through a D = 6.35 mm pipe of
length 10 R by a parabolic inflow, with the pipe wall a single layer of
shell particles at HALF the fluid resolution (resolution_shell = dx/2,
shell thickness = dx/4).  The fluid feels the shell as a wall through the
curvature-corrected dummy-particle contacts (physics/shell_fluid.py =
ContactRelationFromShellToFluid); the shell here is rigid and static, so
no structural stepping and no fluid->shell force is needed.

Oracle (cpp:375-399): at end_time = 2.0 the axial velocity at the radial
observation points (y = L/2) matches the analytic parabolic profile
v_y(r) = 2 U_f (1 - r^2/R^2) within 10% of U_max (the reference notes the
actual error is below 5% and keeps 10% for CI).
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
from sphinxsys_jax.core.materials import WeaklyCompressibleFluid
from sphinxsys_jax.core.state import make_fluid_state, make_solid_state
from sphinxsys_jax.io.observation import observe_quantity
from sphinxsys_jax.neighbors import (build_cell_table, build_neighbor_list,
                                     grid_from_bounds)
from sphinxsys_jax.physics import boundary as bd
from sphinxsys_jax.physics import fluid as fd
from sphinxsys_jax.physics import riemann as rs
from sphinxsys_jax.physics import shell as sh
from sphinxsys_jax.physics import shell_fluid as sf

SCALE = 0.001
DIAMETER = 6.35 * SCALE
R_FLUID = 0.5 * DIAMETER
FULL_LENGTH = 10.0 * R_FLUID

RHO0_F = 1050.0
MU_F = 3.6e-3
RE = 100.0
U_F = RE * MU_F / RHO0_F / DIAMETER          # mean velocity 0.054
U_MAX = 2.0 * U_F                            # parabolic peak
C_F = 10.0 * U_MAX


class PipeSim(NamedTuple):
    fluid: Any
    nl_ff: Any
    nl_fs: Any          # fluid -> shell contact
    time: jnp.ndarray
    n_adv: jnp.ndarray
    n_ac: jnp.ndarray
    overflow: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class PipeCase:
    dx: float
    res_shell: float
    adaptation: SPHAdaptation
    eos: WeaklyCompressibleFluid
    riemann: Any
    no_riemann: Any
    shell: Any                 # rigid shell state (static)
    shell_k1: Any              # principal curvatures (computed once)
    shell_k2: Any
    shell_table: Any
    grid: Any
    emitter: Any
    emitter_buffer: Any
    disposer: Any
    n_fluid: int               # capacity
    n_shell: int
    k_ff: int
    k_fs: int

    @property
    def kernel(self):
        return self.adaptation.kernel

    @property
    def bounds(self):
        m = 4.0 * self.dx + self.res_shell
        return ((-R_FLUID - m, -4.0 * self.dx - m, -R_FLUID - m),
                (R_FLUID + m, FULL_LENGTH + 4.0 * self.dx + m, R_FLUID + m))


def _shell_lattice(dx: float, res_shell: float, shell_thickness: float,
                   wall_thickness: float):
    """ShellBoundary generator (poiseuille_flow_shell.cpp:64-99): rings of
    surface particles on the mid-surface radius R + res_shell/2, axially
    from -wall_thickness to L + wall_thickness, outward radial normals."""
    r_mid = R_FLUID + 0.5 * res_shell
    n_circ = int(2.0 * r_mid * math.pi / res_shell)
    n_h = int((FULL_LENGTH + 2.0 * wall_thickness) / res_shell)
    i = np.arange(n_circ)
    theta = (i + 0.5) * 2.0 * math.pi / n_circ
    j = np.arange(n_h)
    y = (-wall_thickness + (FULL_LENGTH + 2.0 * wall_thickness) * j / n_h
         + 0.5 * res_shell)
    tt, yy = np.meshgrid(theta, y, indexing="ij")
    x = r_mid * np.cos(tt)
    z = r_mid * np.sin(tt)
    pos = np.stack([x.ravel(), yy.ravel(), z.ravel()], axis=-1)
    nrm = np.stack([np.cos(tt).ravel(), np.zeros(pos.shape[0]),
                    np.sin(tt).ravel()], axis=-1)
    return pos, nrm


def build_case(n_particles: int = 10, dtype=jnp.float32, reserve: float = 0.5,
               k_ff: int = 96, k_fs: int = 128, k_ss: int = 112,
               cap: int = 40):
    dx = DIAMETER / n_particles
    res_shell = 0.5 * dx
    shell_thickness = 0.5 * res_shell
    wall_thickness = 4.0 * dx
    inflow_length = 10.0 * dx
    adaptation = SPHAdaptation(spacing=dx, dim=3)
    kernel = adaptation.kernel

    # fluid: lattice fill of the cylinder x^2 + z^2 < R^2, y in (0, L)
    xs = np.arange(-R_FLUID + dx / 2, R_FLUID, dx)
    ys = np.arange(dx / 2, FULL_LENGTH, dx)
    zs = np.arange(-R_FLUID + dx / 2, R_FLUID, dx)
    pos = np.stack(np.meshgrid(xs, ys, zs, indexing="ij"), -1).reshape(-1, 3)
    pos = pos[pos[:, 0] ** 2 + pos[:, 2] ** 2 < R_FLUID ** 2]
    n_f = len(pos)
    cap_f = int(n_f * (1.0 + reserve))
    fluid = make_fluid_state(pos, dx ** 3, RHO0_F, capacity=cap_f,
                             dtype=dtype)
    fluid = bd.ensure_alive_mask(fluid)
    zc = jnp.zeros((cap_f,), jnp.int32)
    fluid["Indicator"] = zc
    fluid["PreviousSurfaceIndicator"] = zc
    fluid["PositionDivergence"] = jnp.zeros((cap_f,), dtype)
    fluid["ViscousForce"] = jnp.zeros((cap_f, 3), dtype)
    fluid["ViscousForcePrev"] = jnp.zeros((cap_f, 3), dtype)

    # rigid shell pipe (static): area measure + thickness + outward normals
    spos, snrm = _shell_lattice(dx, res_shell, shell_thickness,
                                wall_thickness)
    n_s = len(spos)
    shell = make_solid_state(spos, res_shell * res_shell, 1.0)
    shell["NormalDirection"] = jnp.asarray(snrm, dtype)
    shell["Thickness"] = jnp.full((n_s,), shell_thickness, dtype)
    # Mass consistent with rho0 = 1 passed as the shell rho0 in the
    # density-summation contact term (only the ratio enters)
    shell["Mass"] = shell["VolumetricMeasure"] * shell["Thickness"]

    lo = (-R_FLUID - res_shell - 4 * dx, -wall_thickness - 4 * dx,
          -R_FLUID - res_shell - 4 * dx)
    hi = (R_FLUID + res_shell + 4 * dx, FULL_LENGTH + wall_thickness + 4 * dx,
          R_FLUID + res_shell + 4 * dx)
    grid = grid_from_bounds(lo, hi, kernel.cutoff)
    shell_table = build_cell_table(shell["Position"], jnp.int32(n_s), grid,
                                   cap=2 * cap)

    # shell curvature ONCE with the contact (fluid) kernel reduced once
    # (ShellInnerRelationWithContactKernel + AverageShellCurvature)
    rk = sh.ReducedKernel(kernel)
    nl_ss = build_neighbor_list(shell["Position"], jnp.int32(n_s),
                                shell["Position"], jnp.int32(n_s),
                                shell_table, grid, kernel.cutoff,
                                k_max=k_ss, include_self=False)
    k1, k2 = sf.shell_curvature(shell, nl_ss, rk, 3)

    # inflow/outflow regions along y (cpp:141-151)
    emitter = bd.AlignedBoxRegion(
        lower=(-R_FLUID, 0.0, -R_FLUID),
        upper=(R_FLUID, 4.0 * dx, R_FLUID), axis=1)
    emitter_buffer = bd.AlignedBoxRegion(
        lower=(-R_FLUID, -2.0 * dx, -R_FLUID),
        upper=(R_FLUID, inflow_length - 2.0 * dx, R_FLUID), axis=1)
    disposer = bd.AlignedBoxRegion(
        lower=(-1.1 * R_FLUID, FULL_LENGTH - 4.0 * dx, -1.1 * R_FLUID),
        upper=(1.1 * R_FLUID, FULL_LENGTH + 4.0 * dx, 1.1 * R_FLUID), axis=1)

    eos = WeaklyCompressibleFluid(rho0=RHO0_F, c0=C_F)
    case = PipeCase(dx=dx, res_shell=res_shell, adaptation=adaptation,
                    eos=eos, riemann=rs.acoustic_riemann(eos),
                    no_riemann=rs.no_riemann(eos),
                    shell=shell, shell_k1=k1, shell_k2=k2,
                    shell_table=shell_table, grid=grid, emitter=emitter,
                    emitter_buffer=emitter_buffer, disposer=disposer,
                    n_fluid=cap_f, n_shell=n_s, k_ff=k_ff, k_fs=k_fs)
    return case, fluid


def rebuild_relations(case: PipeCase, fluid):
    pos = fluid["Position"]
    valid = fluid["Alive"]
    kernel = case.kernel
    table_f = build_cell_table(pos, valid, case.grid, cap=case.n_fluid // 64)
    nl_ff = build_neighbor_list(pos, valid, pos, valid, table_f, case.grid,
                                kernel.cutoff, k_max=case.k_ff,
                                include_self=False)
    nl_fs = build_neighbor_list(pos, valid, case.shell["Position"],
                                jnp.int32(case.n_shell), case.shell_table,
                                case.grid, kernel.cutoff, k_max=case.k_fs,
                                include_self=True)
    return nl_ff, nl_fs, nl_ff.overflow | nl_fs.overflow


def init_sim(case: PipeCase, fluid) -> PipeSim:
    nl_ff, nl_fs, ovf = jax.jit(partial(rebuild_relations, case))(fluid)
    dtype = fluid["Position"].dtype
    z32 = jnp.zeros((), jnp.int32)
    return PipeSim(fluid=fluid, nl_ff=nl_ff, nl_fs=nl_fs,
                   time=jnp.zeros((), dtype), n_adv=z32, n_ac=z32,
                   overflow=ovf)


def _inflow_condition(fluid, region, relaxation: float = 1.0):
    """InflowVelocityCondition<InflowVelocity> (cpp:103-124): set the
    parabolic axial profile in the emitter buffer."""
    pos, vel = fluid["Position"], fluid["Velocity"]
    r2 = (pos[:, 0] ** 2 + pos[:, 2] ** 2) / (R_FLUID * R_FLUID)
    target = jnp.maximum(2.0 * U_F * (1.0 - r2), 0.0)
    in_buf = region.contains(pos) & fluid["Alive"]
    vy = jnp.where(in_buf, vel[:, 1] + relaxation * (target - vel[:, 1]),
                   vel[:, 1])
    out = dict(fluid)
    out["Velocity"] = jnp.stack([vel[:, 0], vy, vel[:, 2]], axis=-1)
    return out


def _advection_step(case: PipeCase, s: PipeSim) -> PipeSim:
    kernel, dim = case.kernel, 3
    h = case.adaptation.h
    sigma0 = case.adaptation.sigma0
    fluid = s.fluid
    pos_prev = fluid["Position"]

    # frozen curvature-corrected shell contact for this advection step;
    # shell normals already point fluid -> shell (outward)
    pairs = sf.shell_contact_pairs(fluid["Position"], case.shell,
                                   case.shell_k1, case.shell_k2, s.nl_fs,
                                   kernel, dim, case.res_shell)
    sw = [(case.shell, s.nl_fs, pairs)]

    dt_adv = fd.advection_viscous_time_step(fluid, h, U_MAX, RHO0_F, MU_F)
    fluid = fd.free_surface_indication(fluid, s.nl_ff, kernel, dim,
                                       spatial_temporal=True, shell_walls=sw)
    fluid = fd.density_summation_freestream(
        fluid, s.nl_ff, kernel, dim, RHO0_F, sigma0,
        shell_contacts=[(case.shell, s.nl_fs, pairs, 1.0)])
    fluid = fd.viscous_force(fluid, s.nl_ff, kernel, dim, MU_F, h,
                             shell_walls=sw)
    fluid = fd.transport_velocity_correction(
        fluid, s.nl_ff, kernel, dim, h, shell_walls=sw,
        scope_mask=fluid["Indicator"] == 0)

    def ac_cond(carry):
        _, rt, _ = carry
        return rt < dt_adv

    def ac_body(carry):
        f, rt, k = carry
        dt = jnp.minimum(fd.acoustic_time_step(f, case.eos, h),
                         dt_adv - rt + 1e-12)
        f = fd.acoustic_step_1st_half(f, s.nl_ff, kernel, dim, case.eos,
                                      case.riemann, dt, shell_walls=sw)
        f = fd.acoustic_step_2nd_half(f, s.nl_ff, kernel, dim,
                                      case.no_riemann, dt, shell_walls=sw)
        f = _inflow_condition(f, case.emitter_buffer)
        return (f, rt + dt, k + 1)

    fluid, relax_t, n_ac = jax.lax.while_loop(
        ac_cond, ac_body,
        (fluid, jnp.zeros_like(dt_adv), jnp.zeros((), jnp.int32)))

    fluid = bd.emitter_inflow_injection(
        fluid, case.emitter,
        fields=bd._PARTICLE_FIELDS_HINT + ("ViscousForce",
                                           "ViscousForcePrev", "Indicator",
                                           "PreviousSurfaceIndicator",
                                           "PositionDivergence"),
        prev_pos=pos_prev)
    inj_ovf = fluid.pop("_InjectionOverflow", jnp.zeros((), bool))
    fluid = bd.disposer_outflow_deletion(fluid, case.disposer)

    nl_ff, nl_fs, ovf = rebuild_relations(case, fluid)
    return PipeSim(fluid=fluid, nl_ff=nl_ff, nl_fs=nl_fs,
                   time=s.time + relax_t, n_adv=s.n_adv + 1,
                   n_ac=s.n_ac + n_ac, overflow=s.overflow | ovf | inj_ovf)


def make_run_chunk(case: PipeCase):
    @jax.jit
    def run_chunk(s: PipeSim, t_target) -> PipeSim:
        return jax.lax.while_loop(lambda st: st.time < t_target,
                                  lambda st: _advection_step(case, st), s)

    return run_chunk


def radial_observation_points(n: int = 10):
    """createRadialObservationPoints (cpp:44-60): at y = L/2, points at
    z = +- R i/(n+1), skipping the near-boundary point."""
    y = 0.5 * FULL_LENGTH
    pts = []
    for i in range(n):
        z = R_FLUID * i / (n + 1)
        pts.append((0.0, y, z))
        pts.append((0.0, y, -z))
    return np.asarray(pts)


def axial_observation_points(n: int = 51):
    return np.asarray([(0.0, FULL_LENGTH * i / (n - 1), 0.0)
                       for i in range(n)])


def observed_velocity(case: PipeCase, s: PipeSim, obs_pos):
    """Shepard-interpolated fluid velocity at the observation points."""
    obs_pos = jnp.asarray(obs_pos, s.fluid["Position"].dtype)
    table_f = build_cell_table(s.fluid["Position"], s.fluid["Alive"],
                               case.grid, cap=case.n_fluid // 64)
    nl = build_neighbor_list(obs_pos, jnp.int32(obs_pos.shape[0]),
                             s.fluid["Position"], s.fluid["Alive"], table_f,
                             case.grid, case.kernel.cutoff, k_max=case.k_ff,
                             include_self=True)
    return observe_quantity(obs_pos, s.fluid, "Velocity", nl, case.kernel, 3)


def analytic_profile(obs_pos):
    r2 = (obs_pos[:, 0] ** 2 + obs_pos[:, 2] ** 2) / (R_FLUID * R_FLUID)
    return 2.0 * U_F * (1.0 - r2)
