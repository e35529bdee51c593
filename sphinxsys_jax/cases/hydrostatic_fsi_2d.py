"""Hydrostatic water column on an elastic shell gate (shell <-> fluid FSI).

Mirrors /root/reference/tests/2d_examples/test_2d_hydrostatic_fluid_shell/
test_2d_hydrostatic_fluid_shell.cpp (dp_2 CI configuration): a 1 x 2 m
water column rests on a clamped elastic shell gate spanning the tank
floor; the side walls are rigid single-layer shell particles.  Both the
walls and the gate couple to the fluid through the curvature-corrected
dummy-particle contacts (physics/shell_fluid.py), and the gate feels the
fluid through PressureForceFromFluid on the fluid->shell corrected pairs.

Oracle: static mid-span deflection of a clamped-clamped plate under
uniform pressure p = rho g H:  w = p L^4 / (384 E I),  I = t^3/12
(the reference asserts 15%; gtest at cpp:395-409).
"""

from __future__ import annotations

import dataclasses
import math
import types
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from sphinxsys_jax.core.adaptation import SPHAdaptation
from sphinxsys_jax.core.materials import (SaintVenantKirchhoffSolid,
                                          WeaklyCompressibleFluid)
from sphinxsys_jax.core.state import make_fluid_state
from sphinxsys_jax.neighbors import (build_cell_table, build_neighbor_list,
                                     grid_from_bounds)
from sphinxsys_jax.physics import dissipation as dp
from sphinxsys_jax.physics import fluid as fd
from sphinxsys_jax.physics import fsi
from sphinxsys_jax.physics import general as gd
from sphinxsys_jax.physics import riemann as rs
from sphinxsys_jax.physics import shell as sh
from sphinxsys_jax.physics import shell_fluid as sf
from sphinxsys_jax.physics import solid as sd

DL = 1.0          # tank length
DH = 2.1          # tank height
DAM_H = 2.0       # water height
GATE_T = 0.05     # gate thickness
RHO0_F = 1000.0
GRAVITY_G = 9.81
U_REF = 2.0 * math.sqrt(DAM_H * GRAVITY_G)
C_F = 10.0 * U_REF
RHO0_S = 2700.0
POISSON = 0.495
YOUNGS = 6.75e10

# analytic clamped-clamped mid-span deflection
ANALYTIC_DISP = (RHO0_F * GRAVITY_G * DAM_H * DL ** 4
                 / 384.0 / YOUNGS / (GATE_T ** 3 / 12.0))


class HFSISim(NamedTuple):
    fluid: Any
    gate: Any
    nl_ff: Any
    nl_fw: Any     # fluid -> rigid side walls (shell-type)
    nl_fg: Any     # fluid -> gate
    nl_gf: Any     # gate -> fluid
    time: jnp.ndarray
    n_adv: jnp.ndarray
    n_ac: jnp.ndarray
    overflow: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class HFSICase:
    dx: float
    adaptation: SPHAdaptation
    grid: Any
    eos: WeaklyCompressibleFluid
    riemann: Any
    no_riemann: Any
    gravity: Any
    material_s: SaintVenantKirchhoffSolid
    wall: Any                 # rigid side walls (static shell state)
    wall_table: Any
    gate_rp: Any              # frozen shell reference pairs (reduced kernel)
    nl_gg: Any                # gate inner NL with the fluid kernel (curvature)
    clamp_mask: Any
    mu_f: float
    eta_gate: float
    n_fluid: int
    n_gate: int
    n_wall: int
    cell_cap: int
    k_inner: int
    k_shell: int
    k_gf: int
    center_idx: int           # gate particle nearest the mid-span observer

    @property
    def kernel(self):
        return self.adaptation.kernel


def build_case(dx: float = 0.025, dtype=jnp.float32, cell_cap: int = 24,
               k_inner: int = 32, k_shell: int = 16, k_gf: int = 40):
    BW = 4 * dx
    adaptation = SPHAdaptation(spacing=dx, dim=2)
    kernel = adaptation.kernel

    # fluid lattice (water column [0, DL] x [0, DAM_H])
    xs = np.arange(dx / 2, DL, dx)
    ys = np.arange(dx / 2, DAM_H, dx)
    pos_f = np.stack(np.meshgrid(xs, ys, indexing="ij"), -1).reshape(-1, 2)
    fluid = make_fluid_state(pos_f, dx * dx, RHO0_F, dtype=dtype)

    # rigid side walls: single-layer shell particles with inward normals
    # (cpp WallBoundary generator: x = -dx/2 and DL + dx/2)
    yw = np.arange(dx / 2, DH, dx)
    pos_w = np.concatenate([
        np.stack([np.full_like(yw, -0.5 * dx), yw], -1),
        np.stack([np.full_like(yw, DL + 0.5 * dx), yw], -1)])
    n_w = np.concatenate([
        np.tile([1.0, 0.0], (len(yw), 1)), np.tile([-1.0, 0.0], (len(yw), 1))])
    wall_mat = types.SimpleNamespace(rho0=1.0)
    wall = sh.make_shell_state(pos_w, n_w, dx, dx, wall_mat, dtype=dtype)
    wall["AverageVelocity"] = jnp.zeros_like(wall["Velocity"])
    wall["AverageAcceleration"] = jnp.zeros_like(wall["Velocity"])

    # elastic gate: single line of shell particles under the column
    xg = np.arange(-BW + dx / 2, DL + BW, dx)
    pos_g = np.stack([xg, np.full_like(xg, -0.5 * dx)], -1)
    n_g = np.tile([0.0, 1.0], (len(xg), 1))
    material_s = SaintVenantKirchhoffSolid(rho0=RHO0_S, youngs_modulus=YOUNGS,
                                           poisson_ratio=POISSON)
    gate = sh.make_shell_state(pos_g, n_g, dx, GATE_T, material_s, dtype=dtype)
    gate["AverageVelocity"] = jnp.zeros_like(gate["Velocity"])
    gate["AverageAcceleration"] = jnp.zeros_like(gate["Velocity"])
    # pre-seed the FSI bookkeeping keys so the while_loop carry is stable
    gate["TemporaryPosition"] = gate["Position"]
    for key in ("PressureForceFromFluid",):
        gate[key] = jnp.zeros_like(gate["Velocity"])
        gate["Previous" + key] = jnp.zeros_like(gate["Velocity"])

    grid = grid_from_bounds((-BW - dx, -GATE_T - dx), (DL + BW + dx, DH),
                            adaptation.cutoff)
    n_g_count = len(xg)
    wall_table = jax.jit(lambda p: build_cell_table(
        p, jnp.int32(len(pos_w)), grid, cap=cell_cap))(wall["Position"])

    # gate inner relations: stress relaxation runs on the REDUCED shell
    # kernel; curvature runs on the same pairs with the fluid's kernel
    # (ShellInnerRelationWithContactKernel, reduced once)
    gate_table = build_cell_table(gate["Position"], jnp.int32(n_g_count),
                                  grid, cap=cell_cap)
    nl_gg = build_neighbor_list(gate["Position"], jnp.int32(n_g_count),
                                gate["Position"], jnp.int32(n_g_count),
                                gate_table, grid, adaptation.cutoff,
                                k_max=k_shell, include_self=False)
    reduced = sh.ReducedKernel(kernel)
    gate_rp = sd.freeze_reference_pairs(gate["Position"], nl_gg, reduced, 2)
    gate = sh.shell_correct_configuration(gate, gate_rp)

    clamp_mask = jnp.asarray((xg < 0.0) | (xg > DL))
    center_idx = int(np.argmin(np.abs(xg - 0.5 * DL)))

    gravity = gd.Gravity(acceleration=(0.0, -GRAVITY_G))
    fluid = gd.gravity_force(fluid, gravity)
    eos = WeaklyCompressibleFluid(rho0=RHO0_F, c0=C_F)

    mu_f = RHO0_F * U_REF * DL / 0.1          # Re = 0.1 (quasi-static)
    eta_gate = 0.4 / 4.0 * math.sqrt(RHO0_S * YOUNGS) * GATE_T * GATE_T

    case = HFSICase(
        dx=dx, adaptation=adaptation, grid=grid, eos=eos,
        riemann=rs.acoustic_riemann(eos), no_riemann=rs.no_riemann(eos),
        gravity=gravity, material_s=material_s, wall=wall,
        wall_table=wall_table, gate_rp=gate_rp, nl_gg=nl_gg,
        clamp_mask=clamp_mask, mu_f=mu_f, eta_gate=eta_gate,
        n_fluid=len(pos_f), n_gate=n_g_count, n_wall=len(pos_w),
        cell_cap=cell_cap, k_inner=k_inner, k_shell=k_shell, k_gf=k_gf,
        center_idx=center_idx)
    return case, fluid, gate


def rebuild_relations(case: HFSICase, fluid, gate):
    pos = fluid["Position"]
    n = fluid["NReal"]
    cutoff = case.adaptation.cutoff
    table = build_cell_table(pos, n, case.grid, cap=case.cell_cap)
    nl_ff = build_neighbor_list(pos, n, pos, n, table, case.grid, cutoff,
                                k_max=case.k_inner, include_self=False)
    nl_fw = build_neighbor_list(pos, n, case.wall["Position"],
                                case.wall["NReal"], case.wall_table,
                                case.grid, cutoff, k_max=case.k_shell,
                                include_self=True)
    gate_table = build_cell_table(gate["Position"], jnp.int32(case.n_gate),
                                  case.grid, cap=case.cell_cap)
    nl_fg = build_neighbor_list(pos, n, gate["Position"],
                                jnp.int32(case.n_gate), gate_table,
                                case.grid, cutoff, k_max=case.k_shell,
                                include_self=True)
    nl_gf = build_neighbor_list(gate["Position"], jnp.int32(case.n_gate),
                                pos, n, table, case.grid, cutoff,
                                k_max=case.k_gf, include_self=True)
    ovf = nl_ff.overflow | nl_fw.overflow | nl_fg.overflow | nl_gf.overflow
    return nl_ff, nl_fw, nl_fg, nl_gf, ovf


def init_sim(case: HFSICase, fluid, gate) -> HFSISim:
    nl_ff, nl_fw, nl_fg, nl_gf, ovf = jax.jit(
        lambda f, g: rebuild_relations(case, f, g))(fluid, gate)
    dtype = fluid["Position"].dtype
    z32 = jnp.zeros((), jnp.int32)
    return HFSISim(fluid=fluid, gate=gate, nl_ff=nl_ff, nl_fw=nl_fw,
                   nl_fg=nl_fg, nl_gf=nl_gf, time=jnp.zeros((), dtype),
                   n_adv=z32, n_ac=z32, overflow=ovf)


def _constrain(gate, mask):
    out = dict(gate)
    m = mask[:, None]
    out["Position"] = jnp.where(m, gate["InitialPosition"], gate["Position"])
    out["Velocity"] = jnp.where(m, 0.0, gate["Velocity"])
    out["Rotation"] = jnp.where(m, 0.0, gate["Rotation"])
    out["AngularVelocity"] = jnp.where(m, 0.0, gate["AngularVelocity"])
    return out


def _advection_step(case: HFSICase, s: HFSISim) -> HFSISim:
    kernel, dim = case.kernel, 2
    h = case.adaptation.h
    sigma0 = case.adaptation.sigma0
    fluid, gate = s.fluid, s.gate

    # curvature of the gate with the contact (fluid) kernel, reduced once
    k1_g, k2_g = sf.shell_curvature(gate, case.nl_gg,
                                    sh.ReducedKernel(kernel), dim)
    zero_w = jnp.zeros((case.wall["Position"].shape[0],),
                       fluid["Position"].dtype)

    # frozen curvature-corrected contact pairs for this advection step;
    # wall/gate normals point INTO the fluid -> normal_correction=True
    pairs_fw = sf.shell_contact_pairs(fluid["Position"], case.wall, zero_w,
                                      zero_w, s.nl_fw, kernel, dim, case.dx,
                                      normal_correction=True)
    pairs_fg = sf.shell_contact_pairs(fluid["Position"], gate, k1_g, k2_g,
                                      s.nl_fg, kernel, dim, case.dx,
                                      normal_correction=True)
    pairs_gf = sf.fluid_to_shell_pairs(gate, k1_g, k2_g, fluid["Position"],
                                       s.nl_gf, kernel, dim, case.dx,
                                       normal_correction=True)

    dt_adv = fd.advection_time_step(fluid, h, U_REF)
    fluid = fd.density_summation(
        fluid, s.nl_ff, kernel, dim, RHO0_F, sigma0, free_surface=True,
        shell_contacts=[(case.wall, s.nl_fw, pairs_fw, 1.0),
                        (gate, s.nl_fg, pairs_fg, RHO0_S)])

    c0s = case.material_s.sound_speed
    shell_walls = [(case.wall, s.nl_fw, pairs_fw), (gate, s.nl_fg, pairs_fg)]

    def ac_cond(carry):
        _, _, rt, _ = carry
        return rt < dt_adv

    def ac_body(carry):
        f, g, rt, k_ac = carry
        dt = jnp.minimum(fd.acoustic_time_step(f, case.eos, h), dt_adv)
        # implicit pairwise damping (DampingPairwiseWithWall, mu_f)
        f = dp.damping_pairwise(f, "Velocity", s.nl_ff, kernel, dim,
                                case.mu_f, dt)
        f = dp.damping_pairwise_wall(f, "Velocity", g, s.nl_fg, kernel, dim,
                                     case.mu_f, dt)
        f = dp.damping_pairwise_wall(f, "Velocity", case.wall, s.nl_fw,
                                     kernel, dim, case.mu_f, dt)
        sw = [(case.wall, s.nl_fw, pairs_fw), (g, s.nl_fg, pairs_fg)]
        f = fd.acoustic_step_1st_half(f, s.nl_ff, kernel, dim, case.eos,
                                      case.riemann, dt, shell_walls=sw)
        pressure_force = sf.pressure_force_from_fluid_on_shell(
            g, f, pairs_gf, s.nl_gf, case.no_riemann)
        g = fsi.force_prior_update(g, "PressureForceFromFluid", pressure_force)
        f = fd.acoustic_step_2nd_half(f, s.nl_ff, kernel, dim,
                                      case.no_riemann, dt, shell_walls=sw)

        # shell sub-cycling (cpp:337-350)
        g = fsi.initialize_displacement(g)

        def s_cond(sc):
            _, ds_sum = sc
            return ds_sum < dt

        def s_body(sc):
            g_i, ds_sum = sc
            dt_s = jnp.minimum(
                sh.shell_acoustic_time_step(g_i, case.material_s, h),
                dt - ds_sum)
            g_i = sh.shell_stress_relaxation_1st_half(g_i, case.gate_rp,
                                                      case.material_s, dt_s, h)
            g_i = _constrain(g_i, case.clamp_mask)
            g_i = dp.damping_pairwise(g_i, "Velocity", case.nl_gg, kernel,
                                      dim, case.eta_gate, dt_s)
            g_i = dp.damping_pairwise(g_i, "AngularVelocity", case.nl_gg,
                                      kernel, dim, case.eta_gate, dt_s)
            g_i = _constrain(g_i, case.clamp_mask)
            g_i = sh.shell_stress_relaxation_2nd_half(g_i, case.gate_rp, dt_s)
            return (g_i, ds_sum + dt_s)

        g, _ = jax.lax.while_loop(s_cond, s_body, (g, jnp.zeros_like(dt)))
        g = fsi.update_average_velocity_acceleration(g, dt)
        return (f, g, rt + dt, k_ac + 1)

    fluid, gate, relax_t, n_ac = jax.lax.while_loop(
        ac_cond, ac_body,
        (fluid, gate, jnp.zeros_like(dt_adv), jnp.zeros((), jnp.int32)))

    gate = sh.update_shell_normal(gate)
    nl_ff, nl_fw, nl_fg, nl_gf, ovf = rebuild_relations(case, fluid, gate)
    return HFSISim(fluid=fluid, gate=gate, nl_ff=nl_ff, nl_fw=nl_fw,
                   nl_fg=nl_fg, nl_gf=nl_gf, time=s.time + relax_t,
                   n_adv=s.n_adv + 1, n_ac=s.n_ac + n_ac,
                   overflow=s.overflow | ovf)


def make_run_chunk(case: HFSICase):
    @jax.jit
    def run_chunk(s: HFSISim, t_target) -> HFSISim:
        return jax.lax.while_loop(lambda st: st.time < t_target,
                                  lambda st: _advection_step(case, st), s)

    return run_chunk


def center_displacement(case: HFSICase, s: HFSISim) -> float:
    g = s.gate
    d = g["Position"][case.center_idx] - g["InitialPosition"][case.center_idx]
    return float(d[1])
