"""Elastic gate under a water column (test_2d_elastic_gate).

Mirrors /root/reference/tests/2d_examples/test_2d_elastic_gate/
elastic_gate.cpp: a 100 x 140 water column in the right corner of a
500-long tank, held back by a rubber gate (width 5, clamped above
y = 79) that bends open and releases the water; gravity 9.8e-3,
c = 20 sqrt(140 g), SVK gate (rho 1.1, E = 7.8e3, nu = 0.47) at 2x
refinement (gate spacing = dx/2, defineAdaptationRatios(1.15, 2.0)),
INVISCID fluid with Riemann dissipation in BOTH halves, no TVC.

The observer is the gate's bottom-left tip (a frozen-weight material
point like fsi2's) whose Position trajectory carries a committed
reference DTW database (Observer_Position_Run_{0,6,12}).

Mixed-resolution contact: the reference's plain ContactRelation
evaluates cross-body kernels at the COARSER body's h (NeighborBuilder
chooseKernel) — the fluid's h here — which our wall/contact terms already
do (they take per-particle wall volumes at the fluid kernel).
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
from sphinxsys_jax.core.materials import (SaintVenantKirchhoffSolid,
                                          WeaklyCompressibleFluid)
from sphinxsys_jax.core.state import State, make_fluid_state, make_solid_state
from sphinxsys_jax.neighbors import (build_cell_table, build_neighbor_list,
                                     grid_from_bounds)
from sphinxsys_jax.physics import fluid as fd
from sphinxsys_jax.physics import fsi
from sphinxsys_jax.physics import general as gd
from sphinxsys_jax.physics import riemann as rs
from sphinxsys_jax.physics import solid as sd

DL = 500.0
DH = 200.1
DAM_L = 100.0
DAM_H = 140.0
GATE_W = 5.0
BASE_Y = 79.0            # clamped above this height
RHO0_F = 1.0
GRAVITY_G = 9.8e-3
U_F = 1.0
C_F = 20.0 * math.sqrt(140.0 * GRAVITY_G)
RHO0_S = 1.1
POISSON = 0.47
YOUNGS = 7.8e3 * RHO0_F * U_F * U_F


class GateSim(NamedTuple):
    fluid: Any
    gate: Any
    nl_ff: Any
    nl_fw: Any
    nl_fg: Any     # fluid -> gate (wall-type contact)
    nl_gf: Any     # gate -> fluid (pressure force)
    time: jnp.ndarray
    n_adv: jnp.ndarray
    n_ac: jnp.ndarray
    n_s: jnp.ndarray
    overflow: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class GateCase:
    dx: float
    adaptation: SPHAdaptation
    grid: Any
    eos: WeaklyCompressibleFluid
    riemann: Any
    gravity: Any
    material_s: SaintVenantKirchhoffSolid
    wall: State
    wall_table: Any
    rp: sd.ReferencePairs
    clamp_mask: Any
    tip_idx: int
    n_fluid: int
    n_wall: int
    n_gate: int
    cell_cap: int
    k_inner: int
    k_contact: int

    @property
    def kernel(self):
        return self.adaptation.kernel


def build_case(dx: float = GATE_W / 2.0, dtype=jnp.float32,
               cell_cap: int = 24, k_inner: int = 48, k_contact: int = 48):
    BW = 4 * dx
    adaptation = SPHAdaptation(spacing=dx, dim=2)
    dxs = dx / 2.0               # gate refinement 2x

    # water column in the right corner
    xs = np.arange(DL - DAM_L + dx / 2, DL, dx)
    ys = np.arange(dx / 2, DAM_H, dx)
    pos_f = np.stack(np.meshgrid(xs, ys, indexing="ij"), -1).reshape(-1, 2)

    # tank walls
    outer = G.Box(G.Transform(translation=(DL / 2, DH / 2)),
                  halfsize=(DL / 2 + BW, DH / 2 + BW))
    inner = G.Box(G.Transform(translation=(DL / 2, DH / 2)),
                  halfsize=(DL / 2, DH / 2))
    wall_shape = G.make_complex(("add", outer), ("sub", inner))
    dom_lo, dom_hi = (-BW, -BW), (DL + BW, DH + BW)
    pos_w, _ = generate_lattice(wall_shape, dom_lo, dom_hi, dx)

    # gate: fine lattice column [DL-DAM_L-GATE_W, DL-DAM_L] x [0, DAM_H+BW],
    # shifted up so a lattice plane lands on the clamp line
    # (OffsetInitialPosition, elastic_gate.cpp:22-23)
    off_y = BASE_Y - math.floor(BASE_Y / dxs) * dxs
    gx = np.arange(DL - DAM_L - GATE_W + dxs / 2, DL - DAM_L, dxs)
    gy = np.arange(dxs / 2, DAM_H + BW, dxs) + off_y
    pos_g = np.stack(np.meshgrid(gx, gy, indexing="ij"), -1).reshape(-1, 2)

    fluid = make_fluid_state(pos_f, dx * dx, RHO0_F, dtype=dtype)
    wall = make_solid_state(pos_w, dx * dx, RHO0_F, dtype=dtype)
    wall = gd.normal_direction_from_shape(wall, wall_shape)

    material_s = SaintVenantKirchhoffSolid(rho0=RHO0_S, youngs_modulus=YOUNGS,
                                           poisson_ratio=POISSON)
    gate = dict(sd.make_elastic_solid_state(pos_g, dxs * dxs, material_s,
                                            dtype=dtype))
    n_g = len(pos_g)
    gate["AverageVelocity"] = jnp.zeros((n_g, 2), dtype)
    gate["AverageAcceleration"] = jnp.zeros((n_g, 2), dtype)
    gate["TemporaryPosition"] = gate["Position"]
    for key in ("PressureForceFromFluid",):
        gate[key] = jnp.zeros((n_g, 2), dtype)
        gate["Previous" + key] = jnp.zeros((n_g, 2), dtype)
    # normals point from the gate toward the fluid side (+x)
    gate["NormalDirection"] = jnp.broadcast_to(
        jnp.asarray([1.0, 0.0], dtype), (n_g, 2))
    gate["InitialNormalDirection"] = gate["NormalDirection"]

    # frozen total-Lagrangian pairs at the FINE resolution
    fine = SPHAdaptation(spacing=dxs, dim=2)
    grid_g = grid_from_bounds(
        (DL - DAM_L - GATE_W - 4 * dxs, -4 * dxs),
        (DL - DAM_L + 4 * dxs, DAM_H + BW + 4 * dxs), fine.cutoff)
    table_g = build_cell_table(gate["Position"], jnp.int32(n_g), grid_g,
                               cap=16)
    nl_gg = build_neighbor_list(gate["Position"], jnp.int32(n_g),
                                gate["Position"], jnp.int32(n_g), table_g,
                                grid_g, fine.cutoff, k_max=32,
                                include_self=False)
    rp = sd.freeze_reference_pairs(gate["Position"], nl_gg, fine.kernel, 2)
    gate["LinearGradientCorrectionMatrix"] = \
        sd.linear_gradient_correction_matrix(rp, gate["VolumetricMeasure"])

    clamp_mask = jnp.asarray(pos_g[:, 1] >= BASE_Y)
    # observer: the gate's bottom-left tip particle (material point)
    tip_idx = int(np.argmin(pos_g[:, 0] + pos_g[:, 1]))

    eos = WeaklyCompressibleFluid(rho0=RHO0_F, c0=C_F)
    gravity = gd.Gravity(acceleration=(0.0, -GRAVITY_G))
    fluid = gd.gravity_force(fluid, gravity)

    grid = grid_from_bounds(dom_lo, dom_hi, adaptation.cutoff)
    wall_table = jax.jit(partial(build_cell_table, grid=grid,
                                 cap=cell_cap))(wall["Position"],
                                                wall["NReal"])

    case = GateCase(dx=dx, adaptation=adaptation, grid=grid, eos=eos,
                    riemann=rs.acoustic_riemann(eos), gravity=gravity,
                    material_s=material_s, wall=wall, wall_table=wall_table,
                    rp=rp, clamp_mask=clamp_mask, tip_idx=tip_idx,
                    n_fluid=len(pos_f), n_wall=len(pos_w), n_gate=n_g,
                    cell_cap=cell_cap, k_inner=k_inner, k_contact=k_contact)
    return case, fluid, gate


def rebuild_relations(case: GateCase, fluid: State, gate):
    pos = fluid["Position"]
    n = fluid["NReal"]
    cutoff = case.adaptation.cutoff
    table = build_cell_table(pos, n, case.grid, cap=case.cell_cap)
    nl_ff = build_neighbor_list(pos, n, pos, n, table, case.grid, cutoff,
                                k_max=case.k_inner, include_self=False)
    nl_fw = build_neighbor_list(pos, n, case.wall["Position"],
                                case.wall["NReal"], case.wall_table,
                                case.grid, cutoff, k_max=case.k_contact,
                                include_self=True)
    # the gate is finer: its per-cell count at the fluid grid is ~4x, so
    # give its table a larger cap
    table_g = build_cell_table(gate["Position"], jnp.int32(case.n_gate),
                               case.grid, cap=4 * case.cell_cap)
    nl_fg = build_neighbor_list(pos, n, gate["Position"],
                                jnp.int32(case.n_gate), table_g, case.grid,
                                cutoff, k_max=case.k_contact,
                                include_self=True)
    nl_gf = build_neighbor_list(gate["Position"], jnp.int32(case.n_gate),
                                pos, n, table, case.grid, cutoff,
                                k_max=case.k_contact, include_self=True)
    ovf = nl_ff.overflow | nl_fw.overflow | nl_fg.overflow | nl_gf.overflow
    return nl_ff, nl_fw, nl_fg, nl_gf, ovf


def init_sim(case: GateCase, fluid: State, gate) -> GateSim:
    nl_ff, nl_fw, nl_fg, nl_gf, ovf = jax.jit(
        lambda f, g: rebuild_relations(case, f, g))(fluid, gate)
    dtype = fluid["Position"].dtype
    z32 = jnp.zeros((), jnp.int32)
    return GateSim(fluid=fluid, gate=gate, nl_ff=nl_ff, nl_fw=nl_fw,
                   nl_fg=nl_fg, nl_gf=nl_gf, time=jnp.zeros((), dtype),
                   n_adv=z32, n_ac=z32, n_s=z32, overflow=ovf)


def _advection_step(case: GateCase, s: GateSim) -> GateSim:
    kernel, dim = case.kernel, 2
    h = case.adaptation.h
    h_s = case.adaptation.h / 2.0
    sigma0 = case.adaptation.sigma0
    fluid, gate = s.fluid, s.gate
    walls = [(case.wall, s.nl_fw), (gate, s.nl_fg)]

    dt_adv = fd.advection_time_step(fluid, h, U_F)
    fluid = fd.density_summation(fluid, s.nl_ff, kernel, dim, RHO0_F, sigma0,
                                 contacts=[(case.wall, s.nl_fw, RHO0_F),
                                           (gate, s.nl_fg, RHO0_S)],
                                 free_surface=True)
    gate = fsi.update_elastic_normal_direction(gate)

    w0 = kernel.w0(dim)
    c0s = case.material_s.sound_speed

    def ac_cond(carry):
        _, _, rt, _, _ = carry
        return rt < dt_adv

    def ac_body(carry):
        f, g, rt, k_ac, k_s = carry
        dt = jnp.minimum(fd.acoustic_time_step(f, case.eos, h), dt_adv)
        walls_now = [(case.wall, s.nl_fw), (g, s.nl_fg)]
        f = fd.acoustic_step_1st_half(f, s.nl_ff, kernel, dim, case.eos,
                                      case.riemann, dt, walls=walls_now)
        g = fsi.pressure_force_from_fluid(g, f, s.nl_gf, kernel, dim,
                                          case.riemann)
        # BOTH halves use the Riemann solver (Integration2ndHalfWithWall
        # Riemann, elastic_gate.cpp:188)
        f = fd.acoustic_step_2nd_half(f, s.nl_ff, kernel, dim, case.riemann,
                                      dt, walls=walls_now)

        g = fsi.initialize_displacement(g)

        def s_cond(sc):
            _, ds_sum, _ = sc
            return ds_sum < dt

        def s_body(sc):
            g_i, ds_sum, k = sc
            dt_s = jnp.minimum(sd.solid_acoustic_time_step(g_i, c0s, h_s),
                               dt - ds_sum)
            g_i = sd.integration_1st_half_pk2(g_i, case.rp, case.material_s,
                                              dt_s, h_s, w0)
            g_i = sd.fix_constraint(g_i, case.clamp_mask)
            g_i = sd.integration_2nd_half(g_i, case.rp, dt_s)
            return (g_i, ds_sum + dt_s, k + 1)

        g, _, k_sub = jax.lax.while_loop(
            s_cond, s_body, (g, jnp.zeros_like(dt), jnp.zeros((), jnp.int32)))
        g = fsi.update_average_velocity_acceleration(g, dt)
        return (f, g, rt + dt, k_ac + 1, k_s + k_sub)

    fluid, gate, relax_t, n_ac, n_s_steps = jax.lax.while_loop(
        ac_cond, ac_body,
        (fluid, gate, jnp.zeros_like(dt_adv), jnp.zeros((), jnp.int32),
         jnp.zeros((), jnp.int32)))

    nl_ff, nl_fw, nl_fg, nl_gf, ovf = rebuild_relations(case, fluid, gate)
    return GateSim(fluid=fluid, gate=gate, nl_ff=nl_ff, nl_fw=nl_fw,
                   nl_fg=nl_fg, nl_gf=nl_gf, time=s.time + relax_t,
                   n_adv=s.n_adv + 1, n_ac=s.n_ac + n_ac,
                   n_s=s.n_s + n_s_steps, overflow=s.overflow | ovf)


def make_run_chunk(case: GateCase):
    @jax.jit
    def run_chunk(s: GateSim, t_target) -> GateSim:
        return jax.lax.while_loop(lambda st: st.time < t_target,
                                  lambda st: _advection_step(case, st), s)

    return run_chunk


def tip_position(case: GateCase, s: GateSim):
    """The observed gate-tip material point (Observer_Position)."""
    return s.gate["Position"][case.tip_idx]
