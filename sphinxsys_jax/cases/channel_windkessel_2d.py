"""Pulsatile channel flow with a 3-element windkessel outlet.

Counterpart of tests/extra_source_and_tests/2d_examples/
test_2d_channel_windkessel_rigid_shell/channel_windkessel_rigid_shell.cpp:
channel DH = 6.35 mm, DL = 5 DH, rho = 1000, c = 10 (INVISCID — the
reference runs no viscous force), physiological 8-harmonic inflow waveform
imposed in the left buffer (cpp:96-123), windkessel RCR outlet
(Rp = 1.52e6, C = 1.96e-7, Rd = 6.85e6, baseline 80 mmHg, pressure update
every 0.02 s) imposed in the right buffer, open ends via
emitter/disposer recycling.

Deviation: the reference's rigid SHELL wall (single row of surface
particles, never integrated) is replaced by the equivalent rigid dummy
wall bank; both are static no-slip boundaries for the fluid.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from sphinxsys_jax.core.adaptation import SPHAdaptation
from sphinxsys_jax.core.materials import WeaklyCompressibleFluid
from sphinxsys_jax.core.state import make_fluid_state, make_solid_state
from sphinxsys_jax.neighbors import (build_cell_table, build_neighbor_list,
                                     grid_from_bounds)
from sphinxsys_jax.physics import boundary as bdy
from sphinxsys_jax.physics import fluid as fd
from sphinxsys_jax.physics import riemann as rs
from sphinxsys_jax.physics import windkessel as wk

SCALE = 0.001
DH = 6.35 * SCALE
DL = 5.0 * DH
RHO0_F = 1000.0
U_MAX = 1.0
C_F = 10.0 * U_MAX
# windkessel parameters (cpp:275)
RP, CAP_C, RD = 1.52e6, 1.96e-7, 6.85e6
P_BASE = 80.0 * 133.32
WK_DT = 0.02               # accumulated_time (cpp:259)

# physiological waveform coefficients (cpp:108-110)
WAVE_A = np.asarray([-0.0176, -0.0657, -0.0280, 0.0068,
                     0.0075, 0.0115, 0.0040, 0.0035])
WAVE_B = np.asarray([0.1205, 0.0171, -0.0384, -0.0152,
                     -0.0122, 0.0002, 0.0033, 0.0060])
U_AVE0 = 0.2339


def inflow_velocity(t):
    """InflowVelocity::operator() (cpp:104-123): the mean is accumulated
    harmonic-by-harmonic with a zero clamp after each term."""
    u = jnp.asarray(U_AVE0, jnp.result_type(t, jnp.float32))
    w = 2.0 * jnp.pi / 1.0
    for i in range(8):
        theta = w * (i + 1) * t
        u = jnp.maximum(u + WAVE_A[i] * jnp.cos(theta)
                        + WAVE_B[i] * jnp.sin(theta), 0.0)
    return u


class SimState(NamedTuple):
    fluid: Any
    nl_inner: Any
    nl_wall: Any
    wkstate: Any
    next_update: jnp.ndarray
    time: jnp.ndarray
    n_adv: jnp.ndarray
    n_ac: jnp.ndarray
    overflow: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class WindkesselCase:
    dx: float
    adaptation: SPHAdaptation
    grid: Any
    eos: WeaklyCompressibleFluid
    riemann: Any
    wall: Any
    wall_table: Any
    emitter: bdy.AlignedBoxRegion
    inlet: bdy.AlignedBoxRegion
    outlet: bdy.AlignedBoxRegion
    disposer: bdy.AlignedBoxRegion
    n_fluid: int
    cell_cap: int
    k_inner: int
    k_wall: int

    @property
    def kernel(self):
        return self.adaptation.kernel


def build_case(dx: float = DH / 15.0, dtype=jnp.float32, cell_cap: int = 24,
               k_inner: int = 40, k_wall: int = 24,
               reserve_factor: float = 1.5):
    adaptation = SPHAdaptation(spacing=dx, dim=2)
    sponge = 4.0 * dx
    xs = np.arange(-sponge + dx / 2, DL, dx)
    ys = np.arange(dx / 2, DH, dx)
    pos = np.stack(np.meshgrid(xs, ys, indexing="ij"), -1).reshape(-1, 2)
    n0 = len(pos)
    cap = int(reserve_factor * n0)
    fluid = dict(make_fluid_state(pos, dx * dx, RHO0_F, capacity=cap,
                                  dtype=dtype))
    # start from rest — the inflow condition fills the channel (impulsive
    # uniform velocity against the no-slip walls kicks a startup shock)
    fluid["Velocity"] = jnp.zeros((cap, 2), dtype)
    fluid = bdy.ensure_alive_mask(fluid)
    fluid["_InjectionOverflow"] = jnp.zeros((), bool)  # stable loop pytree

    # walls above/below the full channel span
    wx = np.arange(-sponge - 4 * dx + dx / 2, DL + 4 * dx, dx)
    wy = np.arange(dx / 2, 4 * dx, dx)
    bot = np.stack(np.meshgrid(wx, -wy, indexing="ij"), -1).reshape(-1, 2)
    top = np.stack(np.meshgrid(wx, DH + wy, indexing="ij"), -1).reshape(-1, 2)
    wpos = np.concatenate([bot, top])
    wall = dict(make_solid_state(wpos, dx * dx, RHO0_F, dtype=dtype))
    normals = np.concatenate([np.tile([0.0, 1.0], (len(bot), 1)),
                              np.tile([0.0, -1.0], (len(top), 1))])
    wall["NormalDirection"] = jnp.asarray(normals, dtype)

    grid = grid_from_bounds((-sponge - 5 * dx, -(4.5 * dx)),
                            (DL + 5 * dx, DH + 4.5 * dx), adaptation.cutoff)
    wall_table = jax.jit(partial(build_cell_table, grid=grid, cap=cell_cap))(
        wall["Position"], wall["NReal"])

    emitter = bdy.AlignedBoxRegion(lower=(-sponge, 0.0), upper=(0.0, DH))
    inlet = bdy.AlignedBoxRegion(lower=(-sponge, 0.0), upper=(0.0, DH))
    outlet = bdy.AlignedBoxRegion(lower=(DL - 4 * dx, 0.0), upper=(DL, DH))
    disposer = bdy.AlignedBoxRegion(lower=(DL, -dx), upper=(DL + 6 * dx, DH + dx))

    eos = WeaklyCompressibleFluid(rho0=RHO0_F, c0=C_F)
    case = WindkesselCase(dx=dx, adaptation=adaptation, grid=grid, eos=eos,
                          riemann=rs.acoustic_riemann(eos), wall=wall,
                          wall_table=wall_table, emitter=emitter, inlet=inlet,
                          outlet=outlet, disposer=disposer, n_fluid=cap,
                          cell_cap=cell_cap, k_inner=k_inner, k_wall=k_wall)
    return case, fluid


def rebuild_lists(case: WindkesselCase, fluid):
    pos = fluid["Position"]
    alive = fluid["Alive"]
    table = build_cell_table(pos, alive, case.grid, cap=case.cell_cap)
    nl = build_neighbor_list(pos, alive, pos, alive, table, case.grid,
                             case.adaptation.cutoff, k_max=case.k_inner,
                             include_self=False)
    nlw = build_neighbor_list(pos, alive, case.wall["Position"],
                              case.wall["NReal"], case.wall_table, case.grid,
                              case.adaptation.cutoff, k_max=case.k_wall,
                              include_self=False)
    return nl, nlw


def init_sim(case: WindkesselCase, fluid) -> SimState:
    nl, nlw = jax.jit(partial(rebuild_lists, case))(fluid)
    dtype = fluid["Position"].dtype
    return SimState(fluid=fluid, nl_inner=nl, nl_wall=nlw,
                    wkstate=wk.init_windkessel(P_BASE, dtype),
                    next_update=jnp.asarray(WK_DT, dtype),
                    time=jnp.zeros((), dtype),
                    n_adv=jnp.zeros((), jnp.int32),
                    n_ac=jnp.zeros((), jnp.int32),
                    overflow=jnp.zeros((), bool))


def _advection_step(case: WindkesselCase, s: SimState) -> SimState:
    kernel, dim = case.kernel, 2
    h = case.adaptation.h
    sigma0 = case.adaptation.sigma0
    fluid = s.fluid
    wall = case.wall
    pos_prev = fluid["Position"]

    dt_adv = fd.advection_time_step(fluid, h, U_MAX)
    # free-surface clamped summation: the OPEN ends have truncated kernel
    # support; without the clamp their rho_sum ~ 0.85 rho0 turns into a
    # large negative pressure and the channel implodes (the reference's
    # DensitySummationPressureComplex corrects these against the imposed
    # buffer pressure, cpp:218)
    fluid = fd.density_summation(fluid, s.nl_inner, kernel, dim, RHO0_F,
                                 sigma0,
                                 contacts=[(wall, s.nl_wall, RHO0_F)],
                                 free_surface=True)
    fluid["Pressure"] = case.eos.pressure(fluid["Density"])
    # TVC on bulk particles only (TransportVelocityCorrectionComplex
    # <BulkParticles>, cpp:207): open-end particles must not be shifted
    x = fluid["Position"][:, 0]
    bulk = (x > 2 * case.dx) & (x < DL - 6 * case.dx)
    fluid = fd.transport_velocity_correction(fluid, s.nl_inner, kernel, dim,
                                             h, limiter_slope=100.0,
                                             wall=wall, nl_wall=s.nl_wall,
                                             scope_mask=bulk)

    def ac_cond(carry):
        _, wkst, nxt, rt, _ = carry
        return rt < dt_adv

    def ac_body(carry):
        f, wkst, nxt, rt, k = carry
        dt = jnp.minimum(fd.acoustic_time_step(f, case.eos, h), dt_adv)
        t_now = s.time + rt
        f = fd.acoustic_step_1st_half(f, s.nl_inner, kernel, dim, case.eos,
                                      case.riemann, dt, wall=wall,
                                      nl_wall=s.nl_wall)
        # inflow velocity condition in the left buffer (cpp:220)
        u_in = inflow_velocity(t_now)
        in_l = case.inlet.contains(f["Position"]) & f["Alive"]
        vel = f["Velocity"]
        vel = jnp.where(in_l[:, None],
                        jnp.stack([jnp.full_like(vel[:, 0], u_in),
                                   jnp.zeros_like(vel[:, 1])], -1), vel)
        f = dict(f)
        f["Velocity"] = vel
        # inlet buffer carries the reference state (the reference's
        # bidirectional buffer re-initializes injected particles and its
        # pressure condition keeps the buffer at the summed bulk pressure;
        # the full-state reset is the emitter-style equivalent)
        f["Density"] = jnp.where(in_l, RHO0_F, f["Density"])
        f["Pressure"] = jnp.where(in_l, 0.0, f["Pressure"])
        f["DensityChangeRate"] = jnp.where(in_l, 0.0, f["DensityChangeRate"])
        # windkessel pressure in the right buffer (cpp:219)
        f = wk.impose_pressure_condition(f, case.outlet,
                                         wkst.p - P_BASE, case.eos)
        f = fd.acoustic_step_2nd_half(f, s.nl_inner, kernel, dim,
                                      case.riemann, dt, wall=wall,
                                      nl_wall=s.nl_wall)
        wkst = wk.accumulate_flow(wkst, f, case.outlet, 0, dt)
        do_update = (t_now + dt) >= nxt
        wk_new = wk.windkessel_update(wkst, jnp.asarray(WK_DT, dt.dtype),
                                      RP, CAP_C, RD)
        wkst = jax.tree_util.tree_map(
            lambda a, b: jnp.where(do_update, b, a), wkst, wk_new)
        nxt = jnp.where(do_update, nxt + WK_DT, nxt)
        return (f, wkst, nxt, rt + dt, k + 1)

    fluid, wkstate, next_update, relax_t, n_ac = jax.lax.while_loop(
        ac_cond, ac_body,
        (fluid, s.wkstate, s.next_update, jnp.zeros_like(dt_adv),
         jnp.zeros((), jnp.int32)))

    fluid = bdy.disposer_outflow_deletion(fluid, case.disposer)
    fluid = bdy.emitter_inflow_injection(fluid, case.emitter,
                                         prev_pos=pos_prev)
    nl, nlw = rebuild_lists(case, fluid)
    return SimState(fluid=fluid, nl_inner=nl, nl_wall=nlw, wkstate=wkstate,
                    next_update=next_update, time=s.time + relax_t,
                    n_adv=s.n_adv + 1, n_ac=s.n_ac + n_ac,
                    overflow=s.overflow | nl.overflow | nlw.overflow)


def make_run_chunk(case: WindkesselCase):
    @jax.jit
    def run_chunk(s: SimState, t_target) -> SimState:
        return jax.lax.while_loop(lambda st: st.time < t_target,
                                  lambda st: _advection_step(case, st), s)

    return run_chunk


def outlet_pressure_mmhg(s: SimState) -> float:
    return float(s.wkstate.p) / 133.32
