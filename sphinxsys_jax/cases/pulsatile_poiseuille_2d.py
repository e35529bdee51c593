"""Pulsatile (Womersley) Poiseuille flow driven by pressure boundaries.

Counterpart of /root/reference/tests/extra_source_and_tests/2d_examples/
test_2d_pulsatile_poiseuille_flow/pulsatile_poiseuille_flow.cpp: a 4:1
channel whose flow is driven purely by PRESSURE conditions in
bidirectional buffers at both ends (bidirectional_buffer.h +
pressure_boundary.h) — inlet p = P cos(omega t), outlet p = 0.  The flow
accelerates, stalls, and REVERSES every half period; the bidirectional
buffers inject/delete particles for either flow direction
(physics/boundary.bidirectional_buffer_exchange).

The analytic oracle is the Womersley solution for an oscillatory
pressure gradient G cos(omega t) between plates y = +-R:

    u(y, t) = Re[ (G /(i rho omega)) (1 - cosh(beta y)/cosh(beta R))
                  e^{i omega t} ],   beta = sqrt(i omega / nu)

(`womersley_velocity` below).  Parameters follow the reference's
nondimensional groups (Re = 50 from the steady-Poiseuille scale,
Womersley alpha = R sqrt(omega rho / mu) ~ 1.8); the default geometry is
the reference's dimensional channel (0.004 x 0.001, mm-scale blood
analog) and tests pass scale overrides with the same groups.
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
from sphinxsys_jax.core.state import State, make_fluid_state, make_solid_state
from sphinxsys_jax.neighbors import (build_cell_table, build_neighbor_list,
                                     grid_from_bounds)
from sphinxsys_jax.physics import boundary as bdy
from sphinxsys_jax.physics import fluid as fd
from sphinxsys_jax.physics import riemann as rs
from sphinxsys_jax.physics import windkessel as wk


class SimState(NamedTuple):
    fluid: Any
    nl_inner: Any
    nl_wall: Any
    time: jnp.ndarray
    n_adv: jnp.ndarray
    overflow: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class PulsatileCase:
    dx: float
    dl: float
    dh: float
    rho0: float
    mu: float
    omega: float
    p_amp: float
    u_ref: float
    adaptation: SPHAdaptation
    grid: Any
    eos: WeaklyCompressibleFluid
    riemann: Any
    no_riemann: Any
    wall: State
    wall_table: Any
    buf_l: bdy.AlignedBoxRegion
    buf_r: bdy.AlignedBoxRegion
    n_fluid: int
    cell_cap: int
    k_inner: int
    k_wall: int

    @property
    def kernel(self):
        return self.adaptation.kernel


def build_case(dl: float = 0.004, dh: float = 0.001, rho0: float = 1000.0,
               p_amp: float = 0.1, re: float = 50.0, omega: float = 1.0,
               n_across: int = 20, dtype=jnp.float32, cell_cap: int = 24,
               k_inner: int = 40, k_wall: int = 24,
               reserve_factor: float = 1.6):
    dx = dh / n_across
    # mu from the steady-Poiseuille Re (pulsatile_poiseuille_flow.cpp:34)
    mu = float(np.sqrt(rho0 * (0.5 * dh) ** 3 * p_amp / (re * dl)))
    u_ref = (0.5 * dh) ** 2 * p_amp / (2.0 * mu * dl)
    c_f = 10.0 * u_ref

    adaptation = SPHAdaptation(spacing=dx, dim=2)
    xs = np.arange(dx / 2, dl, dx)
    ys = np.arange(dx / 2, dh, dx)
    pos = np.stack(np.meshgrid(xs, ys, indexing="ij"), -1).reshape(-1, 2)
    n0 = len(pos)
    cap = int(reserve_factor * n0)
    fluid = dict(make_fluid_state(pos, dx * dx, rho0, capacity=cap,
                                  dtype=dtype))
    fluid["Velocity"] = jnp.zeros((cap, 2), dtype)
    fluid = bdy.ensure_alive_mask(fluid)
    fluid["_InjectionOverflow"] = jnp.zeros((), bool)
    fluid["ViscousForce"] = jnp.zeros((cap, 2), dtype)
    fluid["ViscousForcePrev"] = jnp.zeros((cap, 2), dtype)

    bw = 4 * dx
    wx = np.arange(-bw + dx / 2, dl + bw, dx)
    wy = np.arange(dx / 2, bw, dx)
    bot = np.stack(np.meshgrid(wx, -wy, indexing="ij"), -1).reshape(-1, 2)
    top = np.stack(np.meshgrid(wx, dh + wy, indexing="ij"), -1).reshape(-1, 2)
    wpos = np.concatenate([bot, top])
    wall = dict(make_solid_state(wpos, dx * dx, rho0, dtype=dtype))
    normals = np.concatenate([np.tile([0.0, 1.0], (len(bot), 1)),
                              np.tile([0.0, -1.0], (len(top), 1))])
    wall["NormalDirection"] = jnp.asarray(normals, dtype)

    grid = grid_from_bounds((-bw - dx, -(bw + dx)),
                            (dl + bw + dx, dh + bw + dx), adaptation.cutoff)
    wall_table = jax.jit(partial(build_cell_table, grid=grid, cap=cell_cap))(
        wall["Position"], wall["NReal"])

    # 5dx-long bidirectional buffers just inside each end (cpp:40-42)
    buf_l = bdy.AlignedBoxRegion(lower=(0.0, 0.0), upper=(5 * dx, dh))
    buf_r = bdy.AlignedBoxRegion(lower=(dl - 5 * dx, 0.0), upper=(dl, dh))

    eos = WeaklyCompressibleFluid(rho0=rho0, c0=c_f)
    case = PulsatileCase(dx=dx, dl=dl, dh=dh, rho0=rho0, mu=mu, omega=omega,
                         p_amp=p_amp, u_ref=u_ref, adaptation=adaptation,
                         grid=grid, eos=eos, riemann=rs.acoustic_riemann(eos),
                         no_riemann=rs.no_riemann(eos), wall=wall,
                         wall_table=wall_table, buf_l=buf_l, buf_r=buf_r,
                         n_fluid=cap, cell_cap=cell_cap, k_inner=k_inner,
                         k_wall=k_wall)
    return case, fluid


def rebuild_lists(case: PulsatileCase, fluid):
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


def init_sim(case: PulsatileCase, fluid) -> SimState:
    nl, nlw = jax.jit(partial(rebuild_lists, case))(fluid)
    dtype = fluid["Position"].dtype
    return SimState(fluid=fluid, nl_inner=nl, nl_wall=nlw,
                    time=jnp.zeros((), dtype),
                    n_adv=jnp.zeros((), jnp.int32),
                    overflow=jnp.zeros((), bool))


def inlet_pressure(case: PulsatileCase, t):
    """LeftInflowPressure (cpp:52-58): p = P cos(omega t)."""
    return case.p_amp * jnp.cos(case.omega * t)


def _advection_step(case: PulsatileCase, s: SimState) -> SimState:
    kernel, dim = case.kernel, 2
    h = case.adaptation.h
    sigma0 = case.adaptation.sigma0
    fluid = s.fluid
    wall = case.wall
    pos_prev = fluid["Position"]

    dt_adv = fd.advection_viscous_time_step(fluid, h, 2.0 * case.u_ref,
                                            case.rho0, case.mu)
    fluid = fd.density_summation(fluid, s.nl_inner, kernel, dim, case.rho0,
                                 sigma0,
                                 contacts=[(wall, s.nl_wall, case.rho0)],
                                 free_surface=True)
    fluid["Pressure"] = case.eos.pressure(fluid["Density"])
    fluid = fd.viscous_force(fluid, s.nl_inner, kernel, dim, case.mu, h,
                             wall=wall, nl_wall=s.nl_wall)
    x = fluid["Position"][:, 0]
    bulk = (x > 5 * case.dx) & (x < case.dl - 5 * case.dx)
    fluid = fd.transport_velocity_correction(fluid, s.nl_inner, kernel, dim,
                                             h, limiter_slope=100.0,
                                             wall=wall, nl_wall=s.nl_wall,
                                             scope_mask=bulk)

    def ac_body(carry):
        f, rt = carry
        dt = jnp.minimum(fd.acoustic_time_step(f, case.eos, h), dt_adv)
        t_now = s.time + rt
        f = fd.acoustic_step_1st_half(f, s.nl_inner, kernel, dim, case.eos,
                                      case.riemann, dt, wall=wall,
                                      nl_wall=s.nl_wall)
        # pressure conditions in both buffers (cpp:258-260): the reference's
        # PressureCondition::update (pressure_boundary.h:61-72) applies ONLY
        # the truncated-support compensation velocity
        # vel += 2 S_i p_target / rho dt (+ axis alignment) — it does NOT
        # Dirichlet the pressure/density state per substep; the target
        # pressure enters the momentum budget purely through this term.
        p_in = inlet_pressure(case, t_now)
        ksum = wk.kernel_gradient_sum(f, s.nl_inner, kernel, dim,
                                      contacts=[(wall, s.nl_wall)])
        f = wk.pressure_condition_velocity(f, case.buf_l, p_in, dt, ksum)
        f = wk.pressure_condition_velocity(f, case.buf_r, 0.0, dt, ksum)
        f = fd.acoustic_step_2nd_half(f, s.nl_inner, kernel, dim,
                                      case.riemann, dt, wall=wall,
                                      nl_wall=s.nl_wall)
        return (f, rt + dt)

    fluid, relax_t = jax.lax.while_loop(
        lambda c: c[1] < dt_adv, ac_body, (fluid, jnp.zeros_like(dt_adv)))

    fluid = bdy.bidirectional_buffer_exchange(fluid, case.buf_l, inward=+1,
                                              prev_pos=pos_prev)
    fluid = bdy.bidirectional_buffer_exchange(fluid, case.buf_r, inward=-1,
                                              prev_pos=pos_prev)

    nl, nlw = rebuild_lists(case, fluid)
    return SimState(fluid=fluid, nl_inner=nl, nl_wall=nlw,
                    time=s.time + relax_t, n_adv=s.n_adv + 1,
                    overflow=s.overflow | nl.overflow | nlw.overflow
                    | fluid["_InjectionOverflow"])


def make_run_chunk(case: PulsatileCase):
    @jax.jit
    def run_chunk(s: SimState, t_target) -> SimState:
        return jax.lax.while_loop(lambda st: st.time < t_target,
                                  lambda st: _advection_step(case, st), s)

    return run_chunk


def womersley_velocity(case: PulsatileCase, y, t):
    """Analytic oscillatory-channel solution for dp/dx = -G cos(omega t)
    with G = p_amp / dl, y measured from the centerline."""
    nu = case.mu / case.rho0
    R = 0.5 * case.dh
    G = case.p_amp / case.dl
    beta = np.sqrt(1j * case.omega / nu)
    u_hat = (G / (1j * case.rho0 * case.omega)) * \
        (1.0 - np.cosh(beta * np.asarray(y)) / np.cosh(beta * R))
    return np.real(u_hat * np.exp(1j * case.omega * np.asarray(t)))


def womersley_startup_velocity(case: PulsatileCase, y, t, n_modes=80):
    """EXACT start-from-rest solution of du/dt = (G/rho) cos(omega t)
    + nu u_yy, u(+-R) = 0, u(y, 0) = 0 — eigenmode series
    u = sum_k a_k(t) cos(lambda_k y), lambda_k = (2k+1) pi / (2R),
    a_k' = -nu lambda_k^2 a_k + (G c_k / rho) cos(omega t).  Valid at any
    time, including the viscous startup transient the plain Womersley
    solution excludes."""
    nu = case.mu / case.rho0
    R = 0.5 * case.dh
    G = case.p_amp / case.dl
    w = case.omega
    y = np.asarray(y)
    u = np.zeros_like(y, dtype=float)
    for k in range(n_modes):
        lam = (2 * k + 1) * np.pi / (2.0 * R)
        c_k = 4.0 * (-1.0) ** k / ((2 * k + 1) * np.pi)
        kap = nu * lam * lam
        a_k = (G * c_k / case.rho0) * (
            kap * np.cos(w * t) + w * np.sin(w * t)
            - kap * np.exp(-kap * t)) / (kap * kap + w * w)
        u = u + a_k * np.cos(lam * y)
    return u


def centerline_velocity(case: PulsatileCase, s: SimState) -> float:
    pos = np.asarray(s.fluid["Position"])
    vel = np.asarray(s.fluid["Velocity"])
    alive = np.asarray(s.fluid["Alive"])
    mid = alive & (np.abs(pos[:, 1] - 0.5 * case.dh) < case.dx) \
        & (np.abs(pos[:, 0] - 0.5 * case.dl) < 0.2 * case.dl)
    return float(vel[mid, 0].mean())


def n_alive(s: SimState) -> int:
    return int(np.asarray(s.fluid["Alive"]).sum())
