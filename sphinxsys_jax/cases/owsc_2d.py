"""Oscillating wave surge converter (OWSC) — the reference's full scene.

Counterpart of /root/reference/tests/2d_examples/test_2d_owsc/owsc.{h,cpp}:
an 18.42 m wave tank with a PISTON WAVEMAKER at the left end
(BodyRegionByParticle of the wall, prescribed Biesel first-order stroke for
the Froude-scaled 5 m / 10 s target wave at scale 1:25 — owsc.h:261-334), a
sloped berm carrying a base pedestal, and a bottom-pinned buoyant flap
(mass 33.04, pin at (7.92, 0.315), SimTK::MobilizedBody::Pin) with a linear
power-take-off damper on the joint (MobilityLinearDamper, c = 20,
owsc.cpp:158).  A quadratic damping zone over the last 5 m absorbs the
transmitted wave (DampingBoundaryCondition).

Deviations from the reference (documented, physics-preserving):
  * the flap's rounded bottom (10-point semicircle polygon, owsc.h:110-117)
    is the CSG union box + pin-centred ball;
  * rigid coupling is the native pin-joint solver (physics/rigid.py), not
    Simbody — same single-DOF dynamics I d(omega)/dt = tau_fluid +
    tau_gravity - c omega (the reference has no joint spring: buoyancy
    restores the flap);
  * the protocol matches owsc.cpp:229-269: wavemaker + flap frozen for
    total_time < relax_time = 1 s, physical clock starts at release.

Observables: flap pitch angle (the reference writes WriteSimBodyPinData),
total viscous force on the flap (its DTW regression quantity), PTO energy.
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
from sphinxsys_jax.core.state import State, make_fluid_state, make_solid_state
from sphinxsys_jax.neighbors import (build_cell_table, build_neighbor_list,
                                     grid_from_bounds)
from sphinxsys_jax.physics import fluid as fd
from sphinxsys_jax.physics import fsi
from sphinxsys_jax.physics import general as gd
from sphinxsys_jax.physics import riemann as rs
from sphinxsys_jax.physics import rigid as rg
from sphinxsys_jax.physics import wavemaker as wm

# owsc.h:17-72
DL = 18.42
DH = 1.0
DL_EXTRA = 1.0
WATER_H = 0.691
FLAP_WIDTH = 0.12
FLAP_X = 7.92
FLAP_H = 0.48
BASE_BOTTOM = 0.155
BASE_HEIGHT = 0.1
GRAVITY_G = 9.81
RHO0_F = 1000.0
U_REF = 2.0 * math.sqrt(0.79 * GRAVITY_G)
C_F = 10.0 * U_REF
MU_F = 1.0e-6
FLAP_MASS = 33.04
FLAP_VOLUME = 0.0579
RHO0_S = FLAP_MASS / FLAP_VOLUME
PTO_DAMPING = 20.0                       # MobilityLinearDamper (owsc.cpp:158)
PIN = (FLAP_X, BASE_BOTTOM + BASE_HEIGHT + 0.5 * FLAP_WIDTH)  # (7.92, 0.315)
RELAX_TIME = 1.0

# wave target: 5 m / 10 s at model scale 25 (owsc.h:328-330)
WAVE_HEIGHT, WAVE_PERIOD, MODEL_SCALE = 5.0, 10.0, 25.0

# berm profile (owsc.h:40-46)
SLOPE_1 = (DL - 6.2, 0.356)
SLOPE_2 = (DL - 6.2 - 3.7, 0.155)
SLOPE_3 = (DL - 6.2 - 3.7 - 2.4, 0.155)
SLOPE_4 = (DL - 6.2 - 3.7 - 2.4 - 1.3, 0.0)


class SimState(NamedTuple):
    fluid: Any
    wall: Any
    flap: Any
    pj: Any
    pto_energy: jnp.ndarray
    visc_force: jnp.ndarray     # total viscous force on flap (DTW quantity)
    nl_inner: Any
    nl_fw: Any
    nl_ff: Any
    nl_bf: Any
    time: jnp.ndarray           # physical time (starts after RELAX_TIME)
    total_time: jnp.ndarray
    n_adv: jnp.ndarray
    overflow: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class OWSCCase:
    dx: float
    adaptation: SPHAdaptation
    grid: Any
    eos: WeaklyCompressibleFluid
    riemann: Any
    gravity: Any
    wall0: Any
    maker_mask: Any
    piston: wm.PistonMotion
    flap0: Any
    pj0: Any
    n_fluid: int
    n_flap: int
    cell_cap: int
    k_inner: int
    k_contact: int

    @property
    def kernel(self):
        return self.adaptation.kernel


def _water_shape(flap_shape, base_shape):
    poly = G.Polygon(vertices=(
        (0.0, 0.0), (0.0, WATER_H), (DL, WATER_H), (DL, 0.356),
        SLOPE_1, SLOPE_2, SLOPE_3, SLOPE_4))
    return G.make_complex(("add", poly), ("sub", flap_shape),
                          ("sub", base_shape))


def build_case(dx: float = FLAP_WIDTH / 4.0, dtype=jnp.float32,
               cell_cap: int = 24, k_inner: int = 64, k_contact: int = 40):
    bw = 4 * dx
    adaptation = SPHAdaptation(spacing=dx, dim=2)

    base_shape = G.Box(
        G.Transform(translation=(FLAP_X, BASE_BOTTOM + BASE_HEIGHT / 2)),
        halfsize=(FLAP_WIDTH / 2, BASE_HEIGHT / 2))
    flap_box = G.Box(
        G.Transform(translation=(FLAP_X, PIN[1] + FLAP_H / 2)),
        halfsize=(FLAP_WIDTH / 2, FLAP_H / 2))
    flap_shape = G.make_complex(
        ("add", flap_box),
        ("add", G.Ball(center=PIN, radius=FLAP_WIDTH / 2)))

    outer = G.Polygon(vertices=(
        (-DL_EXTRA - bw, -bw), (-DL_EXTRA - bw, DH + bw),
        (DL + bw, DH + bw), (DL + bw, 0.35 - bw),
        (SLOPE_1[0], SLOPE_1[1] - bw), (SLOPE_2[0], SLOPE_2[1] - bw),
        (SLOPE_3[0], SLOPE_3[1] - bw), (SLOPE_4[0], SLOPE_4[1] - bw)))
    inner01 = G.Polygon(vertices=(
        (0.0, 0.0), (0.0, DH + bw), (DL, DH + bw), (DL, 0.356),
        SLOPE_1, SLOPE_2, SLOPE_3, SLOPE_4))
    inner02 = G.Box(
        G.Transform(translation=(-(DL_EXTRA + bw) / 2, (DH + bw) / 2)),
        halfsize=((DL_EXTRA - bw) / 2, (DH + bw) / 2))
    wall_shape = G.make_complex(("add", outer), ("sub", inner01),
                                ("sub", inner02), ("add", base_shape))

    dom_lo = (-DL_EXTRA - bw, -bw)
    dom_hi = (DL + bw, DH + bw)
    water_shape = _water_shape(flap_shape, base_shape)
    pos_f, vol = generate_lattice(water_shape, dom_lo, dom_hi, dx)
    pos_w, _ = generate_lattice(wall_shape, dom_lo, dom_hi, dx)
    pos_b, _ = generate_lattice(flap_shape, dom_lo, dom_hi, dx)

    fluid = dict(make_fluid_state(pos_f, vol, RHO0_F, dtype=dtype))
    eos = WeaklyCompressibleFluid(rho0=RHO0_F, c0=C_F)
    p_hydro = np.maximum(
        RHO0_F * GRAVITY_G * (WATER_H - np.asarray(pos_f)[:, 1]), 0.0)
    fluid["Density"] = jnp.asarray(
        np.asarray(eos.density_from_pressure(jnp.asarray(p_hydro))), dtype)
    fluid["Pressure"] = jnp.asarray(p_hydro, dtype)
    n = fluid["Position"].shape[0]
    fluid["ViscousForce"] = jnp.zeros((n, 2), dtype)
    fluid["ViscousForcePrev"] = jnp.zeros((n, 2), dtype)
    # opt into gravity_force's BaseForcePrior delta form (coexists with
    # the viscous prior force; see physics/general.py gravity_force)
    fluid["GravityForcePrev"] = jnp.zeros((n, 2), dtype)

    wall = dict(make_solid_state(pos_w, vol, RHO0_F, dtype=dtype))
    wall = gd.normal_direction_from_shape(wall, wall_shape)
    wall["InitialPosition"] = wall["Position"]
    # wavemaker region: the column -BW < x < 0 (createWaveMakerShape)
    xw, yw = pos_w[:, 0], pos_w[:, 1]
    maker_mask = jnp.asarray((xw > -bw) & (xw < 0.0) & (yw > 0.0))

    flap = dict(make_solid_state(pos_b, vol, RHO0_S, dtype=dtype))
    flap = gd.normal_direction_from_shape(flap, flap_shape)
    flap["InitialPosition"] = flap["Position"]
    for key in ("PressureForceFromFluid", "ViscousForceFromFluid"):
        flap[key] = jnp.zeros_like(flap["Position"])
        flap["Previous" + key] = jnp.zeros_like(flap["Position"])
    flap["ForcePrior"] = jnp.zeros_like(flap["Position"])
    flap["Force"] = jnp.zeros_like(flap["Position"])
    flap["AverageAcceleration"] = jnp.zeros_like(flap["Position"])

    mask = jnp.ones((len(pos_b),), bool)
    pj0 = rg.pin_joint_from_particles(flap, mask, PIN)
    # impose the reference's exact flap mass (lattice volume differs a bit)
    scale = FLAP_MASS / float(pj0.mass)
    flap["Mass"] = flap["Mass"] * scale
    pj0 = rg.pin_joint_from_particles(flap, mask, PIN)

    piston = wm.make_piston(WAVE_HEIGHT, WAVE_PERIOD, WATER_H, GRAVITY_G,
                            model_scale=MODEL_SCALE)

    gravity = gd.Gravity(acceleration=(0.0, -GRAVITY_G))
    fluid = gd.gravity_force(fluid, gravity)
    grid = grid_from_bounds(dom_lo, dom_hi, adaptation.cutoff)

    case = OWSCCase(dx=dx, adaptation=adaptation, grid=grid, eos=eos,
                    riemann=rs.acoustic_riemann(eos), gravity=gravity,
                    wall0=wall, maker_mask=maker_mask, piston=piston,
                    flap0=flap, pj0=pj0, n_fluid=len(pos_f),
                    n_flap=len(pos_b), cell_cap=cell_cap, k_inner=k_inner,
                    k_contact=k_contact)
    return case, fluid


def rebuild(case: OWSCCase, fluid: State, wall: State, flap: State):
    pos = fluid["Position"]
    n_f, n_b = fluid["NReal"], flap["NReal"]
    cutoff = case.adaptation.cutoff
    table_f = build_cell_table(pos, n_f, case.grid, cap=case.cell_cap)
    table_w = build_cell_table(wall["Position"], wall["NReal"], case.grid,
                               cap=case.cell_cap)
    table_b = build_cell_table(flap["Position"], n_b, case.grid,
                               cap=case.cell_cap)
    nl_inner = build_neighbor_list(pos, n_f, pos, n_f, table_f, case.grid,
                                   cutoff, k_max=case.k_inner,
                                   include_self=False)
    nl_fw = build_neighbor_list(pos, n_f, wall["Position"], wall["NReal"],
                                table_w, case.grid, cutoff,
                                k_max=case.k_contact, include_self=True)
    nl_ff = build_neighbor_list(pos, n_f, flap["Position"], n_b, table_b,
                                case.grid, cutoff, k_max=case.k_contact,
                                include_self=True)
    nl_bf = build_neighbor_list(flap["Position"], n_b, pos, n_f, table_f,
                                case.grid, cutoff, k_max=case.k_contact,
                                include_self=True)
    ovf = nl_inner.overflow | nl_fw.overflow | nl_ff.overflow | nl_bf.overflow
    return nl_inner, nl_fw, nl_ff, nl_bf, ovf


def init_sim(case: OWSCCase, fluid: State) -> SimState:
    wall, flap = case.wall0, case.flap0
    nls = jax.jit(partial(rebuild, case))(fluid, wall, flap)
    dtype = fluid["Position"].dtype
    z = jnp.zeros((), dtype)
    return SimState(fluid=fluid, wall=wall, flap=flap, pj=case.pj0,
                    pto_energy=z, visc_force=jnp.zeros((2,), dtype),
                    nl_inner=nls[0], nl_fw=nls[1], nl_ff=nls[2], nl_bf=nls[3],
                    time=z, total_time=z, n_adv=jnp.zeros((), jnp.int32),
                    overflow=nls[4])


def _advection_step(case: OWSCCase, s: SimState) -> SimState:
    kernel, dim = case.kernel, 2
    h = case.adaptation.h
    sigma0 = case.adaptation.sigma0
    fluid, wall, flap, pj = s.fluid, s.wall, s.flap, s.pj
    mask_b = jnp.ones((case.n_flap,), bool)

    dt_adv = fd.advection_viscous_time_step(fluid, h, U_REF, RHO0_F, MU_F)
    fluid = fd.density_summation(
        fluid, s.nl_inner, kernel, dim, RHO0_F, sigma0,
        contacts=[(wall, s.nl_fw, RHO0_F), (flap, s.nl_ff, RHO0_F)],
        free_surface=True)
    fluid = fd.viscous_force(fluid, s.nl_inner, kernel, dim, MU_F, h,
                             walls=[(wall, s.nl_fw), (flap, s.nl_ff)])
    flap = fsi.viscous_force_from_fluid(flap, fluid, s.nl_bf, kernel, dim,
                                        MU_F, h)
    visc_total = jnp.sum(flap["ViscousForceFromFluid"], axis=0)

    def ac_cond(carry):
        return carry[-1] < dt_adv

    def ac_body(carry):
        f, w, b, p, e_pto, tt, rt = carry
        dt = jnp.minimum(fd.acoustic_time_step(f, case.eos, h), dt_adv)
        released = tt >= RELAX_TIME
        walls = [(w, s.nl_fw), (b, s.nl_ff)]
        f = fd.acoustic_step_1st_half(f, s.nl_inner, kernel, dim, case.eos,
                                      case.riemann, dt, walls=walls)
        b = fsi.pressure_force_from_fluid(b, f, s.nl_bf, kernel, dim,
                                          case.riemann)
        # pin-joint update (owsc.cpp:253-262), gated by the release switch
        torque = rg.pin_torque(b, mask_b, p,
                               force_keys=("ForcePrior",))
        p_new = rg.pin_joint_step(p, torque, dt, damping=PTO_DAMPING,
                                  gravity=(0.0, -GRAVITY_G))
        p_new = jax.tree.map(lambda a, b_: jnp.where(released, a, b_),
                             p_new, p)
        b = rg.constrain_by_pin_joint(b, mask_b, p_new,
                                      case.flap0["InitialPosition"])
        acc_scale = (p_new.omega - p.omega) / (dt + 1e-15)
        r = b["Position"] - jnp.asarray(PIN, f["Position"].dtype)
        acc = acc_scale[..., None] * jnp.stack([-r[:, 1], r[:, 0]], axis=-1)
        b = dict(b)
        b["AverageAcceleration"] = acc
        # piston wavemaker — NOT executed during the settling window
        # (owsc.cpp:254-262: wave_making only once total_time >= relax_time,
        # driven by the physical clock which starts at release)
        t_wave = jnp.maximum(tt - RELAX_TIME, 0.0)
        w_moved = wm.apply_wavemaker(w, case.maker_mask, case.piston, t_wave)
        w = jax.tree.map(lambda a, b_: jnp.where(released, a, b_), w_moved, w)
        f = fd.acoustic_step_2nd_half(f, s.nl_inner, kernel, dim,
                                      case.riemann, dt,
                                      walls=[(w, s.nl_fw), (b, s.nl_ff)])
        e_pto = e_pto + PTO_DAMPING * p_new.omega ** 2 * dt
        return (f, w, b, p_new, e_pto, tt + dt, rt + dt)

    fluid, wall, flap, pj, pto_energy, total_time, relax_t = \
        jax.lax.while_loop(ac_cond, ac_body,
                           (fluid, wall, flap, pj, s.pto_energy,
                            s.total_time, jnp.zeros_like(dt_adv)))

    # damping zone over the last 5 m (damping_wave.exec(Dt), owsc.cpp:282)
    dz_mask = fluid["Position"][:, 0] > (DL - 5.0)
    fluid = wm.damping_zone(fluid, dz_mask, DL - 5.0, DL + 4 * case.dx,
                            dt_adv)

    nls = rebuild(case, fluid, wall, flap)
    return SimState(fluid=fluid, wall=wall, flap=flap, pj=pj,
                    pto_energy=pto_energy, visc_force=visc_total,
                    nl_inner=nls[0], nl_fw=nls[1], nl_ff=nls[2], nl_bf=nls[3],
                    time=jnp.maximum(total_time - RELAX_TIME, 0.0),
                    total_time=total_time, n_adv=s.n_adv + 1,
                    overflow=s.overflow | nls[4])


def make_run_chunk(case: OWSCCase):
    @jax.jit
    def run_chunk(s: SimState, t_target) -> SimState:
        return jax.lax.while_loop(lambda st: st.time < t_target,
                                  lambda st: _advection_step(case, st), s)

    return run_chunk


def flap_angle_deg(s: SimState) -> float:
    return float(s.pj.theta) * 180.0 / np.pi
