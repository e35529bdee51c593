"""Nonlinear focused-wave impact on a tension-leg moored floating structure.

Counterpart of /root/reference/tests/2d_examples/test_2d_nonlinear_wave_fsi/
nonlinear_wave_fsi.{h,cpp} (author Nicolò Salis): a 35 m wave tank with a
piston wavemaker driving a 32-component FOCUSED wave packet (focus x = 12,
t = 20.48; components f in [0.32, 0.96] Hz, a = 0.0068 — the h:425-539
WaveMaking constraint), a 1:10 beach from x = 15, and a floating structure
(baseplate + two pillars + top plate, mass 62.036) held down against its
buoyancy excess by two TAUT tether cable-springs (SimTK::CableSpring,
k = 3.163e5, rest length = the initial cable length, damper 2 —
cpp:128-139) anchored on the tank floor.

Composition on the native stack:
  * wavemaker: physics/wavemaker.py FocusedPacketMotion on a wall body
    part (same frozen-until-relax_time protocol, cpp:261-269);
  * rigid coupling: native 3-DOF planar rigid solver (physics/rigid.py)
    with the reference's exact mass/inertia (h:124-198), replacing the
    Simbody Planar mobilizer;
  * tethers: tension-only cable springs T = max(0, k s (1 + c s_dot))
    (the SimTK::CableSpring force law) applied at the two baseplate
    attachment points, so the structure is a tension-leg platform: at
    rest the buoyancy excess stretches the tethers by ~2 mm;
  * fluid: WCSPH with the kernel-corrected pressure integration
    (Integration1stHalfCorrectionWithWallRiemann, cpp:86-88) + viscous
    force, free-surface density summation.

Observables (reference DTW quantities, cpp:189-199): structure observer
displacement (= the rigid com trajectory) and the fp2 pressure probe that
RIDES the structure (position rigidly advected, pressure interpolated from
the fluid).
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

# nonlinear_wave_fsi.h:12-29
DL = 35.0
DH = 2.0
WL = 20.0
WH = 0.8
TB = 15.0          # beach start
DB = 25.0          # beach end x (height 1.0 there)
BEH = 2.0
EXS = 2.0
PLATE_H = 0.12
DX_REF = PLATE_H / 4.0
GRAVITY_G = 9.81
RHO0_F = 1000.0
U_F = 2.0 * math.sqrt(0.79 * GRAVITY_G)
C_F = 10.0 * U_F
MU_F = 1.0e-3
RELAX_TIME = 1.0

# structure boxes (h:52-93)
BP = (12.286, 0.573, 1.3, 0.12)     # x, y, l, h
SSP = (BP[0] + 0.25, BP[1] + BP[3], 0.2, 0.24)
PSP = (BP[0] + BP[2] - 0.45, BP[1] + BP[3], 0.2, 0.24)
TP = (BP[0] + 0.18, BP[1] + 0.36, 0.94, 0.11)
STRUCTURE_MASS = 62.036

# tethers (h:99-109, cpp:128-139)
CABLE_K = 3.163e5
CABLE_DAMP = 2.0
CX_A = BP[0] + 0.35
CX_B = BP[0] + BP[2] - 0.35
CY = BP[1]

# focused packet (h:544: h=WH, tf=20.480, xf=12.0, f in [0.32,0.96],
# a=0.0068, N=32)
PACKET = dict(depth=WH, tf=20.480, xf=12.0, fmin=0.32, fmax=0.96,
              amplitude=0.0068, n_components=32, g=GRAVITY_G)

X_GAUGE = 10.848
FP2 = (12.466, 0.968)


def _structure_mass_properties():
    """Composite G and Iz about G (h:124-198)."""
    boxes = [BP, SSP, PSP, TP]
    areas = np.array([b[2] * b[3] for b in boxes])
    area = areas.sum()
    rho = STRUCTURE_MASS / area
    cms = np.array([[b[0] + b[2] / 2, b[1] + b[3] / 2] for b in boxes])
    m = rho * areas
    G_cm = (m[:, None] * cms).sum(0) / m.sum()
    iz_own = m / 12.0 * np.array([b[2] ** 2 + b[3] ** 2 for b in boxes])
    d2 = ((cms - G_cm) ** 2).sum(1)
    iz = float((iz_own + m * d2).sum())
    return G_cm, iz, rho


class SimState(NamedTuple):
    fluid: Any
    wall: Any
    block: Any
    rb: Any
    tension: jnp.ndarray       # (2,) cable tensions (diagnostic)
    nl_inner: Any
    nl_fw: Any
    nl_fb: Any
    nl_bf: Any
    time: jnp.ndarray          # physical (post-release) time
    total_time: jnp.ndarray
    n_adv: jnp.ndarray
    overflow: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class WaveFsiCase:
    dx: float
    adaptation: SPHAdaptation
    grid: Any
    eos: WeaklyCompressibleFluid
    riemann: Any
    gravity: Any
    wall0: Any
    maker_mask: Any
    packet: wm.FocusedPacketMotion
    block0: Any
    rb0: Any
    cable_len0: float
    n_fluid: int
    n_block: int
    cell_cap: int
    k_inner: int
    k_contact: int

    @property
    def kernel(self):
        return self.adaptation.kernel


def _box_shape(b):
    return G.Box(G.Transform(translation=(b[0] + b[2] / 2, b[1] + b[3] / 2)),
                 halfsize=(b[2] / 2, b[3] / 2))


def build_case(dx: float = DX_REF, dtype=jnp.float32, cell_cap: int = 24,
               k_inner: int = 64, k_contact: int = 40):
    bw = 4 * dx
    maker_w = 4 * dx           # Maker_width (h:29)
    adaptation = SPHAdaptation(spacing=dx, dim=2)

    structure_shape = G.make_complex(*[("add", _box_shape(b))
                                       for b in (BP, SSP, PSP, TP)])
    # mid air pocket between the pillars, under the top plate (h:349-361)
    mdp = G.Box(G.Transform(translation=((SSP[0] + SSP[2] + PSP[0]) / 2,
                                         (SSP[1] + SSP[1] + SSP[3]) / 2)),
                halfsize=((PSP[0] - SSP[0] - SSP[2]) / 2, SSP[3] / 2))
    water_poly = G.Polygon(vertices=(
        (0.0, 0.0), (0.0, WH), (WH * 10 + TB, WH), (TB, 0.0)))
    water_shape = G.make_complex(
        ("add", water_poly), ("sub", structure_shape), ("sub", mdp))

    outer = G.Polygon(vertices=(
        (-EXS - bw, -bw), (-EXS - bw, DH), (DL + bw, DH),
        (DL + bw, BEH - bw), (DB, 1.0 - bw), (TB - bw, -bw)))
    inner = G.Polygon(vertices=(
        (-EXS, 0.0), (-EXS, DH), (DL, DH), (DL, BEH), (DB, 1.0), (TB, 0.0)))
    maker = G.Box(G.Transform(translation=(-maker_w / 2, 0.75)),
                  halfsize=(maker_w / 2, 0.75))
    wall_shape = G.make_complex(("add", outer), ("sub", inner),
                                ("add", maker))

    dom_lo = (-EXS - bw, -bw)
    dom_hi = (DL + bw, DH + bw)
    pos_f, vol = generate_lattice(water_shape, dom_lo, dom_hi, dx)
    pos_w, _ = generate_lattice(wall_shape, dom_lo, dom_hi, dx)
    pos_b, _ = generate_lattice(structure_shape, dom_lo, dom_hi, dx)

    fluid = dict(make_fluid_state(pos_f, vol, RHO0_F, dtype=dtype))
    eos = WeaklyCompressibleFluid(rho0=RHO0_F, c0=C_F)
    p_hydro = np.maximum(
        RHO0_F * GRAVITY_G * (WH - np.asarray(pos_f)[:, 1]), 0.0)
    fluid["Density"] = jnp.asarray(
        np.asarray(eos.density_from_pressure(jnp.asarray(p_hydro))), dtype)
    fluid["Pressure"] = jnp.asarray(p_hydro, dtype)
    n = fluid["Position"].shape[0]
    fluid["ViscousForce"] = jnp.zeros((n, 2), dtype)
    fluid["ViscousForcePrev"] = jnp.zeros((n, 2), dtype)
    # opt into gravity_force's BaseForcePrior delta form (coexists with
    # the viscous prior force; see physics/general.py gravity_force)
    fluid["GravityForcePrev"] = jnp.zeros((n, 2), dtype)
    fluid["LinearGradientCorrectionMatrix"] = jnp.broadcast_to(
        jnp.eye(2, dtype=dtype), (n, 2, 2))

    wall = dict(make_solid_state(pos_w, vol, RHO0_F, dtype=dtype))
    wall = gd.normal_direction_from_shape(wall, wall_shape)
    wall["InitialPosition"] = wall["Position"]
    xw, yw = pos_w[:, 0], pos_w[:, 1]
    maker_mask = jnp.asarray((xw > -maker_w) & (xw < 0.0) & (yw > 0.0) &
                             (yw < 1.5))

    G_cm, iz, rho_s = _structure_mass_properties()
    block = dict(make_solid_state(pos_b, vol, rho_s, dtype=dtype))
    block = gd.normal_direction_from_shape(block, structure_shape)
    block["InitialPosition"] = block["Position"]
    for key in ("PressureForceFromFluid", "ViscousForceFromFluid"):
        block[key] = jnp.zeros_like(block["Position"])
        block["Previous" + key] = jnp.zeros_like(block["Position"])
    block["ForcePrior"] = jnp.zeros_like(block["Position"])
    block["Force"] = jnp.zeros_like(block["Position"])
    block["AverageAcceleration"] = jnp.zeros_like(block["Position"])

    mask = jnp.ones((len(pos_b),), bool)
    rb0 = rg.rigid_body_from_particles(block, mask)
    rb0 = rb0._replace(mass=jnp.asarray(STRUCTURE_MASS, dtype),
                       inertia=jnp.asarray(iz, dtype),
                       com=jnp.asarray(G_cm, dtype))

    packet = wm.make_focused_packet(dtype=dtype, **PACKET)
    gravity = gd.Gravity(acceleration=(0.0, -GRAVITY_G))
    fluid = gd.gravity_force(fluid, gravity)
    grid = grid_from_bounds(dom_lo, dom_hi, adaptation.cutoff)

    case = WaveFsiCase(dx=dx, adaptation=adaptation, grid=grid, eos=eos,
                       riemann=rs.acoustic_riemann(eos), gravity=gravity,
                       wall0=wall, maker_mask=maker_mask, packet=packet,
                       block0=block, rb0=rb0, cable_len0=float(CY),
                       n_fluid=len(pos_f), n_block=len(pos_b),
                       cell_cap=cell_cap, k_inner=k_inner,
                       k_contact=k_contact)
    return case, fluid


def rebuild(case: WaveFsiCase, fluid: State, wall: State, block: State):
    pos = fluid["Position"]
    n_f, n_b = fluid["NReal"], block["NReal"]
    cutoff = case.adaptation.cutoff
    table_f = build_cell_table(pos, n_f, case.grid, cap=case.cell_cap)
    table_w = build_cell_table(wall["Position"], wall["NReal"], case.grid,
                               cap=case.cell_cap)
    table_b = build_cell_table(block["Position"], n_b, case.grid,
                               cap=case.cell_cap)
    nl_inner = build_neighbor_list(pos, n_f, pos, n_f, table_f, case.grid,
                                   cutoff, k_max=case.k_inner,
                                   include_self=False)
    nl_fw = build_neighbor_list(pos, n_f, wall["Position"], wall["NReal"],
                                table_w, case.grid, cutoff,
                                k_max=case.k_contact, include_self=True)
    nl_fb = build_neighbor_list(pos, n_f, block["Position"], n_b, table_b,
                                case.grid, cutoff, k_max=case.k_contact,
                                include_self=True)
    nl_bf = build_neighbor_list(block["Position"], n_b, pos, n_f, table_f,
                                case.grid, cutoff, k_max=case.k_contact,
                                include_self=True)
    ovf = nl_inner.overflow | nl_fw.overflow | nl_fb.overflow | nl_bf.overflow
    return nl_inner, nl_fw, nl_fb, nl_bf, ovf


def init_sim(case: WaveFsiCase, fluid: State) -> SimState:
    wall, block = case.wall0, case.block0
    nls = jax.jit(partial(rebuild, case))(fluid, wall, block)
    dtype = fluid["Position"].dtype
    z = jnp.zeros((), dtype)
    return SimState(fluid=fluid, wall=wall, block=block, rb=case.rb0,
                    tension=jnp.zeros((2,), dtype),
                    nl_inner=nls[0], nl_fw=nls[1], nl_fb=nls[2], nl_bf=nls[3],
                    time=z, total_time=z, n_adv=jnp.zeros((), jnp.int32),
                    overflow=nls[4])


def _cable_forces(rb, com0):
    """Tension-only cable springs (SimTK::CableSpring law
    T = k s (1 + c s_dot), clamped >= 0): returns (force, torque, tensions).
    Attachment points ride the rigid body (velocity = V + omega x arm);
    anchors sit on the tank floor below them (cpp:117-139)."""
    dtype = rb.com.dtype
    force = jnp.zeros((2,), dtype)
    torque = jnp.zeros((), dtype)
    tensions = []
    c, s = jnp.cos(rb.theta), jnp.sin(rb.theta)
    R = jnp.asarray([[c, -s], [s, c]], dtype)
    for cx in (CX_A, CX_B):
        anchor = jnp.asarray([cx, 0.0], dtype)
        attach0 = jnp.asarray([cx, CY], dtype)
        attach = rb.com + R @ (attach0 - com0)
        arm = attach - rb.com
        v_attach = rb.vel + rb.omega * jnp.stack([-arm[1], arm[0]])
        d = attach - anchor
        length = jnp.linalg.norm(d)
        e = d / (length + 1e-15)
        stretch = length - CY
        s_dot = jnp.dot(e, v_attach)
        T = jnp.maximum(CABLE_K * stretch * (1.0 + CABLE_DAMP * s_dot), 0.0)
        T = jnp.where(stretch > 0.0, T, 0.0)
        f = -T * e
        force = force + f
        torque = torque + arm[0] * f[1] - arm[1] * f[0]
        tensions.append(T)
    return force, torque, jnp.stack(tensions)


def _advection_step(case: WaveFsiCase, s: SimState) -> SimState:
    kernel, dim = case.kernel, 2
    h = case.adaptation.h
    sigma0 = case.adaptation.sigma0
    fluid, wall, block, rb = s.fluid, s.wall, s.block, s.rb
    mask_b = jnp.ones((case.n_block,), bool)

    dt_adv = fd.advection_viscous_time_step(fluid, h, U_F, RHO0_F, MU_F)
    fluid = fd.density_summation(
        fluid, s.nl_inner, kernel, dim, RHO0_F, sigma0,
        contacts=[(wall, s.nl_fw, RHO0_F), (block, s.nl_fb, RHO0_F)],
        free_surface=True)
    fluid = fd.kernel_correction_matrix(fluid, s.nl_inner, kernel, dim,
                                        wall=wall, nl_wall=s.nl_fw, alpha=0.1)
    fluid = fd.viscous_force(fluid, s.nl_inner, kernel, dim, MU_F, h,
                             walls=[(wall, s.nl_fw), (block, s.nl_fb)])
    block = fsi.viscous_force_from_fluid(block, fluid, s.nl_bf, kernel, dim,
                                         MU_F, h)

    def ac_cond(carry):
        return carry[-1] < dt_adv

    def ac_body(carry):
        f, w, b, r, tension, tt, rt = carry
        dt = jnp.minimum(fd.acoustic_time_step(f, case.eos, h), dt_adv)
        released = tt >= RELAX_TIME
        f = fd.acoustic_step_1st_half(f, s.nl_inner, kernel, dim, case.eos,
                                      case.riemann, dt,
                                      walls=[(w, s.nl_fw), (b, s.nl_fb)],
                                      correction=True)
        b = fsi.pressure_force_from_fluid(b, f, s.nl_bf, kernel, dim,
                                          case.riemann)
        force, torque = rg.total_force_and_torque(b, mask_b, r,
                                                  force_keys=("ForcePrior",))
        cf, ct, tension_new = _cable_forces(r, case.rb0.com)
        r_new = rg.rigid_step(r, force + cf, torque + ct, dt,
                              gravity=(0.0, -GRAVITY_G))
        r_new = jax.tree.map(lambda a, b_: jnp.where(released, a, b_),
                             r_new, r)
        tension = jnp.where(released, tension_new, tension)
        b = rg.constrain_by_rigid_body(b, mask_b, r_new,
                                       case.block0["InitialPosition"],
                                       case.rb0.com)
        acc = (r_new.vel - r.vel) / (dt + 1e-15)
        b = dict(b)
        b["AverageAcceleration"] = jnp.broadcast_to(acc, b["Position"].shape)
        # focused-packet piston (frozen until release, cpp:261-269)
        t_wave = jnp.maximum(tt - RELAX_TIME, 0.0)
        w_moved = wm.apply_wavemaker(w, case.maker_mask, case.packet, t_wave)
        w = jax.tree.map(lambda a, b_: jnp.where(released, a, b_), w_moved, w)
        f = fd.acoustic_step_2nd_half(f, s.nl_inner, kernel, dim,
                                      case.riemann, dt,
                                      walls=[(w, s.nl_fw), (b, s.nl_fb)])
        return (f, w, b, r_new, tension, tt + dt, rt + dt)

    fluid, wall, block, rb, tension, total_time, relax_t = \
        jax.lax.while_loop(ac_cond, ac_body,
                           (fluid, wall, block, rb, s.tension,
                            s.total_time, jnp.zeros_like(dt_adv)))

    nls = rebuild(case, fluid, wall, block)
    return SimState(fluid=fluid, wall=wall, block=block, rb=rb,
                    tension=tension,
                    nl_inner=nls[0], nl_fw=nls[1], nl_fb=nls[2], nl_bf=nls[3],
                    time=jnp.maximum(total_time - RELAX_TIME, 0.0),
                    total_time=total_time, n_adv=s.n_adv + 1,
                    overflow=s.overflow | nls[4])


def make_run_chunk(case: WaveFsiCase):
    @jax.jit
    def run_chunk(s: SimState, t_target) -> SimState:
        return jax.lax.while_loop(lambda st: st.time < t_target,
                                  lambda st: _advection_step(case, st), s)

    return run_chunk


def wave_gauge(s: SimState, x: float = X_GAUGE, half_width: float = 0.039):
    """UpperFrontInAxisDirection over the gauge band (h:568-579)."""
    pos = s.fluid["Position"]
    band = jnp.abs(pos[:, 0] - x) < half_width
    return jnp.max(jnp.where(band, pos[:, 1], 0.0))


def probe_pressure(case: WaveFsiCase, s: SimState, point0=FP2):
    """fp2/fp3: the probe rides the structure (cpp:192-199); pressure is
    kernel-interpolated from the fluid at its current position."""
    rb = s.rb
    dtype = rb.com.dtype
    c, si = jnp.cos(rb.theta), jnp.sin(rb.theta)
    R = jnp.asarray([[c, -si], [si, c]], dtype)
    pt = rb.com + R @ (jnp.asarray(point0, dtype) - case.rb0.com)
    pos, vol = s.fluid["Position"], s.fluid["VolumetricMeasure"]
    r = jnp.linalg.norm(pos - pt, axis=1)
    w = jnp.where(r < case.adaptation.cutoff,
                  case.kernel.W(r, 2) * vol, 0.0)
    return jnp.sum(w * s.fluid["Pressure"]) / (jnp.sum(w) + 1e-15)
