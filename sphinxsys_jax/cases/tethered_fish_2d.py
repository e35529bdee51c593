"""Tethered dead fish in flow — the Simbody-in-flow composition.

Counterpart of /root/reference/tests/2d_examples/
test_2d_tethered_dead_fish_in_flow/src/tethered_dead_fish_in_flow.cpp:
a passive (dead) elastic fish in a ramped channel inflow, whose HEAD is
a rigid body on a Planar mobilizer (cpp:370) tethered to an upstream
anchor by a cable spring (SimTK::CableSpring, cpp:378-379: stiffness
100, rest length 3, dissipation 10).  Per solid substep the total force
+ torque on the head particle set (TotalForceOnBodyPartForSimBody,
cpp:402) feeds the multibody solve, the mobilized body advances, and
the head particles are constrained to its rigid motion
(ConstraintBodyPartBySimBody, cpp:404); the body aft of the head flaps
passively in the wake.

XLA-native formulation: the Planar mobilizer is the slider-x ->
slider-y -> pin chain of `articulated.planar_tree` — every dynamic term
comes from the autodiff Lagrangian of the kinematic chain, so the
coupling is exactly the reference's loop with the Simbody integrator
replaced by `articulated.make_articulated_step`'s RK4.

Geometry/parameters follow the reference (channel 11 x 8, fish length
3.738 at (2, 4), tether anchor (-1, 4), Re = 5e3, E = 200 rho U^2).
Deviations: the fish outline reuses the 5th-order fish_and_bones camber
of cases/fish_undulation_2d.py scaled to length 3.738 (the reference's
CreatFishShape is the same outline family), and the cable attaches at
the head COM station with the nose lever arm folded into the torque.
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
from sphinxsys_jax.core.materials import (SaintVenantKirchhoffSolid,
                                          WeaklyCompressibleFluid)
from sphinxsys_jax.core.state import FAR_AWAY, State, make_fluid_state, \
    make_solid_state
from sphinxsys_jax.neighbors import (build_cell_table, build_neighbor_list,
                                     grid_from_bounds)
from sphinxsys_jax.physics import articulated as ab
from sphinxsys_jax.physics import boundary as bd
from sphinxsys_jax.physics import fluid as fd
from sphinxsys_jax.physics import fsi
from sphinxsys_jax.physics import general as gd
from sphinxsys_jax.physics import riemann as rs
from sphinxsys_jax.physics import solid as sd
from sphinxsys_jax.cases import fish_undulation_2d as fish_mod
from sphinxsys_jax.utils.hosteval import host_eval

# tethered_dead_fish_in_flow.cpp:18-44
DL = 11.0
DH = 8.0
CX, CY = 2.0, 4.0
FISH_L = 3.738
HEAD_SIZE = 1.0
ANCHOR = (-1.0, CY)
CABLE_K = 100.0
CABLE_L0 = 3.0
CABLE_C = 10.0
RHO0_F = 1.0
U_F = 1.0
C_F = 10.0 * U_F
RE = 5.0e3
MU_F = RHO0_F * U_F * FISH_L / RE
RHO0_S = 1.0
E_S = 2.0e2 * RHO0_F * U_F * U_F
POISSON = 0.3925                      # reference tethered-fish value range
T_REF = 2.0


class TetherSim(NamedTuple):
    fluid: Any
    fish: Any
    q: jnp.ndarray          # planar mobilizer coordinates (dx, dy, theta)
    u: jnp.ndarray
    nl_ff: Any
    nl_fs: Any
    nl_sf: Any
    nl_fw: Any              # fluid -> wall
    time: jnp.ndarray
    n_adv: jnp.ndarray
    overflow: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class TetherCase:
    dx: float
    adaptation: SPHAdaptation
    grid: Any
    eos: WeaklyCompressibleFluid
    material_s: SaintVenantKirchhoffSolid
    riemann: Any
    no_riemann: Any
    rp: sd.ReferencePairs
    wall: State
    wall_table: Any
    tree: ab.ArticulatedTree
    head_mask: Any          # (n_fish,) head particle set
    head_station: Any       # (n_fish, 3) body-frame stations
    nose_station: Any       # (3,) cable attachment in the head frame
    emitter: bd.AlignedBoxRegion
    disposer: bd.AlignedBoxRegion
    n_fluid: int
    n_fish: int
    cell_cap: int
    k_inner: int
    k_contact: int
    dl_sponge: float

    @property
    def kernel(self):
        return self.adaptation.kernel


def _scaled_fish_polygon(dx: float):
    scale = FISH_L / fish_mod.FISH_LENGTH
    poly = fish_mod.fish_polygon(0.5 * dx / scale)
    verts = np.asarray(poly.vertices) * scale
    return G.Polygon(vertices=tuple(map(tuple, verts)))


def build_case(dx: float = FISH_L / 100.0, dtype=jnp.float32,
               cell_cap: int = 24, k_inner: int = 40, k_contact: int = 24,
               reserve: float = 0.15):
    adaptation = SPHAdaptation(spacing=dx, dim=2)
    dl_sponge = 20.0 * dx
    bw = 4.0 * dx

    fish_shape = _scaled_fish_polygon(dx)
    pos_s, vol_s = generate_lattice(
        fish_shape, (-0.1, -0.6), (FISH_L + 0.1, 0.6), dx)
    pos_s = np.asarray(pos_s) + np.asarray([CX, CY])
    n_s = len(pos_s)

    water_shape = G.Box(
        G.Transform(translation=((DL - dl_sponge) / 2.0, DH / 2.0)),
        halfsize=((DL + dl_sponge) / 2.0, DH / 2.0))
    pos_all, vol = generate_lattice(water_shape, (-dl_sponge, 0.0),
                                    (DL, DH), dx)
    pos_all = np.asarray(pos_all)
    in_fish = host_eval(fish_shape.contains,
                        jnp.asarray(pos_all - np.asarray([CX, CY])))
    pos_f = pos_all[~np.asarray(in_fish)]
    n_f = len(pos_f)
    cap_f = int(n_f * (1.0 + reserve))
    pos_full = np.full((cap_f, 2), float(FAR_AWAY))
    pos_full[:n_f] = pos_f
    fluid = dict(make_fluid_state(pos_full, vol, RHO0_F, dtype=dtype))
    fluid["Alive"] = jnp.arange(cap_f) < n_f
    fluid["NReal"] = jnp.asarray(cap_f, jnp.int32)
    fluid["Indicator"] = jnp.zeros((cap_f,), jnp.int32)
    fluid["PreviousSurfaceIndicator"] = jnp.ones((cap_f,), jnp.int32)
    fluid["PositionDivergence"] = jnp.zeros((cap_f,), dtype)
    fluid["ViscousForce"] = jnp.zeros((cap_f, 2), dtype)
    fluid["ViscousForcePrev"] = jnp.zeros((cap_f, 2), dtype)

    # top/bottom channel walls
    wall_outer = G.Box(
        G.Transform(translation=((DL - dl_sponge) / 2.0, DH / 2.0)),
        halfsize=((DL + dl_sponge) / 2.0 + bw, DH / 2.0 + bw))
    wall_shape = G.make_complex(("add", wall_outer), ("sub", water_shape))
    pos_w, _ = generate_lattice(
        wall_shape, (-dl_sponge - bw - dx, -bw - dx),
        (DL + bw + dx, DH + bw + dx), dx)
    wall = dict(make_solid_state(pos_w, vol, RHO0_F, dtype=dtype))
    wall = gd.normal_direction_from_shape(wall, wall_shape)

    material_s = SaintVenantKirchhoffSolid(rho0=RHO0_S, youngs_modulus=E_S,
                                           poisson_ratio=POISSON)
    fish = dict(sd.make_elastic_solid_state(pos_s, vol_s, material_s,
                                            dtype=dtype))
    fish["AverageVelocity"] = jnp.zeros((n_s, 2), dtype)
    fish["AverageAcceleration"] = jnp.zeros((n_s, 2), dtype)
    fish["TemporaryPosition"] = fish["Position"]
    for key in ["ViscousForceFromFluid", "PressureForceFromFluid"]:
        fish[key] = jnp.zeros((n_s, 2), dtype)
        fish["Previous" + key] = jnp.zeros((n_s, 2), dtype)

    grid = grid_from_bounds((-dl_sponge - 2 * bw, -2 * bw),
                            (DL + 2 * bw, DH + 2 * bw), adaptation.cutoff)
    table_s = jax.jit(partial(build_cell_table, grid=grid, cap=cell_cap))(
        fish["Position"], fish["NReal"])
    nl_ss = jax.jit(partial(build_neighbor_list, grid=grid,
                            cutoff=adaptation.cutoff, k_max=k_inner,
                            include_self=False))(
        fish["Position"], fish["NReal"], fish["Position"], fish["NReal"],
        table_s)
    rp = sd.freeze_reference_pairs(fish["Position"], nl_ss,
                                   adaptation.kernel, 2)
    fish["LinearGradientCorrectionMatrix"] = \
        sd.linear_gradient_correction_matrix(rp, fish["VolumetricMeasure"])
    tmp = dict(fish)
    tmp["Position"] = fish["Position"] - jnp.asarray([CX, CY], dtype)
    tmp = gd.normal_direction_from_shape(tmp, fish_shape)
    fish["NormalDirection"] = tmp["NormalDirection"]
    fish["InitialNormalDirection"] = tmp["NormalDirection"]

    wall_table = jax.jit(partial(build_cell_table, grid=grid, cap=cell_cap))(
        wall["Position"], wall["NReal"])

    # --- head rigid body on the Planar mobilizer ----------------------
    head_mask_np = pos_s[:, 0] < CX + HEAD_SIZE
    m_i = np.asarray(fish["Mass"])
    m_head = float(m_i[head_mask_np].sum())
    com0 = (m_i[head_mask_np, None] * pos_s[head_mask_np]).sum(0) / m_head
    r = pos_s[head_mask_np] - com0
    izz = float((m_i[head_mask_np] * (r ** 2).sum(1)).sum())
    tree = ab.planar_tree(m_head, izz, (com0[0], com0[1], 0.0), dtype=dtype)
    stations = np.zeros((n_s, 3))
    stations[:, :2] = pos_s - com0
    nose_station = np.array([CX - com0[0], CY - com0[1], 0.0])

    emitter = bd.AlignedBoxRegion(lower=(-dl_sponge, 0.0),
                                  upper=(-dl_sponge + bw, DH), axis=0)
    disposer = bd.AlignedBoxRegion(lower=(DL - bw, -bw),
                                   upper=(DL + bw, DH + bw), axis=0)

    eos = WeaklyCompressibleFluid(rho0=RHO0_F, c0=C_F)
    case = TetherCase(
        dx=dx, adaptation=adaptation, grid=grid, eos=eos,
        material_s=material_s, riemann=rs.acoustic_riemann(eos),
        no_riemann=rs.no_riemann(eos), rp=rp, wall=wall,
        wall_table=wall_table, tree=tree,
        head_mask=jnp.asarray(head_mask_np),
        head_station=jnp.asarray(stations, dtype),
        nose_station=jnp.asarray(nose_station, dtype),
        emitter=emitter, disposer=disposer, n_fluid=cap_f, n_fish=n_s,
        cell_cap=cell_cap, k_inner=k_inner, k_contact=k_contact,
        dl_sponge=dl_sponge)
    return case, fluid, fish


def rebuild_relations(case: TetherCase, fluid: State, fish: State):
    alive = fluid["Alive"]
    n_s = fish["NReal"]
    cutoff = case.adaptation.cutoff
    table_f = build_cell_table(fluid["Position"], alive, case.grid,
                               cap=case.cell_cap)
    table_s = build_cell_table(fish["Position"], n_s, case.grid,
                               cap=case.cell_cap)
    nl_ff = build_neighbor_list(fluid["Position"], alive, fluid["Position"],
                                alive, table_f, case.grid, cutoff,
                                k_max=case.k_inner, include_self=False)
    nl_fs = build_neighbor_list(fluid["Position"], alive, fish["Position"],
                                n_s, table_s, case.grid, cutoff,
                                k_max=case.k_contact, include_self=True)
    nl_sf = build_neighbor_list(fish["Position"], n_s, fluid["Position"],
                                alive, table_f, case.grid, cutoff,
                                k_max=case.k_contact, include_self=True)
    nl_fw = build_neighbor_list(fluid["Position"], alive,
                                case.wall["Position"], case.wall["NReal"],
                                case.wall_table, case.grid, cutoff,
                                k_max=case.k_contact, include_self=True)
    ovf = nl_ff.overflow | nl_fs.overflow | nl_sf.overflow | nl_fw.overflow
    return nl_ff, nl_fs, nl_sf, nl_fw, ovf


def init_sim(case: TetherCase, fluid: State, fish: State) -> TetherSim:
    nl_ff, nl_fs, nl_sf, nl_fw, ovf = jax.jit(
        partial(rebuild_relations, case))(fluid, fish)
    dtype = fluid["Position"].dtype
    return TetherSim(fluid=fluid, fish=fish,
                     q=jnp.zeros((3,), dtype), u=jnp.zeros((3,), dtype),
                     nl_ff=nl_ff, nl_fs=nl_fs, nl_sf=nl_sf, nl_fw=nl_fw,
                     time=jnp.zeros((), dtype),
                     n_adv=jnp.zeros((), jnp.int32), overflow=ovf)


def _inflow_condition(fluid: State, t, dl_sponge) -> State:
    """Ramped uniform inflow over the sponge (cpp:170-190)."""
    out = dict(fluid)
    pos = fluid["Position"]
    in_sponge = (fluid["Alive"] & (pos[:, 0] < 0.0)
                 & (pos[:, 0] >= -dl_sponge))
    u_ave = jnp.where(t < T_REF,
                      0.5 * U_F * (1.0 - jnp.cos(jnp.pi * t / T_REF)), U_F)
    vel = fluid["Velocity"]
    out["Velocity"] = vel.at[:, 0].set(
        jnp.where(in_sponge, u_ave, vel[:, 0]))
    return out


def cable_force(case: TetherCase, kin: ab.LinkKinematics):
    """CableSpring (cpp:378-379): taut-only linear spring + dissipation
    along the anchor -> nose cable."""
    R, p = kin.R[2], kin.p[2]
    attach = p + R @ case.nose_station
    v_attach = kin.v[2] + jnp.cross(kin.w[2], R @ case.nose_station)
    anchor = jnp.asarray([ANCHOR[0], ANCHOR[1], 0.0], p.dtype)
    d = attach - anchor
    length = jnp.linalg.norm(d) + 1e-12
    e = d / length
    stretch = length - CABLE_L0
    ldot = jnp.dot(v_attach, e)
    tension = jnp.where(stretch > 0.0,
                        CABLE_K * stretch + CABLE_C * ldot, 0.0)
    tension = jnp.maximum(tension, 0.0)
    f = -tension * e
    torque = jnp.cross(R @ case.nose_station, f)
    return f, torque, tension


def _head_force_torque(case: TetherCase, fish: State, kin):
    """TotalForceOnBodyPartForSimBody (cpp:402): sum of all particle
    forces on the head part + torque about the body origin (= COM)."""
    F2 = fish["Force"] + fish["ForcePrior"]
    m = case.head_mask
    fx = jnp.sum(jnp.where(m, F2[:, 0], 0.0))
    fy = jnp.sum(jnp.where(m, F2[:, 1], 0.0))
    com = kin.c[2]
    rx = fish["Position"][:, 0] - com[0]
    ry = fish["Position"][:, 1] - com[1]
    tz = jnp.sum(jnp.where(m, rx * F2[:, 1] - ry * F2[:, 0], 0.0))
    return jnp.asarray([fx, fy, 0.0]), jnp.asarray([0.0, 0.0, tz])


def _advection_step(case: TetherCase, s: TetherSim) -> TetherSim:
    kernel, dim = case.kernel, 2
    h = case.adaptation.h
    sigma0 = case.adaptation.sigma0
    fluid, fish = s.fluid, s.fish
    pos_prev = fluid["Position"]
    walls = [(fish, s.nl_fs), (case.wall, s.nl_fw)]

    dt_adv = fd.advection_viscous_time_step(fluid, h, U_F, RHO0_F, MU_F)
    fluid = fd.free_surface_indication(
        fluid, s.nl_ff, kernel, dim,
        contacts=[(fish, s.nl_fs, None), (case.wall, s.nl_fw, None)],
        spatial_temporal=True)
    fluid = fd.density_summation_freestream(
        fluid, s.nl_ff, kernel, dim, RHO0_F, sigma0,
        contacts=[(fish, s.nl_fs, RHO0_S), (case.wall, s.nl_fw, RHO0_F)])
    fluid = fd.viscous_force(fluid, s.nl_ff, kernel, dim, MU_F, h,
                             walls=walls)
    fluid = fd.transport_velocity_correction(
        fluid, s.nl_ff, kernel, dim, h, coefficient=0.2, walls=walls,
        scope_mask=(fluid["Indicator"] == 0) & fluid["Alive"])

    fish = fsi.viscous_force_from_fluid(fish, fluid, s.nl_sf, kernel, dim,
                                        MU_F, h)
    fish = fsi.update_elastic_normal_direction(fish)

    w0 = kernel.w0(dim)
    c0s = case.material_s.sound_speed
    tree_step = ab.make_articulated_step(case.tree, (0.0, 0.0, 0.0))

    def mid_body(carry):
        f, so, q, u, rt = carry
        dt = jnp.minimum(fd.acoustic_time_step(f, case.eos, h), dt_adv)
        walls_now = [(so, s.nl_fs), (case.wall, s.nl_fw)]
        f = fd.acoustic_step_1st_half(f, s.nl_ff, kernel, dim, case.eos,
                                      case.riemann, dt, walls=walls_now)
        f = _inflow_condition(f, s.time + rt, case.dl_sponge)
        so = fsi.pressure_force_from_fluid(so, f, s.nl_sf, kernel, dim,
                                           case.riemann)
        f = fd.acoustic_step_2nd_half(f, s.nl_ff, kernel, dim,
                                      case.no_riemann, dt, walls=walls_now)
        so = fsi.initialize_displacement(so)

        def s_body(sc):
            so_i, q_i, u_i, ds_sum = sc
            dt_s = jnp.minimum(sd.solid_acoustic_time_step(so_i, c0s, h),
                               dt - ds_sum)
            so_i = sd.integration_1st_half_pk2(so_i, case.rp,
                                               case.material_s, dt_s, h, w0)
            # multibody solve on the head: particle forces + cable
            kin = ab.forward_kinematics(case.tree, q_i, u_i)
            f_w, t_w = _head_force_torque(case, so_i, kin)
            f_c, t_c, _ = cable_force(case, kin)
            forces = jnp.zeros((3, 3), q_i.dtype).at[2].set(f_w + f_c)
            torques = jnp.zeros((3, 3), q_i.dtype).at[2].set(t_w + t_c)
            tau = ab.generalized_forces(case.tree, q_i, forces, torques)
            q_i, u_i = tree_step(s.time + rt + ds_sum, q_i, u_i, dt_s, tau)
            kin = ab.forward_kinematics(case.tree, q_i, u_i)
            so3 = {"Position": jnp.pad(so_i["Position"], ((0, 0), (0, 1))),
                   "Velocity": jnp.pad(so_i["Velocity"], ((0, 0), (0, 1)))}
            so3 = ab.constrain_by_link(so3, case.head_mask, kin, 2,
                                       case.head_station)
            so_i = dict(so_i)
            mask = case.head_mask[:, None]
            so_i["Position"] = jnp.where(mask, so3["Position"][:, :2],
                                         so_i["Position"])
            so_i["Velocity"] = jnp.where(mask, so3["Velocity"][:, :2],
                                         so_i["Velocity"])
            so_i = sd.integration_2nd_half(so_i, case.rp, dt_s)
            return (so_i, q_i, u_i, ds_sum + dt_s)

        so, q, u, _ = jax.lax.while_loop(
            lambda sc: sc[3] < dt, s_body,
            (so, q, u, jnp.zeros_like(dt)))
        so = fsi.update_average_velocity_acceleration(so, dt)
        return (f, so, q, u, rt + dt)

    fluid, fish, q, u, relax_t = jax.lax.while_loop(
        lambda c: c[4] < dt_adv, mid_body,
        (fluid, fish, s.q, s.u, jnp.zeros_like(dt_adv)))

    fluid = bd.disposer_outflow_deletion(fluid, case.disposer)
    fluid = bd.emitter_inflow_injection(fluid, case.emitter,
                                        prev_pos=pos_prev)
    inj_ovf = fluid.pop("_InjectionOverflow", jnp.zeros((), bool))

    nl_ff, nl_fs, nl_sf, nl_fw, ovf = rebuild_relations(case, fluid, fish)
    return TetherSim(fluid=fluid, fish=fish, q=q, u=u, nl_ff=nl_ff,
                     nl_fs=nl_fs, nl_sf=nl_sf, nl_fw=nl_fw,
                     time=s.time + relax_t, n_adv=s.n_adv + 1,
                     overflow=s.overflow | ovf | inj_ovf)


def make_run_chunk(case: TetherCase):
    @jax.jit
    def run_chunk(s: TetherSim, t_target) -> TetherSim:
        return jax.lax.while_loop(lambda st: st.time < t_target,
                                  lambda st: _advection_step(case, st), s)

    return run_chunk


def head_com(case: TetherCase, s: TetherSim) -> np.ndarray:
    kin = ab.forward_kinematics(case.tree, s.q, s.u)
    return np.asarray(kin.c[2][:2])


def cable_tension(case: TetherCase, s: TetherSim) -> float:
    kin = ab.forward_kinematics(case.tree, s.q, s.u)
    _, _, tension = cable_force(case, kin)
    return float(tension)
