"""Self-propelled fish in a channel — the full FSI composition.

Counterpart of /root/reference/tests/2d_examples/test_2d_flow_stream_around_fish/
(2d_flow_stream_around_fish.cpp):
  * channel 0.8 x 0.4 of initially quiescent water (the reference's
    FreeStreamVelocity has u_ref = 0 — the "stream" is a zero-velocity
    far field), open left/right boundaries via emitter injection and
    disposer deletion, free-stream velocity correction on
    surface-indicated particles;
  * fish (5th-order polynomial outline, nose at (0.24, 0.2)) as a
    composite active-muscle / passive-body / stiff-spine total-Lagrangian
    solid (cases/fish_undulation_2d.py), driven by the traveling-wave
    active strain (ImposingActiveStrain) inside the solid sub-loop;
  * triple-rate coupling identical to fsi2: advection step (density by
    summation + viscous + transport correction + FSI viscous force),
    acoustic loop (pressure relaxation with the fish as moving contact
    wall, FSI pressure force, density relaxation), solid sub-cycling with
    averaged-velocity feedback.

Deviation from the reference: single resolution (fish dx = fluid dx)
instead of the reference's 2x fish refinement (defineAdaptationRatios
(1.15, 2.0)) — multi-level adaptive-h cell lists are not implemented yet.

The observable: the fish self-propels; the forward displacement and speed
of its center of mass are recorded (reference records
WaterBody_TotalMechanicalEnergy for regression; we track both).
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
from sphinxsys_jax.core.materials import WeaklyCompressibleFluid, SaintVenantKirchhoffSolid
from sphinxsys_jax.core.state import State, make_fluid_state, FAR_AWAY
from sphinxsys_jax.neighbors import grid_from_bounds, build_cell_table, build_neighbor_list
from sphinxsys_jax.physics import boundary as bd
from sphinxsys_jax.physics import fluid as fd
from sphinxsys_jax.physics import fsi
from sphinxsys_jax.physics import riemann as rs
from sphinxsys_jax.physics import solid as sd
from sphinxsys_jax.cases import fish_undulation_2d as fish_mod
from sphinxsys_jax.utils.hosteval import host_eval

# 2d_flow_stream_around_fish.h:8-40
DL = 0.8
DH = 0.4
DX_REF = 0.0025
CX = 0.3 * DL               # fish nose x
CY = DH / 2.0
RHO0_F = 1000.0
U_F = 1.0
C_F = 10.0 * U_F
RE = 30000.0
MU_F = RHO0_F * U_F * 0.3 / RE
T_REF = 2.0                 # free-stream ramp (u_ref = 0 -> target is 0)


class FishFSISim(NamedTuple):
    fluid: Any
    fish: Any
    nl_ff: Any      # fluid inner
    nl_fs: Any      # fluid -> fish
    nl_sf: Any      # fish -> fluid
    time: jnp.ndarray
    n_adv: jnp.ndarray
    n_ac: jnp.ndarray
    n_s: jnp.ndarray
    overflow: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class FishFSICase:
    dx: float
    adaptation: SPHAdaptation
    grid: Any                # one grid covering the whole domain
    eos: WeaklyCompressibleFluid
    material_s: SaintVenantKirchhoffSolid
    riemann: rs.AcousticRiemannSolver
    no_riemann: rs.NoRiemannSolver
    rp: sd.ReferencePairs
    emitter: bd.AlignedBoxRegion
    emitter_buffer: bd.AlignedBoxRegion
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


def build_case(dx: float = DX_REF, dtype=jnp.float32, cell_cap: int = 24,
               k_inner: int = 40, k_contact: int = 24,
               reserve: float = 0.1):
    adaptation = SPHAdaptation(spacing=dx, dim=2)
    dl_sponge = 20.0 * dx
    bw = 4.0 * dx

    # fish body at (CX, CY)
    fish_shape = fish_mod.fish_polygon(dx * 0.5)
    pos_s, vol_s = generate_lattice(
        fish_shape, (-0.02, -0.05), (fish_mod.FISH_LENGTH + 0.02, 0.05), dx)
    pos_s = np.asarray(pos_s) + np.asarray([CX, CY])

    # water = channel (with sponge) minus fish
    water_shape = G.Box(
        G.Transform(translation=((DL - dl_sponge) / 2.0, DH / 2.0)),
        halfsize=((DL + dl_sponge) / 2.0, DH / 2.0))
    pos_all, vol = generate_lattice(water_shape, (-dl_sponge, 0.0), (DL, DH), dx)
    pos_all = np.asarray(pos_all)
    in_fish = host_eval(fish_shape.contains,
                        jnp.asarray(pos_all - np.asarray([CX, CY])))
    pos_f = pos_all[~np.asarray(in_fish)]

    n_f = len(pos_f)
    cap_f = int(n_f * (1.0 + reserve))
    fluid = dict(make_fluid_state(pos_f, vol, RHO0_F, capacity=cap_f,
                                  dtype=dtype))
    fluid["Alive"] = jnp.arange(cap_f) < n_f
    zeros_v = jnp.zeros((cap_f, 2), dtype)
    fluid["ViscousForce"] = zeros_v
    fluid["ViscousForcePrev"] = zeros_v
    fluid["Indicator"] = jnp.zeros(cap_f, jnp.int32)
    fluid["PreviousSurfaceIndicator"] = jnp.ones(cap_f, jnp.int32)
    fluid["PositionDivergence"] = jnp.zeros(cap_f, dtype)

    eos = WeaklyCompressibleFluid(rho0=RHO0_F, c0=C_F)

    # composite fish solid (reuses the structural case construction)
    stiff = SaintVenantKirchhoffSolid(rho0=fish_mod.RHO0_S,
                                      youngs_modulus=fish_mod.E_HEAD,
                                      poisson_ratio=fish_mod.POISSON)
    fish = dict(sd.make_elastic_solid_state(pos_s, vol_s, stiff, dtype=dtype))
    n_s = len(pos_s)
    mat = fish_mod.material_regions(pos_s, origin=(CX, CY))
    youngs = np.choose(mat, [fish_mod.E_MUSCLE, fish_mod.E_BODY, fish_mod.E_HEAD])
    lam = youngs * fish_mod.POISSON / (
        (1 + fish_mod.POISSON) * (1 - 2 * fish_mod.POISSON))
    g0 = youngs / (2 * (1 + fish_mod.POISSON))
    fish["MaterialID"] = jnp.asarray(mat)
    fish["Lambda0"] = jnp.asarray(lam, dtype)
    fish["ShearModulus"] = jnp.asarray(g0, dtype)
    fish["ActiveStrain"] = jnp.zeros((n_s, 2, 2), dtype)
    fish["AverageVelocity"] = jnp.zeros((n_s, 2), dtype)
    fish["AverageAcceleration"] = jnp.zeros((n_s, 2), dtype)
    fish["TemporaryPosition"] = fish["Position"]
    for key in ["ViscousForceFromFluid", "PressureForceFromFluid"]:
        fish[key] = jnp.zeros((n_s, 2), dtype)
        fish["Previous" + key] = jnp.zeros((n_s, 2), dtype)

    grid = grid_from_bounds((-dl_sponge - bw, -bw), (DL + bw, DH + bw),
                            adaptation.cutoff)

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
    # normals from the fish shape (NormalDirectionFromBodyShape); the
    # polygon lives in fish-local coordinates, so probe with shifted points
    from sphinxsys_jax.physics import general as gd
    tmp = dict(fish)
    tmp["Position"] = fish["Position"] - jnp.asarray([CX, CY], dtype)
    tmp = gd.normal_direction_from_shape(tmp, fish_shape)
    fish["NormalDirection"] = tmp["NormalDirection"]
    fish["InitialNormalDirection"] = tmp["NormalDirection"]

    emitter = bd.AlignedBoxRegion(lower=(-dl_sponge, 0.0),
                                  upper=(-dl_sponge + bw, DH), axis=0)
    emitter_buffer = bd.AlignedBoxRegion(lower=(-dl_sponge, 0.0),
                                         upper=(0.0, DH), axis=0)
    disposer = bd.AlignedBoxRegion(lower=(DL - bw, -bw),
                                   upper=(DL + bw, DH + bw), axis=0)

    case = FishFSICase(
        dx=dx, adaptation=adaptation, grid=grid, eos=eos, material_s=stiff,
        riemann=rs.acoustic_riemann(eos), no_riemann=rs.no_riemann(eos),
        rp=rp, emitter=emitter, emitter_buffer=emitter_buffer,
        disposer=disposer, n_fluid=cap_f, n_fish=n_s, cell_cap=cell_cap,
        k_inner=k_inner, k_contact=k_contact, dl_sponge=dl_sponge)
    return case, fluid, fish


def rebuild_relations(case: FishFSICase, fluid: State, fish: State):
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
    overflow = nl_ff.overflow | nl_fs.overflow | nl_sf.overflow
    return nl_ff, nl_fs, nl_sf, overflow


def init_sim(case: FishFSICase, fluid: State, fish: State) -> FishFSISim:
    nl_ff, nl_fs, nl_sf, ovf = jax.jit(
        partial(rebuild_relations, case))(fluid, fish)
    dtype = fluid["Position"].dtype
    z32 = jnp.zeros((), jnp.int32)
    return FishFSISim(fluid=fluid, fish=fish, nl_ff=nl_ff, nl_fs=nl_fs,
                      nl_sf=nl_sf, time=jnp.zeros((), dtype), n_adv=z32,
                      n_ac=z32, n_s=z32, overflow=ovf)


def free_stream_target(pos, vel, t):
    """FreeStreamVelocity (2d_flow_stream_around_fish.h:90-107): u_ref = 0,
    cosine ramp — the far field stays at rest."""
    u_ref = 0.0
    ramp = jnp.where(t < T_REF,
                     0.5 * u_ref * (1.0 - jnp.cos(jnp.pi * t / T_REF)), u_ref)
    return jnp.broadcast_to(ramp, pos.shape[:1])


def _advection_step(case: FishFSICase, s: FishFSISim) -> FishFSISim:
    kernel, dim = case.kernel, 2
    h = case.adaptation.h
    sigma0 = case.adaptation.sigma0
    fluid, fish = s.fluid, s.fish
    pos_prev = fluid["Position"]   # for the emitter crossing test
    walls = [(fish, s.nl_fs)]

    dt_adv = fd.advection_viscous_time_step(fluid, h, U_F, RHO0_F, MU_F)
    fluid = fd.free_surface_indication(fluid, s.nl_ff, kernel, dim,
                                       contacts=[(fish, s.nl_fs, None)],
                                       spatial_temporal=True)
    fluid = fd.density_summation_freestream(
        fluid, s.nl_ff, kernel, dim, RHO0_F, sigma0,
        contacts=[(fish, s.nl_fs, fish_mod.RHO0_S)])
    fluid = fd.viscous_force(fluid, s.nl_ff, kernel, dim, MU_F, h, walls=walls)
    fluid = fd.transport_velocity_correction(
        fluid, s.nl_ff, kernel, dim, h, coefficient=0.2, walls=walls,
        scope_mask=(fluid["Indicator"] == 0) & fluid["Alive"])

    fish = fsi.viscous_force_from_fluid(fish, fluid, s.nl_sf, kernel, dim,
                                        MU_F, h)
    fish = fsi.update_elastic_normal_direction(fish)

    w0 = kernel.w0(dim)
    c0s = case.material_s.sound_speed

    def mid_cond(carry):
        _, _, rt, _, _ = carry
        return rt < dt_adv

    def mid_body(carry):
        f, so, rt, k_ac, k_s = carry
        dt = jnp.minimum(fd.acoustic_time_step(f, case.eos, h), dt_adv)
        walls_now = [(so, s.nl_fs)]
        f = fd.acoustic_step_1st_half(f, s.nl_ff, kernel, dim, case.eos,
                                      case.riemann, dt, walls=walls_now)
        f = fd.free_stream_velocity_correction(f, free_stream_target,
                                               s.time + rt, RHO0_F)
        so = fsi.pressure_force_from_fluid(so, f, s.nl_sf, kernel, dim,
                                           case.riemann)
        f = fd.acoustic_step_2nd_half(f, s.nl_ff, kernel, dim,
                                      case.no_riemann, dt, walls=walls_now)

        so = fsi.initialize_displacement(so)

        def s_cond(sc):
            _, ds_sum, _ = sc
            return ds_sum < dt

        def s_body(sc):
            so_i, ds_sum, k = sc
            dt_s = jnp.minimum(sd.solid_acoustic_time_step(so_i, c0s, h),
                               dt - ds_sum)
            so_i = fish_mod.impose_active_strain(so_i, s.time + rt + ds_sum,
                                                 origin=(CX, CY))
            so_i = sd.integration_1st_half_pk2(so_i, case.rp, case.material_s,
                                               dt_s, h, w0,
                                               pk1_fn=fish_mod._pk1)
            so_i = sd.integration_2nd_half(so_i, case.rp, dt_s)
            return (so_i, ds_sum + dt_s, k + 1)

        so, _, k_sub = jax.lax.while_loop(
            s_cond, s_body, (so, jnp.zeros_like(dt), jnp.zeros((), jnp.int32)))
        so = fsi.update_average_velocity_acceleration(so, dt)
        return (f, so, rt + dt, k_ac + 1, k_s + k_sub)

    fluid, fish, relax_t, n_ac, n_s_steps = jax.lax.while_loop(
        mid_cond, mid_body,
        (fluid, fish, jnp.zeros_like(dt_adv), jnp.zeros((), jnp.int32),
         jnp.zeros((), jnp.int32)))

    # open-boundary recycling (EmitterInflowInjection / DisposerOutflowDeletion)
    fluid = bd.disposer_outflow_deletion(fluid, case.disposer)
    fluid = bd.emitter_inflow_injection(fluid, case.emitter, prev_pos=pos_prev)
    inj_ovf = fluid.pop("_InjectionOverflow", jnp.zeros((), bool))

    nl_ff, nl_fs, nl_sf, ovf = rebuild_relations(case, fluid, fish)
    return FishFSISim(fluid=fluid, fish=fish, nl_ff=nl_ff, nl_fs=nl_fs,
                      nl_sf=nl_sf, time=s.time + relax_t, n_adv=s.n_adv + 1,
                      n_ac=s.n_ac + n_ac, n_s=s.n_s + n_s_steps,
                      overflow=s.overflow | ovf | inj_ovf)


def make_run_chunk(case: FishFSICase):
    @jax.jit
    def run_chunk(s: FishFSISim, t_target) -> FishFSISim:
        return jax.lax.while_loop(lambda st: st.time < t_target,
                                  lambda st: _advection_step(case, st), s)

    return run_chunk


def fish_center_of_mass(s: FishFSISim) -> np.ndarray:
    m = np.asarray(s.fish["Mass"])
    p = np.asarray(s.fish["Position"])
    return (m[:, None] * p).sum(0) / m.sum()
