"""fsi2 — flow-induced vibration of an elastic beam behind a cylinder.

Scene, constants and the triple-rate loop mirror the reference case
/root/reference/tests/2d_examples/test_2d_fsi2/fsi2.{h,cpp}:
  * channel 11 x 4.1 with a 20*dx inflow sponge, periodic along x,
    wall = top/bottom strips only; cylinder r=0.5 at (2,2) with a
    0.2 x 3.5 trailing beam (one "insert" solid body)
  * fluid: rho0=1, U=1, c=10, Re=100; solid: rho0=10, E=1.4e3, nu=0.4
  * outer: advection dt + density summation + viscous + transport
    correction + FSI viscous force + solid normal update
  * mid: acoustic dt — fluid pressure relaxation (wall+insert contact),
    FSI pressure force, density relaxation (NoRiemann wall variant)
  * inner: solid sub-cycling with averaged-velocity feedback
  * parabolic inflow ramped over t_ref=2 in the sponge, x-periodic wrap.

XLA-native: per-body grids (fluid grid periodic in x, wall/insert grids
plain), whole advection step is one jitted function; solid topology is the
frozen initial configuration.
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
from sphinxsys_jax.core.state import State, make_fluid_state
from sphinxsys_jax.neighbors import grid_from_bounds, build_cell_table, build_neighbor_list
from sphinxsys_jax.neighbors.cell_list import wrap_positions, spatial_sort_permutation
from sphinxsys_jax.physics import fluid as fd
from sphinxsys_jax.physics import fsi
from sphinxsys_jax.physics import general as gd
from sphinxsys_jax.physics import riemann as rs
from sphinxsys_jax.physics import solid as sd
from sphinxsys_jax.utils.hosteval import host_eval

# constants (fsi2.h:16-40)
DL = 11.0
DH = 4.1
CYL_CENTER = (2.0, 2.0)
CYL_R = 0.5
BH = 0.4 * CYL_R            # beam height
BL = 7.0 * CYL_R            # beam length
RHO0_F = 1.0
U_F = 1.0
C_F = 10.0 * U_F
RE = 100.0
MU_F = RHO0_F * U_F * (2.0 * CYL_R) / RE
RHO0_S = 10.0
POISSON = 0.4
YOUNGS = 1.4e3 * RHO0_F * U_F * U_F
T_REF = 2.0  # inflow ramp time


class FSISim(NamedTuple):
    fluid: Any
    solid: Any
    nl_ff: Any      # fluid inner
    nl_fw: Any      # fluid -> wall
    nl_fs: Any      # fluid -> insert solid
    nl_sf: Any      # insert solid -> fluid
    time: jnp.ndarray
    n_adv: jnp.ndarray
    n_ac: jnp.ndarray
    n_s: jnp.ndarray
    overflow: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class FSICase:
    dx: float
    adaptation: SPHAdaptation
    grid_f: Any          # periodic-x fluid grid
    grid_w: Any          # wall grid
    grid_s: Any          # insert grid (covers its motion envelope)
    eos: WeaklyCompressibleFluid
    material_s: SaintVenantKirchhoffSolid
    riemann: rs.AcousticRiemannSolver
    no_riemann: rs.NoRiemannSolver
    wall: State
    wall_table: Any
    rp: sd.ReferencePairs          # solid frozen pairs
    base_mask: jnp.ndarray         # constrained insert particles
    n_fluid: int
    n_wall: int
    n_solid: int
    cell_cap: int
    k_inner: int
    k_contact: int
    dl_sponge: float

    @property
    def kernel(self):
        return self.adaptation.kernel

    @property
    def box(self):
        return self.grid_f.periodic_lengths


def build_case(dx: float = 0.1, dtype=jnp.float32, cell_cap: int = 24,
               k_inner: int = 64, k_contact: int = 40,
               relax_insert: int = 0):
    """`relax_insert` > 0: body-fitted insert IC — the reference's
    RunParticleRelaxation/ReloadParticles branch (fsi2.cpp:52-99)
    relaxes the cylinder+beam particle distribution before the run;
    pass the relaxation iteration count (reference default 1000)."""
    adaptation = SPHAdaptation(spacing=dx, dim=2)
    dl_sponge = dx * 20.0
    bw = dx * 4.0

    channel = G.Box(G.Transform(translation=((DL - dl_sponge) / 2, DH / 2)),
                    halfsize=((DL + dl_sponge) / 2, DH / 2))
    cylinder = G.Ball(center=CYL_CENTER, radius=CYL_R)
    beam = G.Box(G.Transform(translation=(CYL_CENTER[0] + (CYL_R + BL) / 2, CYL_CENTER[1])),
                 halfsize=((CYL_R + BL) / 2, BH / 2))
    water_shape = G.make_complex(("add", channel), ("sub", cylinder), ("sub", beam))
    outer = G.Box(G.Transform(translation=((DL - dl_sponge) / 2, DH / 2)),
                  halfsize=((DL + dl_sponge) / 2 + bw, DH / 2 + bw))
    inner = G.Box(G.Transform(translation=((DL - dl_sponge) / 2, DH / 2)),
                  halfsize=((DL + dl_sponge) / 2 + 2 * bw, DH / 2))
    wall_shape = G.make_complex(("add", outer), ("sub", inner))
    insert_shape = G.make_complex(("add", cylinder), ("add", beam))

    dom_lo = (-dl_sponge - bw, -bw)
    dom_hi = (DL + bw, DH + bw)
    pos_f, vol = generate_lattice(water_shape, dom_lo, dom_hi, dx)
    pos_w, _ = generate_lattice(wall_shape, dom_lo, dom_hi, dx)
    pos_s, _ = generate_lattice(insert_shape, dom_lo, dom_hi, dx)
    if relax_insert:
        from sphinxsys_jax.neighbors import grid_from_bounds as _gfb
        from sphinxsys_jax.physics import relax as rx
        pad = 6 * dx
        grid_rx = _gfb((CYL_CENTER[0] - CYL_R - pad, CYL_CENTER[1] - CYL_R - pad),
                       (CYL_CENTER[0] + CYL_R + BL + pad,
                        CYL_CENTER[1] + CYL_R + pad), adaptation.cutoff)
        pos_s = np.asarray(rx.relax_shape(
            insert_shape, jnp.asarray(pos_s), vol, adaptation, grid_rx,
            n_iterations=relax_insert, cell_cap=cell_cap, k_max=k_inner))

    fluid = make_fluid_state(pos_f, vol, RHO0_F, dtype=dtype)
    fluid = dict(fluid)
    zeros_v = jnp.zeros_like(fluid["Velocity"])
    fluid["ViscousForce"] = zeros_v
    fluid["ViscousForcePrev"] = zeros_v

    from sphinxsys_jax.core.state import make_solid_state

    wall = make_solid_state(pos_w, vol, RHO0_F, dtype=dtype)
    wall = gd.normal_direction_from_shape(wall, wall_shape)

    material_s = SaintVenantKirchhoffSolid(rho0=RHO0_S, youngs_modulus=YOUNGS,
                                           poisson_ratio=POISSON)
    solid = sd.make_elastic_solid_state(pos_s, vol, material_s, dtype=dtype)
    solid = gd.normal_direction_from_shape(solid, insert_shape)
    n_s = solid["Position"].shape[0]
    solid["AverageVelocity"] = jnp.zeros((n_s, 2), dtype=dtype)
    solid["AverageAcceleration"] = jnp.zeros((n_s, 2), dtype=dtype)
    solid["TemporaryPosition"] = solid["Position"]
    for key in ["ViscousForceFromFluid", "PressureForceFromFluid"]:
        solid[key] = jnp.zeros((n_s, 2), dtype=dtype)
        solid["Previous" + key] = jnp.zeros((n_s, 2), dtype=dtype)

    eos = WeaklyCompressibleFluid(rho0=RHO0_F, c0=C_F)

    # grids: fluid periodic along x over the water body bounds (fsi2.cpp:146-147)
    grid_f = grid_from_bounds((-dl_sponge, -bw), (DL, DH + bw), adaptation.cutoff,
                              periodic=(True, False))
    grid_w = grid_from_bounds(dom_lo, dom_hi, adaptation.cutoff)
    grid_s = grid_from_bounds(dom_lo, dom_hi, adaptation.cutoff)

    wall_table = jax.jit(partial(build_cell_table, grid=grid_w, cap=cell_cap))(
        wall["Position"], wall["NReal"])

    # frozen solid topology + B matrix
    @jax.jit
    def _solid_topo(pos):
        table = build_cell_table(pos, jnp.int32(n_s), grid_s, cap=cell_cap)
        nl = build_neighbor_list(pos, jnp.int32(n_s), pos, jnp.int32(n_s), table,
                                 grid_s, adaptation.cutoff, k_max=k_inner,
                                 include_self=False)
        rp = sd.freeze_reference_pairs(pos, nl, adaptation.kernel, 2)
        B = sd.linear_gradient_correction_matrix(rp, solid["VolumetricMeasure"])
        return rp, B, nl.overflow

    rp, B, s_ovf = _solid_topo(solid["Position"])
    solid["LinearGradientCorrectionMatrix"] = B

    # constrained part: cylinder + (not beam) (createBeamBaseShape, fsi2.h:134-141)
    in_cyl = host_eval(cylinder.contains, jnp.asarray(pos_s))
    in_beam = host_eval(beam.contains, jnp.asarray(pos_s))
    base_mask = jnp.asarray(in_cyl & ~in_beam)

    case = FSICase(
        dx=dx, adaptation=adaptation, grid_f=grid_f, grid_w=grid_w, grid_s=grid_s,
        eos=eos, material_s=material_s, riemann=rs.acoustic_riemann(eos),
        no_riemann=rs.no_riemann(eos), wall=wall, wall_table=wall_table, rp=rp,
        base_mask=base_mask, n_fluid=len(pos_f), n_wall=len(pos_w),
        n_solid=n_s, cell_cap=cell_cap, k_inner=k_inner, k_contact=k_contact,
        dl_sponge=dl_sponge)
    return case, fluid, solid


def rebuild_relations(case: FSICase, fluid: State, solid: State):
    """Periodic bounding + cell lists + all four relations
    (fsi2.cpp:265-276)."""
    pos_f = wrap_positions(fluid["Position"], case.grid_f)
    n_f, n_s = fluid["NReal"], solid["NReal"]
    cutoff = case.adaptation.cutoff
    table_f = build_cell_table(pos_f, n_f, case.grid_f, cap=case.cell_cap)
    table_s = build_cell_table(solid["Position"], n_s, case.grid_s, cap=case.cell_cap)
    nl_ff = build_neighbor_list(pos_f, n_f, pos_f, n_f, table_f, case.grid_f,
                                cutoff, k_max=case.k_inner, include_self=False)
    nl_fw = build_neighbor_list(pos_f, n_f, case.wall["Position"], case.wall["NReal"],
                                case.wall_table, case.grid_w, cutoff,
                                k_max=case.k_contact, include_self=True)
    nl_fs = build_neighbor_list(pos_f, n_f, solid["Position"], n_s, table_s,
                                case.grid_s, cutoff, k_max=case.k_contact,
                                include_self=True)
    nl_sf = build_neighbor_list(solid["Position"], n_s, pos_f, n_f, table_f,
                                case.grid_f, cutoff, k_max=case.k_contact,
                                include_self=True)
    overflow = nl_ff.overflow | nl_fw.overflow | nl_fs.overflow | nl_sf.overflow
    return pos_f, nl_ff, nl_fw, nl_fs, nl_sf, overflow


def init_sim(case: FSICase, fluid: State, solid: State) -> FSISim:
    pos_f, nl_ff, nl_fw, nl_fs, nl_sf, ovf = jax.jit(
        partial(rebuild_relations, case))(fluid, solid)
    fluid = dict(fluid)
    fluid["Position"] = pos_f
    dtype = pos_f.dtype
    z32 = jnp.zeros((), jnp.int32)
    return FSISim(fluid=fluid, solid=solid, nl_ff=nl_ff, nl_fw=nl_fw,
                  nl_fs=nl_fs, nl_sf=nl_sf, time=jnp.zeros((), dtype),
                  n_adv=z32, n_ac=z32, n_s=z32, overflow=ovf)


def inflow_velocity(fluid: State, t, dl_sponge: float):
    """InflowVelocityCondition with the fsi2 parabolic ramp profile
    (fsi2.h:146-167), applied in the sponge x < 0."""
    pos, vel = fluid["Position"], fluid["Velocity"]
    u_ave = jnp.where(t < T_REF, 0.5 * U_F * (1.0 - jnp.cos(jnp.pi * t / T_REF)), U_F)
    y_local = pos[:, 1] - DH / 2
    h = DH / 2
    vx_target = 1.5 * u_ave * (1.0 - y_local * y_local / (h * h))
    in_buffer = (pos[:, 0] < 0.0) & (pos[:, 0] >= -dl_sponge - 1e-9)
    out = dict(fluid)
    out["Velocity"] = jnp.stack(
        [jnp.where(in_buffer, vx_target.astype(vel.dtype), vel[:, 0]), vel[:, 1]], axis=-1)
    return out


def _advection_step(case: FSICase, s: FSISim) -> FSISim:
    kernel, dim = case.kernel, 2
    h = case.adaptation.h
    sigma0 = case.adaptation.sigma0
    box = case.box
    fluid, solid = s.fluid, s.solid
    walls = [(case.wall, s.nl_fw), (solid, s.nl_fs)]

    dt_adv = fd.advection_viscous_time_step(fluid, h, U_F, RHO0_F, MU_F)
    fluid = fd.density_summation(fluid, s.nl_ff, kernel, dim, RHO0_F, sigma0,
                                 contacts=[(case.wall, s.nl_fw, RHO0_F),
                                           (solid, s.nl_fs, RHO0_S)],
                                 free_surface=False, box=box)
    fluid = fd.viscous_force(fluid, s.nl_ff, kernel, dim, MU_F, h, box=box,
                             walls=walls)
    fluid = fd.transport_velocity_correction(fluid, s.nl_ff, kernel, dim, h,
                                             coefficient=0.25, box=box,
                                             walls=walls)
    # FSI viscous force on the insert + normal update (fsi2.cpp:216-219)
    solid = fsi.viscous_force_from_fluid(solid, fluid, s.nl_sf, kernel, dim,
                                         MU_F, h, box=box)
    solid = fsi.update_elastic_normal_direction(solid)

    w0 = kernel.w0(dim)
    c0s = case.material_s.sound_speed

    def mid_cond(carry):
        _, _, rt, _, _ = carry
        return rt < dt_adv

    def mid_body(carry):
        f, so, rt, k_ac, k_s = carry
        dt = jnp.minimum(fd.acoustic_time_step(f, case.eos, h), dt_adv)
        walls_now = [(case.wall, s.nl_fw), (so, s.nl_fs)]
        f = fd.acoustic_step_1st_half(f, s.nl_ff, kernel, dim, case.eos,
                                      case.riemann, dt, box=box, walls=walls_now)
        so = fsi.pressure_force_from_fluid(so, f, s.nl_sf, kernel, dim,
                                           case.riemann, box=box)
        f = fd.acoustic_step_2nd_half(f, s.nl_ff, kernel, dim, case.no_riemann,
                                      dt, box=box, walls=walls_now)

        # solid sub-cycling (fsi2.cpp:233-246)
        so = fsi.initialize_displacement(so)

        def s_cond(sc):
            _, ds_sum, _ = sc
            return ds_sum < dt

        def s_body(sc):
            so_i, ds_sum, k = sc
            dt_s = jnp.minimum(sd.solid_acoustic_time_step(so_i, c0s, h),
                               dt - ds_sum)
            so_i = sd.integration_1st_half_pk2(so_i, case.rp, case.material_s,
                                               dt_s, h, w0)
            so_i = sd.fix_constraint(so_i, case.base_mask)
            so_i = sd.integration_2nd_half(so_i, case.rp, dt_s)
            return (so_i, ds_sum + dt_s, k + 1)

        so, _, k_sub = jax.lax.while_loop(
            s_cond, s_body, (so, jnp.zeros_like(dt), jnp.zeros((), jnp.int32)))
        so = fsi.update_average_velocity_acceleration(so, dt)
        f = inflow_velocity(f, s.time + rt + dt, case.dl_sponge)
        return (f, so, rt + dt, k_ac + 1, k_s + k_sub)

    fluid, solid, relax_t, n_ac, n_s_steps = jax.lax.while_loop(
        mid_cond, mid_body,
        (fluid, solid, jnp.zeros_like(dt_adv), jnp.zeros((), jnp.int32),
         jnp.zeros((), jnp.int32)))

    pos_f, nl_ff, nl_fw, nl_fs, nl_sf, ovf = rebuild_relations(case, fluid, solid)
    fluid = dict(fluid)
    fluid["Position"] = pos_f
    return FSISim(fluid=fluid, solid=solid, nl_ff=nl_ff, nl_fw=nl_fw,
                  nl_fs=nl_fs, nl_sf=nl_sf, time=s.time + relax_t,
                  n_adv=s.n_adv + 1, n_ac=s.n_ac + n_ac,
                  n_s=s.n_s + n_s_steps, overflow=s.overflow | ovf)


def make_run_chunk(case: FSICase):
    @jax.jit
    def run_chunk(s: FSISim, t_target) -> FSISim:
        return jax.lax.while_loop(lambda st: st.time < t_target,
                                  lambda st: _advection_step(case, st), s)

    return run_chunk


def beam_tip_displacement(case: FSICase, s: FSISim):
    """y-displacement of the particle nearest the beam tip observer
    (0.5*(BRT+BRB), fsi2.cpp:47)."""
    tip = np.asarray([CYL_CENTER[0] + CYL_R + BL, CYL_CENTER[1]])
    pos0 = np.asarray(s.solid["InitialPosition"])[: case.n_solid]
    i = int(np.argmin(np.linalg.norm(pos0 - tip, axis=1)))
    d = np.asarray(s.solid["Position"][i] - s.solid["InitialPosition"][i])
    return float(d[0]), float(d[1])


def tip_observer(case: FSICase, solid: State):
    """Reference-compatible beam-tip observer.

    fsi2.cpp:46-48,103,166: a single observer particle at 0.5*(BRT+BRB) =
    (6.0, 2.0) with a contact relation to the insert body that is built
    ONCE and never updated — the interpolation weights W(r0)*Vol are frozen
    at the initial configuration, so reading the beam's current Position
    through them tracks the material tip.  Returns (indices, weights).
    """
    tip = np.asarray([CYL_CENTER[0] + CYL_R + BL, CYL_CENTER[1]])
    pos0 = np.asarray(solid["InitialPosition"])[: case.n_solid]
    r = np.linalg.norm(pos0 - tip, axis=1)
    cutoff = case.adaptation.cutoff
    idx = np.nonzero(r < cutoff)[0]
    kernel = case.kernel
    w = np.asarray([float(kernel.W(jnp.asarray(ri, pos0.dtype), 2)) for ri in r[idx]])
    w = w * np.asarray(solid["VolumetricMeasure"])[idx]
    return jnp.asarray(idx), jnp.asarray(w / (w.sum() + 1e-15), pos0.dtype)


def observe_tip(s: FSISim, idx, weights):
    """Interpolated tip Position with frozen weights (general_interpolation.h
    BaseInterpolation::interaction, normalized by total weight)."""
    return jnp.sum(s.solid["Position"][idx] * weights[:, None], axis=0)


# ---------------------------------------------------------------------------
# Block-engine binding (engine/scene.py) — one scene, every engine
# ---------------------------------------------------------------------------

def inflow_velocity_b(fb, t, dl_sponge: float):
    """inflow_velocity in block layout (fsi2.h:146-167): works on any
    trailing-channel layout via broadcasting + the SlotMask."""
    pos, vel = fb["Position"], fb["Velocity"]
    u_ave = jnp.where(t < T_REF,
                      0.5 * U_F * (1.0 - jnp.cos(jnp.pi * t / T_REF)), U_F)
    y_local = pos[..., 1] - DH / 2
    h = DH / 2
    vx_target = (1.5 * u_ave * (1.0 - y_local * y_local / (h * h))).astype(
        vel.dtype)
    in_buffer = (pos[..., 0] < 0.0) & (pos[..., 0] >= -dl_sponge - 1e-9) \
        & fb["SlotMask"]
    out = dict(fb)
    out["Velocity"] = jnp.stack(
        [jnp.where(in_buffer, vx_target, vel[..., 0]), vel[..., 1]], axis=-1)
    return out


def build_block_case(dx: float = 0.1, dtype=jnp.float32, cap: int = 12,
                     c_max: int | None = None):
    """fsi2 on the cell-block engine via the generic scene runner.

    Block-engine specifics (same reasoning as the retired fsi2_block.py):
      * ONE periodic-x grid; the wall strips' hand-made x-overhang images
        are TRIMMED (the wrap supplies them) — identical wall geometry;
      * wall + insert merge into ONE wall-type contact body whose slots
        re-freeze per advection step (wall_state_fn) and whose channels
        refresh per acoustic iteration;
      * the solid keeps the gather formulation (tiny next to the fluid),
        coupled through direct block-window gathers (physics/fsi_blocks).

    Returns (BlockScene, fluid, solid); init with
    `scene_mod.init_sim(scene, fluid, aux=make_aux(solid))` or simply
    `init_block_sim(scene, fluid, solid)`."""
    import numpy as _np

    from sphinxsys_jax.engine import block_fluid as eng_mod
    from sphinxsys_jax.engine import scene as sc
    from sphinxsys_jax.engine.block_fluid import BlockEngine
    from sphinxsys_jax.neighbors.cell_blocks import dense_cell_map
    from sphinxsys_jax.neighbors.cell_list import wrap_positions
    from sphinxsys_jax.physics import fsi
    from sphinxsys_jax.physics import fsi_blocks as fsb

    base, fluid, solid = build_case(dx=dx, dtype=dtype)
    grid = base.grid_f
    c_max = c_max or grid.ncells
    c_max_wall = eng_mod.round_to(grid.ncells, 32)
    eng = BlockEngine(
        grid=grid, kernel=base.kernel, eos=base.eos, riemann1=base.riemann,
        riemann2=base.no_riemann, rho0=RHO0_F, sigma0=base.adaptation.sigma0,
        h=base.adaptation.h, speed_ref=U_F, dim=2, mu=MU_F, tvc_coef=0.25,
        tvc_limiter=None, free_surface=False, cap=cap, c_max=c_max,
        cap_ac_dt=True)

    # trim the wall x-overhangs: the periodic wrap supplies those images
    wx = _np.asarray(base.wall["Position"][:, 0])
    wall_valid = jnp.asarray((wx >= -base.dl_sponge - 1e-9) & (wx < DL - 1e-9))
    wall_valid = jnp.concatenate(
        [wall_valid, jnp.ones((base.n_solid,), bool)], axis=0)

    nw = base.n_wall
    kernel, dim, h = base.kernel, 2, base.adaptation.h
    w0 = kernel.w0(dim)
    c0s = base.material_s.sound_speed

    def wall_state_fn(aux):
        so = aux["solid"]
        wall = base.wall
        z = jnp.zeros((nw, 2), dtype=wall["Position"].dtype)
        return {
            "Position": jnp.concatenate(
                [wrap_positions(wall["Position"], grid),
                 wrap_positions(so["Position"], grid)], axis=0),
            "VolumetricMeasure": jnp.concatenate(
                [wall["VolumetricMeasure"], so["VolumetricMeasure"]], axis=0),
            "AverageVelocity": jnp.concatenate(
                [z, so["AverageVelocity"]], axis=0),
            "AverageAcceleration": jnp.concatenate(
                [z, so["AverageAcceleration"]], axis=0),
            "NormalDirection": jnp.concatenate(
                [wall["NormalDirection"], so["NormalDirection"]], axis=0),
        }

    def post_prep(fb, aux, t):
        # FSI viscous force on the insert + normal update (fsi2.cpp:216-219)
        so = fsb.viscous_force_from_fluid_b(aux["solid"], fb, aux["sol_win"],
                                            kernel, dim, MU_F, h, box=eng.box)
        so = fsi.update_elastic_normal_direction(so)
        return fb, dict(aux, solid=so)

    def after_first_half(f, aux, dt, t):
        so = fsb.pressure_force_from_fluid_b(aux["solid"], f, aux["sol_win"],
                                             kernel, dim, base.riemann,
                                             box=eng.box)
        return f, dict(aux, solid=so)

    def post_acoustic(f, aux, dt, t_next):
        # solid sub-cycling (fsi2.cpp:233-246)
        so = fsi.initialize_displacement(aux["solid"])

        def s_cond(sc_):
            _, ds_sum, _ = sc_
            return ds_sum < dt

        def s_body(sc_):
            so_i, ds_sum, k = sc_
            dt_s = jnp.minimum(sd.solid_acoustic_time_step(so_i, c0s, h),
                               dt - ds_sum)
            so_i = sd.integration_1st_half_pk2(so_i, base.rp, base.material_s,
                                               dt_s, h, w0)
            so_i = sd.fix_constraint(so_i, base.base_mask)
            so_i = sd.integration_2nd_half(so_i, base.rp, dt_s)
            return (so_i, ds_sum + dt_s, k + 1)

        so, _, k_sub = jax.lax.while_loop(
            s_cond, s_body,
            (so, jnp.zeros_like(dt), jnp.zeros((), jnp.int32)))
        so = fsi.update_average_velocity_acceleration(so, dt)
        f = inflow_velocity_b(f, t_next, base.dl_sponge)
        return f, dict(aux, solid=so, n_s=aux["n_s"] + k_sub)

    def rebuild_aux(bm_f, aux):
        dm_f = dense_cell_map(bm_f.occ_cells, grid.ncells, bm_f.c_max)
        sol_win = fsb.solid_windows(aux["solid"]["Position"], grid, bm_f,
                                    dm_f)
        return dict(aux, sol_win=sol_win)

    scene = sc.moving_wall_scene(
        base, eng=eng, wall_state_fn=wall_state_fn, wall_valid=wall_valid,
        c_max_wall=c_max_wall,
        hooks=sc.Hooks(post_prep=post_prep, after_first_half=after_first_half,
                       post_acoustic=post_acoustic, rebuild_aux=rebuild_aux),
        wrap=True)
    return scene, fluid, solid


def init_block_sim(scene, fluid, solid):
    from sphinxsys_jax.engine import scene as sc

    aux = {"solid": dict(solid), "sol_win": None,
           "n_s": jnp.zeros((), jnp.int32)}
    return sc.init_sim(scene, fluid, aux=aux)
