"""Multi-resolution free-stream flow around a cylinder (Re = 100).

Mirrors /root/reference/tests/2d_examples/test_2d_free_stream_around_
cylinder_mr/ : a 30 x 16 channel with an inlet sponge, free-stream ramp
U = 1, a horizontal refinement strip (y in [5, 11], 2x refined — the
reference's AdaptiveWithinShape level-1 region) containing the cylinder
(r = 1 at (10, 8)), and a rigid cylinder wall body at dx/4 spacing
(defineAdaptationRatios(1.15, 4.0)).  Every fluid op runs with
per-particle smoothing lengths (physics/fluid_adaptive.py) over the
multi-level neighbor search; open boundaries recycle particles
emitter -> disposer exactly like the fish case.  Because the refinement
strip is axis-aligned along the WHOLE channel (including the sponge),
recycled particles re-enter at the same y and keep a consistent size.

Validation: the reference ships Cylinder_TotalViscousForceFromFluid DTW
databases (regression_test_tool/) — the drag history is the production
target; CI asserts startup behavior (drag direction/magnitude scale,
strip integrity, no overflow).
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
from sphinxsys_jax.core.kernels import WendlandC2
from sphinxsys_jax.core.materials import WeaklyCompressibleFluid
from sphinxsys_jax.core.state import make_fluid_state, make_solid_state
from sphinxsys_jax.neighbors import (build_cell_table, build_neighbor_list,
                                     grid_from_bounds)
from sphinxsys_jax.neighbors.multilevel import (build_adaptive_neighbor_list,
                                                build_multilevel_tables)
from sphinxsys_jax.physics import boundary as bd
from sphinxsys_jax.physics import fluid as fd
from sphinxsys_jax.physics import fluid_adaptive as fa
from sphinxsys_jax.physics import fsi
from sphinxsys_jax.physics import riemann as rs

DL = 30.0
DH = 16.0
DX_REF = 0.4
DL_SPONGE = DX_REF * 20.0
BW = 4.0 * DX_REF
CX, CY = 10.0, 0.5 * DH
R_CYL = 1.0
STRIP_LO, STRIP_HI = 5.0, 11.0
# lattice CUT planes sit midway between the last coarse row (4.6/11.4)
# and the first fine row (4.9/11.1): each side ends half its own spacing
# from the interface — cutting both lattices at exactly 5.0/11.0 leaves a
# half-spacing void on one side and an overlap on the other (measured
# rho 0.75/1.34 at init)
CUT_LO, CUT_HI = 4.8, 11.2
RAMP_W = 2.0 * DX_REF           # hr transition band at the strip edges
RHO0_F = 1.0
U_F = 1.0
C_F = 10.0 * U_F
RE = 100.0
MU_F = RHO0_F * U_F * (2.0 * R_CYL) / RE
T_REF = 2.0


class MRCylSim(NamedTuple):
    fluid: Any
    nl_ff: Any
    nl_fw: Any      # fluid -> cylinder (adaptive)
    nl_wf: Any      # cylinder -> fluid (fine kernel)
    time: jnp.ndarray
    n_adv: jnp.ndarray
    n_ac: jnp.ndarray
    overflow: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class MRCylCase:
    dx: float
    adaptation: SPHAdaptation
    eos: WeaklyCompressibleFluid
    riemann: Any
    no_riemann: Any
    cylinder: Any
    wall_table: Any
    emitter: Any
    emitter_buffer: Any
    disposer: Any
    n_fluid: int         # capacity
    n_cyl: int
    refine: bool
    cap: int
    k_levels: tuple
    k_wall: tuple
    k_wf: int
    grid_fine: Any       # fine-cutoff grid for the cylinder->fluid NL

    @property
    def kernel(self):
        return self.adaptation.kernel

    @property
    def kernel_fine(self):
        # all cylinder-contact pairs involve strip (hr = 2) fluid
        return WendlandC2(h=self.adaptation.h / (2.0 if self.refine else 1.0))

    @property
    def bounds(self):
        return ((-DL_SPONGE - BW, -BW), (DL + BW, DH + BW))


def _strip_hr(pos):
    """Smoothing-length ratio field: 2 deep inside the strip, ramping to 1
    at the edges (a sharp 2x h jump starves interface kernels — the
    load-bearing finding from the MR Taylor-Green case)."""
    d_edge = np.minimum(pos[:, 1] - CUT_LO, CUT_HI - pos[:, 1])
    return 1.0 + np.clip(d_edge / RAMP_W, 0.0, 1.0)


def _relax_near_cylinder(pos_f, pos_w, dx, n_iter_cyl: int = 600,
                         n_iter_f: int = 500):
    """Body-fitted relaxed IC — the reference's --relax branch
    (mr_free_stream_around_cylinder.cpp:68-113): level-set-corrected
    relaxation of the cylinder body, then relaxation of the fine-strip
    fluid annulus against it (inner + contact residual,
    RelaxationStepLevelSetCorrectionComplex) with the surrounding lattice
    FROZEN as the far-field boundary.  The unrelaxed lattice start is what
    put the steady viscous drag ~2x above the reference DB band (round-3
    finding): carving the lattice leaves a stair-stepped fluid boundary +
    a rho ~ 0.81 first ring, i.e. dx/4-scale roughness at the boundary
    layer scale."""
    from sphinxsys_jax.physics import relax as rx
    from sphinxsys_jax.physics.pair import pair_geometry
    from sphinxsys_jax.neighbors.neighbor_list import gather

    ball = G.Ball(center=(CX, CY), radius=R_CYL)

    # 1. cylinder body (RelaxationStepLevelSetCorrectionInner)
    dxw = dx / 4.0
    ad_w = SPHAdaptation(spacing=dxw, dim=2)
    grid_w = grid_from_bounds((CX - R_CYL - 4 * dxw, CY - R_CYL - 4 * dxw),
                              (CX + R_CYL + 4 * dxw, CY + R_CYL + 4 * dxw),
                              ad_w.cutoff)
    pos_w_rel = np.asarray(rx.relax_shape(
        ball, jnp.asarray(pos_w, jnp.float64), dxw * dxw, ad_w, grid_w,
        n_iterations=n_iter_cyl, cell_cap=24, k_max=48))

    # 2. fluid annulus (fine region, hr = 2 throughout): movers r < R_MOVE,
    # frozen lattice collar out to R_REGION participates in the sums
    dxf = dx / 2.0
    ad_f = SPHAdaptation(spacing=dxf, dim=2)
    kernel = ad_f.kernel
    r = np.hypot(pos_f[:, 0] - CX, pos_f[:, 1] - CY)
    R_MOVE, R_REGION = 2.4, 3.1
    region = r < R_REGION
    frozen = jnp.asarray(r[region] >= R_MOVE)
    p0 = jnp.asarray(pos_f[region], jnp.float64)
    n = p0.shape[0]
    vol_f = jnp.full((n,), dxf * dxf, p0.dtype)
    grid_f = grid_from_bounds(
        (CX - R_REGION - 4 * dxf, CY - R_REGION - 4 * dxf),
        (CX + R_REGION + 4 * dxf, CY + R_REGION + 4 * dxf), ad_f.cutoff)
    cylp = jnp.asarray(pos_w_rel, p0.dtype)
    ncyl = jnp.asarray(len(pos_w_rel), jnp.int32)
    table_c = build_cell_table(cylp, ncyl, grid_f, cap=48)
    vol_w = dxw * dxw
    outside = G.InverseShape(ball)

    @jax.jit
    def run(p):
        def body(_, p):
            table = build_cell_table(p, jnp.int32(n), grid_f, cap=24)
            nl = build_neighbor_list(p, jnp.int32(n), p, jnp.int32(n),
                                     table, grid_f, ad_f.cutoff, k_max=48,
                                     include_self=False)
            res = rx.relaxation_residual(p, vol_f, nl, kernel, 2)
            # contact residual vs the relaxed cylinder
            # (RelaxationResidual<Contact<>>: same -2 dW V e form)
            nlc = build_neighbor_list(p, jnp.int32(n), cylp, ncyl, table_c,
                                      grid_f, ad_f.cutoff, k_max=40,
                                      include_self=True)
            pgc = pair_geometry(p, cylp, nlc, kernel, 2, need_W=False)
            res = res - jnp.sum((2.0 * pgc.dW * vol_w)[..., None] * pgc.e,
                                axis=1)
            res = jnp.where(frozen[:, None], 0.0, res)
            scale = rx.relaxation_scaling(res, ad_f.h)
            p = p + 0.5 * res * scale
            return rx.surface_bounding(p, outside, dxf)

        return jax.lax.fori_loop(0, n_iter_f, body, p)

    p_rel = np.asarray(run(p0))
    pos_f = pos_f.copy()
    pos_f[region] = p_rel
    return pos_f, pos_w_rel


def build_case(dx: float = DX_REF, dtype=jnp.float32, reserve: float = 0.3,
               cap: int = 64, k_levels=(96, 128), k_wall=(56,),
               k_wf: int = 48, refine: bool = True, relax_ic: bool = True):
    """`refine=False` is the uniform-resolution CONTROL: same scene and
    machinery with hr = 1 everywhere (isolates MR-interface effects).
    `relax_ic` (default, matching the reference's reload-from-relaxation
    CTest setup) runs the body-fitted relaxation of _relax_near_cylinder."""
    adaptation = SPHAdaptation(spacing=dx, dim=2)

    def in_strip(p):
        if not refine:
            return np.zeros(len(p), bool)
        return (p[:, 1] > CUT_LO) & (p[:, 1] < CUT_HI)

    def in_cyl(p, margin=0.0):
        return np.hypot(p[:, 0] - CX, p[:, 1] - CY) < R_CYL + margin

    # coarse lattice outside the strip, fine (dx/2) inside, cylinder cut out
    xs_c = np.arange(-DL_SPONGE + dx / 2, DL, dx)
    ys_c = np.arange(dx / 2, DH, dx)
    pos_c = np.stack(np.meshgrid(xs_c, ys_c, indexing="ij"), -1).reshape(-1, 2)
    pos_c = pos_c[~in_strip(pos_c) & ~in_cyl(pos_c, margin=0.5 * dx)]
    xs_f = np.arange(-DL_SPONGE + dx / 4, DL, dx / 2)
    ys_f = np.arange(dx / 4, DH, dx / 2)
    pos_f = np.stack(np.meshgrid(xs_f, ys_f, indexing="ij"), -1).reshape(-1, 2)
    pos_f = pos_f[in_strip(pos_f) & ~in_cyl(pos_f, margin=0.5 * dx / 2)]

    # cylinder wall lattice at dx/4 (relaxed below when relax_ic)
    dxw = dx / 4.0
    xs_w = np.arange(CX - R_CYL, CX + R_CYL + dxw, dxw)
    pos_w = np.stack(np.meshgrid(xs_w, xs_w - (CX - CY), indexing="ij"),
                     -1).reshape(-1, 2)
    # wall lattice strictly INSIDE the circle (surface particles at
    # r <= R - dxw/2) so the nearest fluid-wall gap is ~(dxf + dxw)/2
    pos_w = pos_w[in_cyl(pos_w, margin=-0.5 * dxw)]

    if relax_ic and refine:
        pos_f, pos_w = _relax_near_cylinder(pos_f, pos_w, dx)

    pos = np.concatenate([pos_c, pos_f])
    vols = np.concatenate([np.full(len(pos_c), dx * dx),
                           np.full(len(pos_f), (dx / 2) ** 2)])
    hr = np.ones(len(pos))
    hr[len(pos_c):] = _strip_hr(pos_f)

    n_f = len(pos)
    cap_f = int(n_f * (1.0 + reserve))
    fluid = dict(make_fluid_state(pos, dx * dx, RHO0_F, capacity=cap_f,
                                  dtype=dtype))
    volp = np.concatenate([vols, np.full(cap_f - n_f, (dx / 2) ** 2)])
    hrp = np.concatenate([hr, np.full(cap_f - n_f, 1.0)])
    fluid["VolumetricMeasure"] = jnp.asarray(volp, dtype)
    fluid["Mass"] = jnp.asarray(RHO0_F * volp, dtype)
    fluid["SmoothingLengthRatio"] = jnp.asarray(hrp, dtype)
    fluid["Alive"] = jnp.arange(cap_f) < n_f
    zeros_v = jnp.zeros((cap_f, 2), dtype)
    fluid["ViscousForce"] = zeros_v
    fluid["ViscousForcePrev"] = zeros_v
    fluid["Indicator"] = jnp.zeros(cap_f, jnp.int32)
    fluid["PreviousSurfaceIndicator"] = jnp.ones(cap_f, jnp.int32)
    fluid["PositionDivergence"] = jnp.zeros(cap_f, dtype)
    # startup body force U_f/t_ref ramp (StartupAcceleration): applied as a
    # time-dependent ForcePrior inside the step (delta convention)
    fluid["ForcePrior"] = zeros_v
    fluid["StartupForcePrev"] = zeros_v

    # cylinder wall body at dx/4 (defineAdaptationRatios(1.15, 4.0));
    # its TABLE level is the fine fluid level (pair h is the fluid's)
    cyl = dict(make_solid_state(pos_w, dxw * dxw, RHO0_F, dtype=dtype))
    rvec = pos_w - np.asarray([CX, CY])
    rn = np.linalg.norm(rvec, axis=1, keepdims=True)
    cyl["NormalDirection"] = jnp.asarray(rvec / np.maximum(rn, 1e-12), dtype)
    cyl["SmoothingLengthRatio"] = jnp.full((len(pos_w),),
                                           2.0 if refine else 1.0, dtype)
    cyl["AverageVelocity"] = jnp.zeros((len(pos_w), 2), dtype)
    cyl["AverageAcceleration"] = jnp.zeros((len(pos_w), 2), dtype)
    cyl["Force"] = jnp.zeros((len(pos_w), 2), dtype)
    cyl["ForcePrior"] = jnp.zeros((len(pos_w), 2), dtype)
    for key in ("ViscousForceFromFluid", "PressureForceFromFluid"):
        cyl[key] = jnp.zeros((len(pos_w), 2), dtype)
        cyl["Previous" + key] = jnp.zeros((len(pos_w), 2), dtype)

    lo, hi = (-DL_SPONGE - BW, -BW), (DL + BW, DH + BW)
    h_ref = adaptation.h
    # the cylinder sits deep inside the fine strip: every fluid-cylinder
    # pair is fine-level (pair radius = kernel_size * h_ref/2), so the
    # contact search runs on a plain FINE grid — the multilevel ladder's
    # coarse-level raw search would need k ~ 200 for a dx/4 body
    cut_wall = adaptation.cutoff / (2.0 if refine else 1.0)
    grid_fine = grid_from_bounds(lo, hi, cut_wall)
    wall_table = jax.jit(lambda p: build_cell_table(
        p, jnp.int32(len(pos_w)), grid_fine, cap=4 * cap))(cyl["Position"])

    emitter = bd.AlignedBoxRegion(lower=(-DL_SPONGE, 0.0),
                                  upper=(-DL_SPONGE + BW, DH), axis=0)
    emitter_buffer = bd.AlignedBoxRegion(lower=(-DL_SPONGE, 0.0),
                                         upper=(0.0, DH), axis=0)
    # delete only PAST the outlet plane x = DL (the reference's
    # DisposerOutflowDeletion checkUpperBound semantics,
    # fluid_boundary.cpp:98-106).  A band that starts INSIDE the domain
    # carves a standing vacuum at the outlet: measured n_alive growth
    # +7.5%/10s and a monotonically rising pressure drag (fp 0.58 -> 5.6
    # over t = 4..12) before this fix.
    disposer = bd.AlignedBoxRegion(lower=(DL, -BW),
                                   upper=(DL + 2 * BW, DH + BW), axis=0)

    eos = WeaklyCompressibleFluid(rho0=RHO0_F, c0=C_F)
    case = MRCylCase(dx=dx, adaptation=adaptation, eos=eos,
                     riemann=rs.acoustic_riemann(eos),
                     no_riemann=rs.no_riemann(eos), cylinder=cyl,
                     wall_table=wall_table, emitter=emitter,
                     emitter_buffer=emitter_buffer, disposer=disposer,
                     n_fluid=cap_f, n_cyl=len(pos_w), refine=refine, cap=cap,
                     k_levels=tuple(k_levels), k_wall=tuple(k_wall),
                     k_wf=k_wf, grid_fine=grid_fine)
    return case, fluid


def rebuild_relations(case: MRCylCase, fluid):
    lo, hi = case.bounds
    h_ref = case.adaptation.h
    pos = fluid["Position"]
    hr = fluid["SmoothingLengthRatio"]
    alive_n = jnp.sum(fluid["Alive"].astype(jnp.int32))
    valid = fluid["Alive"]
    n = pos.shape[0]
    ml = build_multilevel_tables(pos, valid, hr, lo, hi, h_ref,
                                 n_levels=2, cap=case.cap)
    nl_ff = build_adaptive_neighbor_list(pos, valid, hr, pos, hr, ml, 2.0,
                                         h_ref,
                                         k_max_per_level=list(case.k_levels))
    cut_wall = case.adaptation.cutoff / (2.0 if case.refine else 1.0)
    nl_fw = build_neighbor_list(pos, valid, case.cylinder["Position"],
                                jnp.int32(case.n_cyl), case.wall_table,
                                case.grid_fine, cut_wall,
                                k_max=case.k_wall[0], include_self=True)
    # cylinder -> fluid at the FINE cutoff (all contact fluid is strip)
    table_f = build_cell_table(pos, valid, case.grid_fine, cap=case.cap)
    nl_wf = build_neighbor_list(case.cylinder["Position"],
                                jnp.int32(case.n_cyl), pos, valid, table_f,
                                case.grid_fine, cut_wall,
                                k_max=case.k_wf, include_self=True)
    ovf = nl_ff.overflow | nl_fw.overflow | nl_wf.overflow
    return nl_ff, nl_fw, nl_wf, ovf


def init_sim(case: MRCylCase, fluid) -> MRCylSim:
    nl_ff, nl_fw, nl_wf, ovf = jax.jit(partial(rebuild_relations, case))(fluid)
    dtype = fluid["Position"].dtype
    z32 = jnp.zeros((), jnp.int32)
    return MRCylSim(fluid=fluid, nl_ff=nl_ff, nl_fw=nl_fw, nl_wf=nl_wf,
                    time=jnp.zeros((), dtype), n_adv=z32, n_ac=z32,
                    overflow=ovf)


def free_stream_target(pos, vel, t):
    """FreeStreamVelocity (mr_free_stream_around_cylinder.h:74-89)."""
    ramp = jnp.where(t < T_REF,
                     0.5 * U_F * (1.0 - jnp.cos(jnp.pi * t / T_REF)), U_F)
    return jnp.broadcast_to(ramp, pos.shape[:1])


def _startup_force(fluid, t):
    """Startup body force — the reference's StartupAcceleration EXACTLY
    (external_force.h:59-73): a(t) = 0.5 pi sin(pi t/T) U/T for t < T, 0
    after.  Its impulse is exactly U (NOT 2U: the 0.5 pi sin average is 1),
    i.e. a smooth global ramp v(t) = U (1 - cos(pi t/T))/2 ending at U with
    no overshoot.  The round-3 "gentler" half-impulse cosine ramp was the
    ROOT CAUSE of the 2x steady drag: it left the downstream bulk at
    ~U/2 (measured 0.56 at t=2..10) while the sponge inflow kept ramming
    U into it — a permanent pile-up at the cylinder (bypass rings at
    1.25 U), vertical spill through the free surfaces, and fv ~ 0.6-0.8
    vs the reference band 0.30-0.38."""
    a = jnp.where(t < T_REF,
                  0.5 * jnp.pi * jnp.sin(jnp.pi * t / T_REF) * (U_F / T_REF),
                  0.0)
    force = jnp.stack([a * fluid["Mass"],
                       jnp.zeros_like(fluid["Mass"])], axis=-1)
    force = jnp.where(fluid["Alive"][:, None], force, 0.0)
    out = dict(fluid)
    # BaseForcePrior delta convention (force_prior.hpp): an OVERWRITE here
    # clobbers the viscous force folded into ForcePrior by the previous
    # advection step, reducing the effective viscosity in the momentum
    # equation to the per-step viscous DELTA (~0) — measured as near-wall
    # slip and a steady viscous drag 2.3x the reference DB band (the
    # round-3/4 "2x drag" root cause).
    out["ForcePrior"] = fluid["ForcePrior"] + force - fluid["StartupForcePrev"]
    out["StartupForcePrev"] = force
    return out


def _inflow_condition(fluid, region, t, relaxation: float = 0.1):
    """InflowVelocityCondition in the sponge: relax vx toward the ramp."""
    pos, vel = fluid["Position"], fluid["Velocity"]
    target = free_stream_target(pos, vel, t)
    in_buf = region.contains(pos) & fluid["Alive"]
    vx = jnp.where(in_buf, vel[:, 0] + relaxation * (target - vel[:, 0]),
                   vel[:, 0])
    out = dict(fluid)
    out["Velocity"] = jnp.stack([vx, vel[:, 1]], axis=-1)
    return out


def _advection_step(case: MRCylCase, s: MRCylSim) -> MRCylSim:
    kernel, dim = case.kernel, 2
    h_ref = case.adaptation.h
    h_fine = h_ref / (2.0 if case.refine else 1.0)
    fluid = s.fluid
    cyl = case.cylinder
    pos_prev = fluid["Position"]
    walls = [(cyl, s.nl_fw)]

    fluid = _startup_force(fluid, s.time)
    dt_adv = fd.advection_viscous_time_step(fluid, h_fine, U_F, RHO0_F, MU_F)
    fluid = fa.free_surface_indication_adaptive(fluid, s.nl_ff, kernel, dim,
                                                walls=walls,
                                                spatial_temporal=True)
    fluid = fa.density_summation_freestream_adaptive(
        fluid, s.nl_ff, kernel, dim, RHO0_F, wall=cyl, nl_wall=s.nl_fw)
    fluid = fa.viscous_force_adaptive(fluid, s.nl_ff, kernel, dim, MU_F,
                                      h_ref, wall=cyl, nl_wall=s.nl_fw)
    fluid = fa.transport_velocity_correction_adaptive(
        fluid, s.nl_ff, kernel, dim, h_ref, walls=walls,
        scope_mask=(fluid["Indicator"] == 0) & fluid["Alive"])

    def ac_cond(carry):
        _, rt, _ = carry
        return rt < dt_adv

    def ac_body(carry):
        f, rt, k = carry
        dt = jnp.minimum(fd.acoustic_time_step(f, case.eos, h_fine), dt_adv)
        f = fa.acoustic_step_1st_half_adaptive(f, s.nl_ff, kernel, dim,
                                               case.eos, case.riemann, dt,
                                               wall=cyl, nl_wall=s.nl_fw)
        f = fd.free_stream_velocity_correction(f, free_stream_target,
                                               s.time + rt, RHO0_F)
        f = _inflow_condition(f, case.emitter_buffer, s.time + rt)
        f = fa.acoustic_step_2nd_half_adaptive(f, s.nl_ff, kernel, dim,
                                               case.no_riemann, dt,
                                               wall=cyl, nl_wall=s.nl_fw)
        return (f, rt + dt, k + 1)

    fluid, relax_t, n_ac = jax.lax.while_loop(
        ac_cond, ac_body,
        (fluid, jnp.zeros_like(dt_adv), jnp.zeros((), jnp.int32)))

    fluid = bd.disposer_outflow_deletion(fluid, case.disposer)
    # clones must carry their MR identity (size/mass/h) into the dead slot
    fluid = bd.emitter_inflow_injection(
        fluid, case.emitter,
        fields=bd._PARTICLE_FIELDS_HINT + ("SmoothingLengthRatio",
                                           "ViscousForce",
                                           "ViscousForcePrev",
                                           "StartupForcePrev", "Indicator",
                                           "PreviousSurfaceIndicator",
                                           "PositionDivergence"),
        prev_pos=pos_prev)
    inj_ovf = fluid.pop("_InjectionOverflow", jnp.zeros((), bool))

    nl_ff, nl_fw, nl_wf, ovf = rebuild_relations(case, fluid)
    return MRCylSim(fluid=fluid, nl_ff=nl_ff, nl_fw=nl_fw, nl_wf=nl_wf,
                    time=s.time + relax_t, n_adv=s.n_adv + 1,
                    n_ac=s.n_ac + n_ac, overflow=s.overflow | ovf | inj_ovf)


def cylinder_forces(case: MRCylCase, s: MRCylSim):
    """Total (viscous, pressure) force from the fluid on the cylinder
    through the fine contact kernel (Cylinder_TotalViscousForceFromFluid /
    PressureForceFromFluid observers)."""
    kf = case.kernel_fine
    cyl = fsi.viscous_force_from_fluid(case.cylinder, s.fluid, s.nl_wf, kf,
                                       2, MU_F, kf.h)
    cyl = fsi.pressure_force_from_fluid(cyl, s.fluid, s.nl_wf, kf, 2,
                                        case.riemann)
    fv = jnp.sum(cyl["ViscousForceFromFluid"], axis=0)
    fp = jnp.sum(cyl["PressureForceFromFluid"], axis=0)
    return fv, fp


def make_run_chunk(case: MRCylCase):
    @jax.jit
    def run_chunk(s: MRCylSim, t_target) -> MRCylSim:
        return jax.lax.while_loop(lambda st: st.time < t_target,
                                  lambda st: _advection_step(case, st), s)

    return run_chunk
