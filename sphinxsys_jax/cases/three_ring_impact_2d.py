"""Three-ring impact: dynamic contact between two shells and a solid ring.

Counterpart of /root/reference/tests/2d_examples/test_2d_three_ring_impact/
test_2d_three_ring_impact.cpp (author Weiyi Kong): a small stiff shell ring
is shot at (-30, 30) into a soft medium shell ring inside a large SOLID
ring (NeoHookean, outer band fixed).  Exercises the full surface-contact
stack (physics/surface_contact.py):

  * shell<->shell contact (small<->medium, normal_correction=true: ring
    normals point outward, away from the ring interior where the other
    body approaches from either side — the builders' per-contact
    correction flags follow cpp:241-243);
  * shell<->solid contact both ways (medium ring vs the large ring:
    medium sees a SOLID surface with the offset-reduced averaged kernel,
    the large ring sees a SHELL through the dummy stack);
  * shell SELF contact of the medium ring (it crumples onto itself:
    ShellSelfContactRelation with initial-configuration pair exclusion);
  * curvature machinery: own principal curvatures for self contact +
    contact-kernel-averaged curvatures for cross contacts.

All three bodies run at dp = thickness_l/8 = 0.25 (the reference main's
resolution_factor 2), single-rate min-dt stepping with pairwise velocity/
rotation damping at the paper's physical viscosity (cpp:119-126).

Reference DB: Observer "Position" on the medium ring (point facing the
small ring), DTW tolerance dp_m (generateDataBase(dp_m), cpp:420).
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
from sphinxsys_jax.core.kernels import WendlandC2
from sphinxsys_jax.core.materials import NeoHookeanSolid
from sphinxsys_jax.neighbors import (build_cell_table, build_neighbor_list,
                                     grid_from_bounds)
from sphinxsys_jax.physics import contact as ct
from sphinxsys_jax.physics import dissipation as dp
from sphinxsys_jax.physics import relax as rx
from sphinxsys_jax.physics import shell as sh
from sphinxsys_jax.physics import shell_fluid as sf
from sphinxsys_jax.physics import solid as sd
from sphinxsys_jax.physics import surface_contact as sc

# geometry (cpp:133-158)
D_IN_L, D_OUT_L = 26.0, 30.0
D_IN_M, D_OUT_M = 10.0, 12.0
D_IN_S, D_OUT_S = 8.0, 10.0
R_MID_M = 0.25 * (D_IN_M + D_OUT_M)
R_MID_S = 0.25 * (D_IN_S + D_OUT_S)
TH_L = 0.5 * (D_OUT_L - D_IN_L)
TH_M = 0.5 * (D_OUT_M - D_IN_M)
TH_S = 0.5 * (D_OUT_S - D_IN_S)
CENTER_L = (0.0, 0.0)
CENTER_M = (-3.95, 3.95)
CENTER_S = (3.95, -4.25)
DP_REF = TH_L / 4.0

# materials (cpp:160-173)
RHO_L, RHO_M, RHO_S = 1.0, 0.01, 0.1
E_L, E_M, E_S = 288.0e3, 2250.0, 10.0e3
NU = 0.125
V0_S = (-30.0, 30.0)
END_TIME = 1.0


def physical_viscosity(rho, youngs, length_scale, shape_constant=0.4):
    """beta/4 sqrt(rho E) L (cpp:119-126)."""
    return shape_constant / 4.0 * math.sqrt(rho * youngs) * length_scale


class RingSim(NamedTuple):
    ring_l: Any
    ring_m: Any
    ring_s: Any
    time: jnp.ndarray
    n_steps: jnp.ndarray
    dt: jnp.ndarray
    overflow: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class ThreeRingCase:
    dp: float
    adaptation: SPHAdaptation
    mat_l: NeoHookeanSolid
    mat_m: NeoHookeanSolid
    mat_s: NeoHookeanSolid
    rp_l: sd.ReferencePairs         # solid frozen pairs (+ B matrix set)
    rp_m: sd.ReferencePairs         # shell reduced-kernel frozen pairs
    rp_s: sd.ReferencePairs
    fixed_l: jnp.ndarray
    grid: Any
    n_l: int
    n_m: int
    n_s: int
    k_contact: int
    cell_cap: int

    @property
    def kernel(self):
        return self.adaptation.kernel


def _ring_shell(center, r_mid, dp, thickness, material, dtype):
    n = int(2.0 * math.pi * r_mid / dp)
    th = 2.0 * math.pi * np.arange(n) / n
    normal = np.stack([np.cos(th), np.sin(th)], -1)
    pos = np.asarray(center) + r_mid * normal
    shell = sh.make_shell_state(pos, normal, dp, thickness, material,
                                dtype=dtype)
    return shell


def build_case(dp: float = DP_REF / 2.0, dtype=jnp.float64, relax: bool = True,
               k_contact: int = 24, cell_cap: int = 16):
    adaptation = SPHAdaptation(spacing=dp, dim=2)
    kernel = adaptation.kernel
    mat_l = NeoHookeanSolid(rho0=RHO_L, youngs_modulus=E_L, poisson_ratio=NU)
    mat_m = NeoHookeanSolid(rho0=RHO_M, youngs_modulus=E_M, poisson_ratio=NU)
    mat_s = NeoHookeanSolid(rho0=RHO_S, youngs_modulus=E_S, poisson_ratio=NU)

    # large SOLID ring (lattice + level-set-corrected relaxation, cpp:10-35)
    ring_shape = G.make_complex(
        ("add", G.Ball(center=CENTER_L, radius=0.5 * D_OUT_L)),
        ("sub", G.Ball(center=CENTER_L, radius=0.5 * D_IN_L)))
    lo = (-0.5 * D_OUT_L - 2 * dp, -0.5 * D_OUT_L - 2 * dp)
    hi = (0.5 * D_OUT_L + 2 * dp, 0.5 * D_OUT_L + 2 * dp)
    pos_l, vol_l = generate_lattice(ring_shape, lo, hi, dp)
    if relax:
        grid_rx = grid_from_bounds(lo, hi, adaptation.cutoff)
        pos_l = np.asarray(rx.relax_shape(
            ring_shape, jnp.asarray(pos_l, jnp.float64), vol_l, adaptation,
            grid_rx, n_iterations=600, cell_cap=24, k_max=40))
    ring_l = dict(sd.make_elastic_solid_state(pos_l, vol_l, mat_l,
                                              dtype=dtype))
    n_l = len(pos_l)
    r_l = np.hypot(pos_l[:, 0], pos_l[:, 1])
    fixed_l = jnp.asarray(r_l > 0.5 * D_OUT_L - 0.7 * dp)

    grid = grid_from_bounds(lo, hi, adaptation.cutoff)
    table_l = build_cell_table(jnp.asarray(pos_l, dtype), jnp.int32(n_l),
                               grid, cap=cell_cap)
    nl_l = build_neighbor_list(jnp.asarray(pos_l, dtype), jnp.int32(n_l),
                               jnp.asarray(pos_l, dtype), jnp.int32(n_l),
                               table_l, grid, adaptation.cutoff, k_max=32,
                               include_self=False)
    assert not bool(nl_l.overflow)
    rp_l = sd.freeze_reference_pairs(ring_l["Position"], nl_l, kernel, 2)
    B = sd.linear_gradient_correction_matrix(rp_l,
                                             ring_l["VolumetricMeasure"])
    ring_l["LinearGradientCorrectionMatrix"] = B
    ring_l["RepulsionForce"] = jnp.zeros_like(ring_l["Position"])
    ring_l["PreviousRepulsionForce"] = jnp.zeros_like(ring_l["Position"])

    # shell rings
    ring_m = _ring_shell(CENTER_M, R_MID_M, dp, TH_M, mat_m, dtype)
    ring_s = _ring_shell(CENTER_S, R_MID_S, dp, TH_S, mat_s, dtype)
    ring_s["Velocity"] = jnp.broadcast_to(
        jnp.asarray(V0_S, dtype), ring_s["Position"].shape)
    for ring in (ring_m, ring_s):
        ring["RepulsionForce"] = jnp.zeros_like(ring["Position"])
        ring["PreviousRepulsionForce"] = jnp.zeros_like(ring["Position"])
    ring_m["SelfRepulsionForce"] = jnp.zeros_like(ring_m["Position"])
    ring_m["PreviousSelfRepulsionForce"] = jnp.zeros_like(ring_m["Position"])

    def shell_rp(ring):
        n = ring["Position"].shape[0]
        table = build_cell_table(ring["Position"], jnp.int32(n), grid,
                                 cap=cell_cap)
        nl = build_neighbor_list(ring["Position"], jnp.int32(n),
                                 ring["Position"], jnp.int32(n), table, grid,
                                 adaptation.cutoff, k_max=12,
                                 include_self=False)
        assert not bool(nl.overflow)
        return sd.freeze_reference_pairs(ring["Position"], nl,
                                         sh.ReducedKernel(kernel), 2)

    rp_m, rp_s = shell_rp(ring_m), shell_rp(ring_s)
    ring_m = sh.shell_correct_configuration(ring_m, rp_m)
    ring_s = sh.shell_correct_configuration(ring_s, rp_s)

    case = ThreeRingCase(dp=dp, adaptation=adaptation, mat_l=mat_l,
                         mat_m=mat_m, mat_s=mat_s, rp_l=rp_l, rp_m=rp_m,
                         rp_s=rp_s, fixed_l=fixed_l, grid=grid, n_l=n_l,
                         n_m=ring_m["Position"].shape[0],
                         n_s=ring_s["Position"].shape[0],
                         k_contact=k_contact, cell_cap=cell_cap)
    dt0 = min(
        float(sd.solid_acoustic_time_step(ring_l, mat_l.sound_speed,
                                          adaptation.h, cfl=0.6)),
        float(sh.shell_acoustic_time_step(ring_m, mat_m, adaptation.h)),
        float(sh.shell_acoustic_time_step(ring_s, mat_s, adaptation.h)))
    sim = RingSim(ring_l=ring_l, ring_m=ring_m, ring_s=ring_s,
                  time=jnp.zeros((), dtype), n_steps=jnp.zeros((), jnp.int32),
                  dt=jnp.asarray(dt0, dtype), overflow=jnp.zeros((), bool))
    return case, sim


def _contact_nl(pos_q, n_q, target, n_t, grid, cutoff, k_max, cell_cap):
    table = build_cell_table(target["Position"], n_t, grid, cap=cell_cap)
    return build_neighbor_list(pos_q, n_q, target["Position"], n_t, table,
                               grid, cutoff, k_max=k_max, include_self=True)


def _step(case: ThreeRingCase, s: RingSim) -> RingSim:
    kernel, dim, dp_ = case.kernel, 2, case.dp
    h = case.adaptation.h
    rl, rm, rs = dict(s.ring_l), dict(s.ring_m), dict(s.ring_s)
    dt = s.dt
    n_l = jnp.int32(case.n_l)
    n_m = jnp.int32(case.n_m)
    n_s = jnp.int32(case.n_s)

    # --- curvatures (own kernel == contact kernel at equal resolutions)
    red = sh.ReducedKernel(kernel)
    k1_m, k2_m = sf.shell_curvature(rm, case.rp_m, red, dim)
    k1_s, k2_s = sf.shell_curvature(rs, case.rp_s, red, dim)

    # --- contact neighbor lists (rebuilt every step; bodies move fast)
    cutoff = kernel.cutoff
    nl_sm = _contact_nl(rs["Position"], n_s, rm, n_m, case.grid, cutoff,
                        case.k_contact, case.cell_cap)
    nl_ms = _contact_nl(rm["Position"], n_m, rs, n_s, case.grid, cutoff,
                        case.k_contact, case.cell_cap)
    nl_ml = _contact_nl(rm["Position"], n_m, rl, n_l, case.grid, cutoff,
                        case.k_contact, case.cell_cap)
    nl_lm = _contact_nl(rl["Position"], n_l, rm, n_m, case.grid, cutoff,
                        case.k_contact, case.cell_cap)
    # shell self contact of the medium ring (own-position list; the
    # initial-configuration exclusion lives in shell_self_pairs)
    nl_mm = _contact_nl(rm["Position"], n_m, rm, n_m, case.grid, cutoff,
                        case.k_contact, case.cell_cap)
    ovf = (nl_sm.overflow | nl_ms.overflow | nl_ml.overflow | nl_lm.overflow
           | nl_mm.overflow)

    # --- surface-contact pairs (cpp:241-243 normal-correction flags)
    pairs_sm = sc.shell_surface_pairs(rs["Position"], rm, k1_m, k2_m, nl_sm,
                                      kernel, dim, dp_,
                                      normal_correction=True)
    pairs_ms = sc.shell_surface_pairs(rm["Position"], rs, k1_s, k2_s, nl_ms,
                                      kernel, dim, dp_,
                                      normal_correction=True)
    pairs_ml = sc.solid_surface_pairs(rm["Position"], rl, nl_ml, kernel, dim,
                                      dp_, dp_)
    pairs_lm = sc.shell_surface_pairs(rl["Position"], rm, k1_m, k2_m, nl_lm,
                                      kernel, dim, dp_,
                                      normal_correction=True)
    pairs_mm = sc.shell_self_pairs(rm, k1_m, k2_m, nl_mm, kernel, dim, dp_)

    # --- repulsion factors (ContactFactorSummation)
    sigma_s = sc.repulsion_factor([pairs_sm])
    sigma_m = sc.repulsion_factor([pairs_ms, pairs_ml])
    sigma_l = sc.repulsion_factor([pairs_lm])
    sigma_mm = sc.repulsion_factor([pairs_mm])

    # --- contact forces (RepulsionForce; harmonic stiffness)
    K_l = ct.contact_stiffness(case.mat_l)
    K_m = ct.contact_stiffness(case.mat_m)
    K_s = ct.contact_stiffness(case.mat_s)

    def k_ave(a, b):
        return 2.0 * a * b / (a + b)

    pv_m = rm["VolumetricMeasure"] * rm["Thickness"]
    pv_s = rs["VolumetricMeasure"] * rs["Thickness"]
    f_s = sc.repulsion_force(rs, sigma_s, [(pairs_sm, sigma_m, k_ave(K_s, K_m))],
                             particle_volume=pv_s)
    f_m = sc.repulsion_force(rm, sigma_m,
                             [(pairs_ms, sigma_s, k_ave(K_m, K_s)),
                              (pairs_ml, sigma_l, k_ave(K_m, K_l))],
                             particle_volume=pv_m)
    f_l = sc.repulsion_force(rl, sigma_l, [(pairs_lm, sigma_m, k_ave(K_l, K_m))])
    f_mm = sc.self_repulsion_force(rm, sigma_mm, pairs_mm, K_m, RHO_M,
                                   particle_volume=pv_m)

    def apply_force(ring, key, force):
        prev = ring["Previous" + key]
        ring["ForcePrior"] = ring["ForcePrior"] + force - prev
        ring[key] = force
        ring["Previous" + key] = force
        return ring

    rs = apply_force(rs, "RepulsionForce", f_s)
    rm = apply_force(rm, "RepulsionForce", f_m)
    rm = apply_force(rm, "SelfRepulsionForce", f_mm)
    rl = apply_force(rl, "RepulsionForce", f_l)

    # --- stress relaxation first halves
    rl = sd.integration_1st_half_pk2(rl, case.rp_l, case.mat_l, dt, h,
                                     kernel.w0(dim))
    rm = sh.shell_stress_relaxation_1st_half(rm, case.rp_m, case.mat_m, dt, h)
    rs = sh.shell_stress_relaxation_1st_half(rs, case.rp_s, case.mat_s, dt, h)

    rl = sd.fix_constraint(rl, case.fixed_l)

    # --- damping (DampingWithRandomChoice(0.2) in expectation == every
    # step at dt; the Jacobi pairwise form is dissipation.damping_pairwise)
    eta_l = physical_viscosity(RHO_L, E_L, TH_L)
    eta_m = physical_viscosity(RHO_M, E_M, TH_M)
    eta_s = physical_viscosity(RHO_S, E_S, TH_S)
    rl = dp.damping_pairwise(rl, "Velocity", case.rp_l, kernel, dim,
                             eta_l, dt)
    rm = dp.damping_pairwise(rm, "Velocity", case.rp_m, red, dim,
                             eta_m, dt)
    rm = dp.damping_pairwise(rm, "AngularVelocity", case.rp_m, red,
                             dim, eta_m, dt)
    rs = dp.damping_pairwise(rs, "Velocity", case.rp_s, red, dim,
                             eta_s, dt)
    rs = dp.damping_pairwise(rs, "AngularVelocity", case.rp_s, red,
                             dim, eta_s, dt)

    rl = sd.fix_constraint(rl, case.fixed_l)

    # --- second halves + normal updates
    rl = sd.integration_2nd_half(rl, case.rp_l, dt)
    rm = sh.shell_stress_relaxation_2nd_half(rm, case.rp_m, dt)
    rs = sh.shell_stress_relaxation_2nd_half(rs, case.rp_s, dt)
    rm = sh.update_shell_normal(rm)
    rs = sh.update_shell_normal(rs)

    dt_next = jnp.minimum(
        jnp.minimum(
            sd.solid_acoustic_time_step(rl, case.mat_l.sound_speed, h,
                                        cfl=0.6),
            sh.shell_acoustic_time_step(rm, case.mat_m, h)),
        sh.shell_acoustic_time_step(rs, case.mat_s, h))

    return RingSim(ring_l=rl, ring_m=rm, ring_s=rs, time=s.time + dt,
                   n_steps=s.n_steps + 1, dt=dt_next,
                   overflow=s.overflow | ovf)


def make_run_chunk(case: ThreeRingCase):
    @jax.jit
    def run_chunk(s: RingSim, t_target) -> RingSim:
        return jax.lax.while_loop(lambda st: st.time < t_target,
                                  lambda st: _step(case, st), s)

    return run_chunk


def observer_point(case: ThreeRingCase, s: RingSim):
    """The reference observer: the medium-ring material point initially
    facing AWAY from the small ring (cpp:280: center_m + R (center_m -
    center_s).normalized()); for a shell the observer interpolation with
    frozen weights is effectively the nearest material particle."""
    d = np.asarray(CENTER_M) - np.asarray(CENTER_S)
    p0 = np.asarray(CENTER_M) + R_MID_M * d / np.linalg.norm(d)
    i = int(np.argmin(np.linalg.norm(
        np.asarray(s.ring_m["InitialPosition"]) - p0, axis=1)))
    return np.asarray(s.ring_m["Position"])[i]
