"""Heart electromechanics with ventricular volume change (3D).

Counterpart of tests/3d_examples/test_3d_heart_electromechanics/ and
test_3d_heart_volume_change/ (excitation_contraction.cpp +
heart_volume_change.cpp): the full flagship composition

  1. FIBER GENERATION (excitation_contraction.h:69-162): a scalar field
     Phi is held at 1 on the epicardium and 0 on the endocardium and
     diffused through the wall (FiberDirectionDiffusionRelaxation); the
     fiber direction is the circumferential direction rotated about the
     transmural face normal by the Rodrigues formula with helix angle
     beta = (beta_epi - beta_endo) Phi + beta_endo (beta_epi = -70 deg,
     beta_endo = +80 deg, doi.org/10.1016/j.cma.2016.05.031); the sheet
     direction is the face normal.
  2. EXCITATION: Aliev-Panfilov monodomain with fiber-biased
     LocalDirectionalDiffusion (materials/diffusion_reaction.h:212-242)
     and an apex stimulus (ApplyStimulusCurrentSI analog).
  3. CONTRACTION: the voltage drives ActiveContractionStress, which
     enters the total-Lagrangian mechanics as Ta f (x) f on top of the
     LocallyOrthotropicMuscle passive stress (elastic_solid.h:334-372);
     the base ring is fixed (MuscleBaseShapeParameters constraint).
  4. VOLUME CHANGE (heart_volume_change.h:95-146
     SurfaceOperationsVentricle): endocardial surface particles carry an
     initial area measure dA0 = V/dx and Nanson-updated normals
     n dA = J F^{-T} n0 dA0; the cavity flow rate Q = sum v . n dA is
     accumulated into the ejected volume dV.

Deviations from the reference, documented:
  * geometry is a procedural ellipsoidal LV shell (outer (1,1,1.5),
    inner (0.7,0.7,1.25), base cut z > 0.55) instead of the
    biventricular STL, so surfaces are identified by the constituent
    ellipsoids' signed distances instead of TriangleMeshDistance;
  * one body carries physiology + mechanics (the reference couples two
    same-geometry bodies by kernel interpolation);
  * nondimensional material constants with the reference's Ta/a0 ratio
    (k_a * 100 = 20 a0[0]) and b0 exponents kept exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from sphinxsys_jax.core import geometry as G
from sphinxsys_jax.core.adaptation import SPHAdaptation
from sphinxsys_jax.core.generators import generate_lattice
from sphinxsys_jax.core.materials import LocallyOrthotropicMuscle
from sphinxsys_jax.neighbors import (build_cell_table, build_neighbor_list,
                                     grid_from_bounds)
from sphinxsys_jax.physics import diffusion as df
from sphinxsys_jax.physics import solid as sd

OUTER = (1.0, 1.0, 1.5)
INNER = (0.7, 0.7, 1.25)
Z_CUT = 0.55
RHO0 = 1.0
POISSON = 0.45
A0 = (0.496, 15.196, 3.283, 0.662)      # reference a0 * 1e3 (nondim)
B0 = (7.209, 20.417, 11.176, 9.466)     # reference b0, exactly
K_A = 0.1                                # Ta_max = 10 = 20 a0[0], the
                                         # reference's k_a/a0 ratio
D_MYO = 0.05
D_BIAS = 0.1                             # fiber-biased conduction
STIM_T = 0.4
BETA_EPI = -70.0 / 180.0 * np.pi
BETA_ENDO = 80.0 / 180.0 * np.pi


class Sim(NamedTuple):
    myo: Any
    dv: jnp.ndarray              # accumulated cavity volume change
    q: jnp.ndarray               # current cavity flow rate
    time: jnp.ndarray
    n_steps: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class HeartCase:
    dx: float
    adaptation: SPHAdaptation
    material: LocallyOrthotropicMuscle
    rp: sd.ReferencePairs
    nl: Any
    base_mask: Any
    stim_mask: Any
    endo_mask: Any               # endocardial surface particles
    endo_n0: Any                 # their initial outward normals
    endo_da0: Any                # their initial area measures
    model: df.AlievPanfilowModel
    diffusion: df.LocalDirectionalDiffusion
    n: int
    dt_d: float
    n_mech_sub: int

    def __hash__(self):
        return hash((self.n, self.dx))

    def __eq__(self, other):
        return self is other


def _face_normal(p: np.ndarray, axes=None) -> np.ndarray:
    """Outward transmural direction: the gradient direction of the given
    ellipsoid family through p (the reference probes the level-set
    normal, excitation_contraction.h:135).  Pass axes=INNER for
    endocardial-surface normals — inner (0.7,0.7,1.25) is NOT a confocal
    scaling of outer (1,1,1.5), so the outer family's gradient is tilted
    on the inner surface (ADVICE r4: it biased the Nanson cavity
    flow-rate integral)."""
    ax = np.asarray(OUTER if axes is None else axes)
    n = p / ax[None, :] ** 2
    return n / (np.linalg.norm(n, axis=1, keepdims=True) + 1e-15)


def generate_fibers(pos: np.ndarray, epi_mask, endo_mask, nl, kernel,
                    vol, dtype, n_relax: int = 240):
    """Reference fiber pipeline: diffuse Phi (epi = 1, endo = 0) through
    the wall, then rotate the circumferential direction about the face
    normal by the Rodrigues helix formula
    (excitation_contraction.h:106-162)."""
    n = len(pos)
    phi0 = np.where(epi_mask, 1.0, 0.0)
    vol_arr = np.broadcast_to(np.asarray(vol), (n,))
    state = {"Position": jnp.asarray(pos, dtype),
             "Phi": jnp.asarray(phi0, dtype),
             "VolumetricMeasure": jnp.asarray(vol_arr, dtype),
             "NReal": jnp.asarray(n, jnp.int32)}
    diff = df.IsotropicDiffusion(1.0)
    h = float(np.cbrt(vol_arr[0])) * 1.3
    dt = df.diffusion_time_step(h, diff, 3)
    hold_epi = jnp.asarray(epi_mask)
    hold_endo = jnp.asarray(endo_mask)

    def body(_, s):
        s = df.diffusion_step_rk2(s, "Phi", nl, kernel, 3, diff, dt)
        phi = jnp.where(hold_epi, 1.0, jnp.where(hold_endo, 0.0, s["Phi"]))
        return dict(s, Phi=phi)

    state = jax.lax.fori_loop(0, n_relax, body, state)
    phi = np.clip(np.asarray(state["Phi"]), 0.0, 1.0)

    face = _face_normal(pos)
    centerline = np.array([0.0, 0.0, 1.0])               # apex-to-base
    cd = np.cross(np.broadcast_to(centerline, face.shape), face)
    cd /= np.linalg.norm(cd, axis=1, keepdims=True) + 1e-15
    beta = (BETA_EPI - BETA_ENDO) * phi + BETA_ENDO
    f0 = (np.cos(beta)[:, None] * cd
          + np.sin(beta)[:, None] * np.cross(face, cd))
    f0 /= np.linalg.norm(f0, axis=1, keepdims=True) + 1e-15
    return f0, face, phi


def build_case(dx: float = 0.12, dtype=jnp.float32, k_inner: int = 72,
               k_a: float = K_A, mech_cfl_factor: float = 12.0):
    shell = G.make_complex(
        ("add", G.Ellipsoid(center=(0.0, 0.0, 0.0), semi_axes=OUTER)),
        ("sub", G.Ellipsoid(center=(0.0, 0.0, 0.0), semi_axes=INNER)),
        ("sub", G.HalfSpace(point=(0.0, 0.0, Z_CUT),
                            outward_normal=(0.0, 0.0, -1.0))))
    lo = (-1.1, -1.1, -1.6)
    hi = (1.1, 1.1, 0.7)
    pos, vol = generate_lattice(shell, lo, hi, dx)
    n = len(pos)
    p = np.asarray(pos)

    material = LocallyOrthotropicMuscle(
        rho0=RHO0, bulk_modulus_param=2.0 * A0[0] * (1.0 + POISSON)
        / (3.0 * (1.0 - 2.0 * POISSON)), a0=A0, b0=B0)
    myo = dict(sd.make_elastic_solid_state(pos, vol, material, dtype=dtype))

    adaptation = SPHAdaptation(spacing=dx, dim=3)
    grid = grid_from_bounds(lo, hi, adaptation.cutoff)
    table = build_cell_table(myo["Position"], jnp.int32(n), grid, cap=40)
    nl = build_neighbor_list(myo["Position"], jnp.int32(n), myo["Position"],
                             jnp.int32(n), table, grid, adaptation.cutoff,
                             k_max=k_inner, include_self=False)
    assert not bool(nl.overflow)
    rp = sd.freeze_reference_pairs(myo["Position"], nl, adaptation.kernel, 3)
    myo["LinearGradientCorrectionMatrix"] = \
        sd.linear_gradient_correction_matrix(rp, myo["VolumetricMeasure"])

    # surface layers from the constituent surfaces' signed distances
    sdf_out = np.asarray(
        G.Ellipsoid(center=(0.0, 0.0, 0.0), semi_axes=OUTER)
        .signed_distance(pos))
    sdf_in = np.asarray(
        G.Ellipsoid(center=(0.0, 0.0, 0.0), semi_axes=INNER)
        .signed_distance(pos))
    below_base = p[:, 2] < Z_CUT - 1.2 * dx
    epi_mask = (np.abs(sdf_out) < 0.8 * dx) & below_base
    endo_mask = (np.abs(sdf_in) < 0.8 * dx) & below_base

    f0, s0, _phi = generate_fibers(p, epi_mask, endo_mask, nl,
                                   adaptation.kernel, vol, dtype)
    myo["Fiber"] = jnp.asarray(f0, dtype)
    myo["Sheet"] = jnp.asarray(s0, dtype)

    for name in ("Voltage", "GateVariable", "ActiveContractionStress"):
        myo[name] = jnp.zeros((n,), dtype)

    base_mask = jnp.asarray(p[:, 2] > Z_CUT - 1.2 * dx)
    stim_mask = jnp.asarray(p[:, 2] < -1.15)

    # endocardial surface measures (SurfaceOperationsVentricle
    # init_srf_area: layer area = particle volume / spacing)
    endo_n0 = jnp.asarray(_face_normal(p, axes=INNER), dtype)
    endo_da0 = jnp.asarray(np.broadcast_to(np.asarray(vol) / dx, (n,)), dtype)

    model = df.AlievPanfilowModel(k_a=k_a)
    diffusion = df.LocalDirectionalDiffusion(D_MYO, D_BIAS)

    h = adaptation.h
    dt_d = df.diffusion_time_step(h, diffusion, 3)
    # mech_cfl_factor survives as a velocity-term floor only; the subloop
    # now uses the reference's adaptive solid AcousticTimeStep (ADVICE r4)
    c0 = material.sound_speed * mech_cfl_factor
    dt_s = 0.5 * h / c0
    n_mech_sub = max(1, int(np.ceil(dt_d / dt_s)))

    case = HeartCase(dx=dx, adaptation=adaptation, material=material,
                     rp=rp, nl=nl, base_mask=base_mask, stim_mask=stim_mask,
                     endo_mask=jnp.asarray(endo_mask), endo_n0=endo_n0,
                     endo_da0=endo_da0, model=model, diffusion=diffusion,
                     n=n, dt_d=float(dt_d), n_mech_sub=n_mech_sub)
    sim = Sim(myo=myo, dv=jnp.zeros((), dtype), q=jnp.zeros((), dtype),
              time=jnp.zeros((), dtype), n_steps=jnp.zeros((), jnp.int32))
    return case, sim


def cavity_flow_rate(case: HeartCase, myo) -> jnp.ndarray:
    """Q = sum_endo v . (J F^{-T} n0) dA0 (update_srf_area +
    update_flow_rate, heart_volume_change.cpp): positive when the wall
    moves outward (cavity filling), negative during ejection."""
    F = myo["DeformationGradient"]
    J = jnp.linalg.det(F)
    n_cur = jnp.einsum("nji,nj->ni", jnp.linalg.inv(F), case.endo_n0)
    q_i = J * jnp.sum(myo["Velocity"] * n_cur, axis=-1) * case.endo_da0
    return jnp.sum(jnp.where(case.endo_mask, q_i, 0.0))


def _step(case: HeartCase, s: Sim) -> Sim:
    dt = jnp.asarray(case.dt_d, s.time.dtype)
    myo = dict(s.myo)
    # apex stimulus held during ignition (ApplyStimulusCurrentSI)
    v = myo["Voltage"]
    myo["Voltage"] = jnp.where(case.stim_mask & (s.time < STIM_T),
                               jnp.maximum(v, 0.92), v)
    # monodomain with fiber-biased conduction
    myo = df.electrophysiology_step(myo, case.nl, case.adaptation.kernel, 3,
                                    case.diffusion, case.model, dt)
    # mechanics subloop with the active fiber stress
    h = case.adaptation.h
    w0 = case.adaptation.kernel.w0(3)
    dt_s = dt / case.n_mech_sub
    mat = case.material
    active = sd.active_fiber_stress()

    def pk1(solid, F):
        S2 = mat.stress_PK2_local(F, solid["Fiber"], solid["Sheet"])
        return F @ (S2 + active(solid, F))

    # adaptive sub-cycling (reference solid AcousticTimeStep: the
    # acceleration term tracks the Holzapfel stiffened-regime wave speed
    # that a fixed multiplier can only guess at — ADVICE r4); dt_s above
    # remains the per-substep CAP so the compiled loop keeps a bound
    def s_cond(c):
        _, acc = c
        return acc < dt

    def s_body(c):
        m, acc = c
        dt_i = jnp.minimum(
            jnp.minimum(sd.solid_acoustic_time_step(m, mat.sound_speed, h),
                        jnp.asarray(dt_s, dt.dtype)),
            dt - acc)
        m = sd.integration_1st_half_pk2(m, case.rp, mat, dt_i, h, w0,
                                        pk1_fn=pk1)
        m = sd.fix_constraint(m, case.base_mask)
        m = sd.integration_2nd_half(m, case.rp, dt_i)
        return (m, acc + dt_i)

    myo, _ = jax.lax.while_loop(s_cond, s_body,
                                (myo, jnp.zeros_like(dt)))
    q = cavity_flow_rate(case, myo)
    return Sim(myo=myo, dv=s.dv + q * dt, q=q, time=s.time + dt,
               n_steps=s.n_steps + 1)


def make_run_chunk(case: HeartCase):
    @jax.jit
    def run_chunk(s: Sim, t_target) -> Sim:
        return jax.lax.while_loop(lambda st: st.time < t_target,
                                  lambda st: _step(case, st), s)

    return run_chunk


def cavity_volume0() -> float:
    """Initial cavity volume: inner half-ellipsoid below the base cut."""
    a, b, c = INNER
    zc = min(Z_CUT / c, 1.0)
    # ellipsoid cap integral: V(z<zc*c) = pi a b c (2/3 + zc - zc^3/3)
    return float(np.pi * a * b * c * (2.0 / 3.0 + zc - zc ** 3 / 3.0))


def base_voltage(case: HeartCase, s: Sim) -> float:
    p0 = np.asarray(s.myo["InitialPosition"])
    ring = p0[:, 2] > 0.3
    return float(np.mean(np.asarray(s.myo["Voltage"])[ring]))
