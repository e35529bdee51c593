"""Slender-bar (beam) dynamics — two-director reduced-dimension solid.

Counterpart of /root/reference/src/for_3D_build/particle_dynamics/
solid_dynamics/slender_structure_dynamics.{h,cpp} and
slender_structure_math.cpp: a 1-D line of particles carries a
pseudo-normal AND a pseudo-binormal director; stresses integrate over the
rectangular cross-section with a 2-D Gauss rule, and the pair interaction
exchanges the resultant stress, two moments and two shear stresses.

Conventions (all mirrored from the reference):
  * local frame Q0 = getTransformationMatrix(n0, b0): rows are
    (x = b x n axial, y = b binormal, z = n normal); F's columns 2 and 1
    are overwritten by the rotated directors;
  * the correction matrix keeps only the axial (0,0) entry
    (getCorrectionMatrix_beam, slender_structure_math.cpp:116-121);
  * angular-acceleration recovery keeps only the axial component of each
    local director acceleration: domega = (0, a_n[0], 0),
    domega_b = (0, 0, a_b[0]) (small-deformation recovery,
    slender_structure_math.cpp:77-88);
  * both director accelerations scale with 12/(rho0 t^4) and the binormal
    one carries a minus sign (slender_structure_dynamics.h:209-211).

3-D only (the reference compiles bars only in the 3-D build).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from sphinxsys_jax.core.state import State
from sphinxsys_jax.neighbors.neighbor_list import gather
from sphinxsys_jax.physics.solid import ReferencePairs
from sphinxsys_jax.physics.shell import _stress_cauchy_linear

TINY = 1.0e-15
SHEAR_CORRECTION = 5.0 / 6.0

import dataclasses


@dataclasses.dataclass(frozen=True)
class LineKernel:
    """Twice-reduced smoothing kernel for codim-2 line particles
    (base_kernel.cpp Kernel::reduceTwice, applied by LinearParticles):
    a bar's pair sums run over a 1-D manifold, so W/dW use the
    1-D normalization."""

    base: object  # SmoothingKernel

    @property
    def h(self):
        return self.base.h

    @property
    def cutoff(self):
        return self.base.cutoff

    def W(self, r, dim: int):
        return self.base.W(r, dim - 2)

    def dW(self, r, dim: int):
        return self.base.dW(r, dim - 2)

    def w0(self, dim: int):
        return self.base.w0(dim - 2)

# 4-point 2-D Gauss rule (slender_structure_dynamics.h:245-249)
_G4 = 1.0 / math.sqrt(3.0)
GAUSS4_X = (-_G4, _G4, _G4, -_G4)
GAUSS4_Y = (-_G4, -_G4, _G4, _G4)
GAUSS4_W = (1.0, 1.0, 1.0, 1.0)

LOCAL_N0 = np.asarray([0.0, 0.0, 1.0])
LOCAL_B0 = np.asarray([0.0, 1.0, 0.0])


def transformation_matrix_bar(n, b):
    """getTransformationMatrix(direction_of_z=n, direction_of_y=b)
    (vector_functions.cpp:130-139): rows (b x n, b, n)."""
    x = jnp.cross(b, n)
    return jnp.stack([x, b, n], axis=-2)


def rotate_vector(rotation, v0):
    """getVectorAfterThinStructureRotation (Rodrigues with the reference's
    Eps regularization, slender_structure_math.cpp:10-26)."""
    theta = jnp.linalg.norm(rotation, axis=-1)
    rx, ry, rz = rotation[..., 0], rotation[..., 1], rotation[..., 2]
    z = jnp.zeros_like(rx)
    R1 = jnp.stack([
        jnp.stack([z, -rz, ry], -1),
        jnp.stack([rz, z, -rx], -1),
        jnp.stack([-ry, rx, z], -1)], -2)
    eye = jnp.eye(3, dtype=rotation.dtype)
    s = (jnp.sin(theta) / (theta + 1e-15))[..., None, None]
    c = ((1.0 - jnp.cos(theta)) / (theta * theta + 1e-15))[..., None, None]
    R = eye + s * R1 + c * (R1 @ R1)
    return jnp.einsum("...ij,j->...i", R, jnp.asarray(v0, rotation.dtype))


def make_bar_state(pos, normal, binormal, spacing: float, thickness: float,
                   width: float, material, dtype=jnp.float32) -> State:
    """Line of bar particles.  VolumetricMeasure is the LINEAR measure
    (spacing); Mass = rho0 * spacing * thickness * width (linear_particles
    convention)."""
    pos = jnp.asarray(pos, dtype)
    n = pos.shape[0]
    normal = jnp.broadcast_to(jnp.asarray(normal, dtype), (n, 3))
    binormal = jnp.broadcast_to(jnp.asarray(binormal, dtype), (n, 3))
    zeros_v = jnp.zeros((n, 3), dtype)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=dtype), (n, 3, 3))
    zeros_m = jnp.zeros((n, 3, 3), dtype)
    th = jnp.full((n,), thickness, dtype)
    wd = jnp.full((n,), width, dtype)
    vol = jnp.full((n,), spacing, dtype)
    state = {
        "Position": pos, "InitialPosition": pos, "Velocity": zeros_v,
        "Force": zeros_v, "ForcePrior": zeros_v,
        "VolumetricMeasure": vol,
        "Mass": material.rho0 * vol * th * wd,
        "Density": jnp.full((n,), material.rho0, dtype),
        "Thickness": th, "Width": wd,
        "NormalDirection": normal, "InitialNormalDirection": normal,
        "PseudoNormal": normal,
        "BinormalDirection": binormal, "InitialBinormalDirection": binormal,
        "PseudoBinormal": binormal,
        "Rotation": zeros_v, "AngularVelocity": zeros_v,
        "AngularAcceleration": zeros_v,
        "BinormalRotation": zeros_v, "BinormalAngularVelocity": zeros_v,
        "BinormalAngularAcceleration": zeros_v,
        "PseudoNormalRate": zeros_v, "PseudoBinormalRate": zeros_v,
        "DeformationGradient": eye, "DeformationRate": zeros_m,
        "BendingDeformationGradient": zeros_m, "BendingDeformationRate": zeros_m,
        "BinormalBending": zeros_m, "BinormalBendingRate": zeros_m,
        "TransformationMatrix0": transformation_matrix_bar(normal, binormal),
        "NReal": jnp.asarray(n, jnp.int32),
    }
    return state


def bar_correct_configuration(bar: State, rp: ReferencePairs) -> State:
    """BarCorrectConfiguration: B = diag(1/A00, 0, 0) in the local frame
    (only the axial direction is kernel-complete on a line)."""
    out = dict(bar)
    Q0 = bar["TransformationMatrix0"]
    vol_j, _ = gather(bar["VolumetricMeasure"], rp.idx)
    grad = (rp.dW * vol_j * rp.mask)[..., None] * rp.e          # (N,K,3)
    r_ji = -(rp.r[..., None] * rp.e)
    A = jnp.einsum("nki,nkj->nij", r_ji, grad) + 1e-7 * jnp.eye(3, dtype=grad.dtype)
    A_local = Q0 @ A @ jnp.swapaxes(Q0, -1, -2)
    B = jnp.zeros_like(A)
    B = B.at[..., 0, 0].set(1.0 / A_local[..., 0, 0])
    out["LinearGradientCorrectionMatrix"] = B
    return out


def bar_stress_relaxation_1st_half(bar: State, rp: ReferencePairs, material,
                                   dt, smoothing_length: float) -> State:
    """BarStressRelaxationFirstHalf: half-drift, cross-section Gauss stress
    integration, pair exchange of stress/moments/shears, velocity and
    angular-velocity kicks."""
    out = dict(bar)
    rho0 = material.rho0
    inv_rho0 = 1.0 / rho0
    nu = material.poisson_ratio
    G0 = material.shear_modulus
    lambda0 = material.lambda0
    Q0 = bar["TransformationMatrix0"]
    Q0T = jnp.swapaxes(Q0, -1, -2)
    th = bar["Thickness"]
    wd = bar["Width"]

    # ---- initialization -----------------------------------------------------
    pos = bar["Position"] + bar["Velocity"] * (0.5 * dt)
    rot = bar["Rotation"] + bar["AngularVelocity"] * (0.5 * dt)
    rot_b = bar["BinormalRotation"] + bar["BinormalAngularVelocity"] * (0.5 * dt)
    pseudo_n = bar["PseudoNormal"] + bar["PseudoNormalRate"] * (0.5 * dt)
    pseudo_b = bar["PseudoBinormal"] + bar["PseudoBinormalRate"] * (0.5 * dt)
    F = bar["DeformationGradient"] + bar["DeformationRate"] * (0.5 * dt)
    Fb = bar["BendingDeformationGradient"] + bar["BendingDeformationRate"] * (0.5 * dt)
    Fbb = bar["BinormalBending"] + bar["BinormalBendingRate"] * (0.5 * dt)

    J = jnp.linalg.det(F)
    inv_F = jnp.linalg.inv(F)
    rho = rho0 / J

    # current directors from F (slender_structure_math.cpp:91-98)
    f0, f1 = F[..., :, 0], F[..., :, 1]
    n_cur_local = jnp.cross(f0, f1)
    n_cur_local = n_cur_local / (jnp.linalg.norm(n_cur_local, axis=-1,
                                                 keepdims=True) + TINY)
    f2 = F[..., :, 2]
    b_cur_local = jnp.cross(f2, f0)
    b_cur_local = b_cur_local / (jnp.linalg.norm(b_cur_local, axis=-1,
                                                 keepdims=True) + TINY)
    n_cur = jnp.einsum("nij,nj->ni", Q0T, n_cur_local)
    b_cur = jnp.einsum("nij,nj->ni", Q0T, b_cur_local)
    Qc = transformation_matrix_bar(n_cur, b_cur)
    Q0c = Qc @ Q0T                     # initial local -> current local

    eye = jnp.eye(3, dtype=F.dtype)
    scale_diag = jnp.stack([jnp.full_like(th, smoothing_length),
                            jnp.minimum(wd, smoothing_length),
                            jnp.minimum(th, smoothing_length)], axis=-1)
    cs0 = math.sqrt(G0 / rho0)
    c0 = material.sound_speed

    res_stress = jnp.zeros_like(F)
    res_moment = jnp.zeros_like(F)
    res_b_moment = jnp.zeros_like(F)
    res_shear = jnp.zeros_like(pos)
    res_b_shear = jnp.zeros_like(pos)
    mid_cauchy = None

    corr = jnp.ones((3, 3), dtype=F.dtype)
    corr = corr.at[2, :].mul(SHEAR_CORRECTION).at[:, 2].mul(SHEAR_CORRECTION)
    corr = corr.at[1, :].mul(SHEAR_CORRECTION).at[:, 1].mul(SHEAR_CORRECTION)
    corr = corr.at[1, 1].set(0.0).at[2, 2].set(0.0)

    for gx, gy, gw in zip(GAUSS4_X, GAUSS4_Y, GAUSS4_W):
        F_g = F + gy * Fb * (th * 0.5)[..., None, None] \
            + gx * Fbb * (wd * 0.5)[..., None, None]
        dF_g = bar["DeformationRate"] \
            + gy * bar["BendingDeformationRate"] * (th * 0.5)[..., None, None] \
            + gx * bar["BinormalBendingRate"] * (wd * 0.5)[..., None, None]
        inv_F_g = jnp.linalg.inv(F_g)
        almansi = Q0c @ (0.5 * (eye - jnp.swapaxes(inv_F_g, -1, -2) @ inv_F_g)) \
            @ jnp.swapaxes(Q0c, -1, -2)
        # getCorrectedAlmansiStrain (the BAR build corrects only e22)
        almansi = almansi.at[..., 2, 2].set(
            -nu * (almansi[..., 0, 0] + almansi[..., 1, 1]) / (1.0 - nu))
        cauchy = _stress_cauchy_linear(almansi, lambda0, G0)
        # NumericalDampingRightCauchy with diag(h, min(w,h), min(t,h))
        strain_rate = 0.5 * (jnp.swapaxes(dF_g, -1, -2) @ F_g
                             + jnp.swapaxes(F_g, -1, -2) @ dF_g)
        normal_rate = strain_rate * eye
        damping = 0.5 * rho0 * (cs0 * (strain_rate - normal_rate) + c0 * normal_rate)
        damping = damping * scale_diag[..., None, :]
        cauchy = cauchy + (Q0c @ F_g @ damping @ jnp.swapaxes(F_g, -1, -2)
                           @ jnp.swapaxes(Q0c, -1, -2)) / \
            jnp.linalg.det(F_g)[..., None, None]
        cauchy = cauchy * corr
        if mid_cauchy is None:
            mid_cauchy = cauchy
        area_w = (0.5 * wd * 0.5 * th * gw)[..., None, None]
        res_stress = res_stress + area_w * cauchy
        res_moment = res_moment + area_w * cauchy * (gy * 0.5 * th)[..., None, None]
        res_b_moment = res_b_moment + area_w * cauchy * (gx * 0.5 * wd)[..., None, None]
        res_shear = res_shear - area_w[..., 0] * cauchy[..., :, 2]
        res_b_shear = res_b_shear - area_w[..., 0] * cauchy[..., :, 1]
        # modeling zeroes.  DEVIATION from slender_structure_dynamics.cpp:
        # 225-239, which zeroes ROWS 1,2 of the stress resultant as well —
        # that kills the transverse shear rows sigma_zx/sigma_yx, i.e. the
        # whole translational restoring force of a bent bar (no transverse
        # stiffness, the r1 failure).  The SHELL formulation
        # (thin_structure_dynamics.cpp:208) zeroes only the COLUMN, keeping
        # the shear row as the force channel; we follow the shell here.
        res_stress = res_stress.at[..., :, 2].set(0.0).at[..., :, 1].set(0.0)
        res_moment = res_moment.at[..., :, 2].set(0.0)
        res_b_moment = res_b_moment.at[..., :, 1].set(0.0)
        res_shear = res_shear.at[..., 1].set(0.0)
        res_b_shear = res_b_shear.at[..., 2].set(0.0)

    QcT = jnp.swapaxes(Qc, -1, -2)
    Jm = J[..., None, None]
    right = Qc @ Q0T @ jnp.swapaxes(inv_F, -1, -2) @ Q0
    global_stress = Jm * (QcT @ res_stress @ right)
    global_moment = Jm * (QcT @ res_moment @ right)
    global_b_moment = Jm * (QcT @ res_b_moment @ right)
    global_shear = J[..., None] * jnp.einsum("nij,nj->ni", QcT, res_shear)
    global_b_shear = J[..., None] * jnp.einsum("nij,nj->ni", QcT, res_b_shear)

    # ---- interaction --------------------------------------------------------
    vol_j, _ = gather(bar["VolumetricMeasure"], rp.idx)
    gs_j, _ = gather(global_stress, rp.idx)
    gm_j, _ = gather(global_moment, rp.idx)
    gbm_j, _ = gather(global_b_moment, rp.idx)
    coeff = (rp.dW * vol_j * rp.mask)[..., None]
    mass = bar["Mass"]
    force = mass[:, None] * jnp.sum(jnp.einsum(
        "nkij,nkj->nki", global_stress[:, None] + gs_j, rp.e) * coeff, axis=1)
    n_acc = global_shear + jnp.sum(jnp.einsum(
        "nkij,nkj->nki", global_moment[:, None] + gm_j, rp.e) * coeff, axis=1)
    b_acc = global_b_shear + jnp.sum(jnp.einsum(
        "nkij,nkj->nki", global_b_moment[:, None] + gbm_j, rp.e) * coeff, axis=1)

    force = force * inv_rho0 / (th * wd)[..., None]
    d2n = n_acc * (inv_rho0 * 12.0 / th**4)[..., None]
    d2b = -b_acc * (inv_rho0 * 12.0 / th**4)[..., None]

    # small-deformation angular recovery (slender_structure_math.cpp:77-88)
    a_n_local = jnp.einsum("nij,nj->ni", Q0, d2n)
    a_b_local = jnp.einsum("nij,nj->ni", Q0, d2b)
    z = jnp.zeros_like(a_n_local[..., 0])
    domega = jnp.stack([z, a_n_local[..., 0], z], axis=-1)
    domega_b = jnp.stack([z, z, a_b_local[..., 0]], axis=-1)

    # ---- update -------------------------------------------------------------
    vel = bar["Velocity"] + (bar["ForcePrior"] + force) / mass[:, None] * dt
    out.update({
        "Position": pos, "Density": rho,
        "Rotation": rot, "BinormalRotation": rot_b,
        "PseudoNormal": pseudo_n, "PseudoBinormal": pseudo_b,
        "DeformationGradient": F, "BendingDeformationGradient": Fb,
        "BinormalBending": Fbb,
        "GlobalStress": global_stress, "GlobalMoment": global_moment,
        "GlobalBinormalMoment": global_b_moment,
        "GlobalShearStress": global_shear,
        "GlobalBinormalShearStress": global_b_shear,
        "MidSurfaceCauchyStress": mid_cauchy,
        "Force": force,
        "AngularAcceleration": domega,
        "BinormalAngularAcceleration": domega_b,
        "AngularVelocity": bar["AngularVelocity"] + domega * dt,
        "BinormalAngularVelocity": bar["BinormalAngularVelocity"] + domega_b * dt,
        "Velocity": vel,
    })
    return out


def bar_stress_relaxation_2nd_half(bar: State, rp: ReferencePairs, dt) -> State:
    """BarStressRelaxationSecondHalf: drift, analytic director
    reconstruction from the rotation state, deformation rates from pair
    gradients, F drift."""
    out = dict(bar)
    Q0 = bar["TransformationMatrix0"]
    Q0T = jnp.swapaxes(Q0, -1, -2)

    pos = bar["Position"] + bar["Velocity"] * (0.5 * dt)
    rot = bar["Rotation"] + bar["AngularVelocity"] * (0.5 * dt)
    rot_b = bar["BinormalRotation"] + bar["BinormalAngularVelocity"] * (0.5 * dt)

    pseudo_n_old = bar["PseudoNormal"]
    pseudo_b_old = bar["PseudoBinormal"]
    pseudo_n = jnp.einsum("nij,nj->ni", Q0T,
                          rotate_vector(rot, LOCAL_N0))
    pseudo_b = jnp.einsum("nij,nj->ni", Q0T,
                          rotate_vector(rot_b, LOCAL_B0))
    safe_dt = jnp.maximum(jnp.asarray(dt, pos.dtype), 1e-10)
    dn_dt = (pseudo_n - pseudo_n_old) / (0.5 * safe_dt)
    db_dt = (pseudo_b - pseudo_b_old) / (0.5 * safe_dt)

    vel = bar["Velocity"]
    vol_j, _ = gather(bar["VolumetricMeasure"], rp.idx)
    vel_j, _ = gather(vel, rp.idx)
    dn_j, _ = gather(dn_dt, rp.idx)
    db_j, _ = gather(db_dt, rp.idx)
    grad = (rp.dW * vol_j * rp.mask)[..., None] * rp.e
    part1 = -jnp.einsum("nki,nkj->nij", vel[:, None] - vel_j, grad)
    part2 = -jnp.einsum("nki,nkj->nij", dn_dt[:, None] - dn_j, grad)
    part3 = -jnp.einsum("nki,nkj->nij", db_dt[:, None] - db_j, grad)

    B = bar["LinearGradientCorrectionMatrix"]
    dF_dt = Q0 @ part1 @ Q0T @ B
    dF_dt = dF_dt.at[..., :, 2].set(jnp.einsum("nij,nj->ni", Q0, dn_dt))
    dF_dt = dF_dt.at[..., :, 1].set(jnp.einsum("nij,nj->ni", Q0, db_dt))
    dFb_dt = Q0 @ part2 @ Q0T @ B
    dFbb_dt = Q0 @ part3 @ Q0T @ B

    out.update({
        "Position": pos, "Rotation": rot, "BinormalRotation": rot_b,
        "PseudoNormal": pseudo_n, "PseudoBinormal": pseudo_b,
        "PseudoNormalRate": dn_dt, "PseudoBinormalRate": db_dt,
        "DeformationRate": dF_dt, "BendingDeformationRate": dFb_dt,
        "BinormalBendingRate": dFbb_dt,
        "DeformationGradient": bar["DeformationGradient"] + dF_dt * (0.5 * dt),
        "BendingDeformationGradient":
            bar["BendingDeformationGradient"] + dFb_dt * (0.5 * dt),
        "BinormalBending": bar["BinormalBending"] + dFbb_dt * (0.5 * dt),
    })
    return out


def bar_acoustic_time_step(bar: State, material, smoothing_length: float,
                           cfl: float = 0.6):
    """BarAcousticTimeStepSize (slender_structure_dynamics.cpp:31-45)."""
    mass = bar["Mass"]
    accel = jnp.linalg.norm(bar["Force"] + bar["ForcePrior"], axis=-1) / mass
    v = jnp.linalg.norm(bar["Velocity"], axis=-1)
    c0 = material.sound_speed
    E0, nu, rho0 = material.youngs_modulus, material.poisson_ratio, material.rho0
    t0 = jnp.minimum(jnp.sqrt(smoothing_length / (accel + TINY)),
                     smoothing_length / (c0 + v))
    domega = jnp.maximum(jnp.linalg.norm(bar["AngularAcceleration"], axis=-1),
                         jnp.linalg.norm(bar["BinormalAngularAcceleration"], axis=-1))
    omega = jnp.maximum(jnp.linalg.norm(bar["AngularVelocity"], axis=-1),
                        jnp.linalg.norm(bar["BinormalAngularVelocity"], axis=-1))
    t1 = jnp.minimum(jnp.sqrt(1.0 / (domega + TINY)), 1.0 / (omega + TINY))
    th = bar["Thickness"]
    t2 = smoothing_length * jnp.sqrt(
        rho0 * (1.0 - nu * nu) / E0 /
        (2.0 + (math.pi**2 / 12.0) * (1.0 - nu) *
         (1.0 + 1.5 * (smoothing_length / th) ** 2)))
    return cfl * jnp.min(jnp.minimum(jnp.minimum(t0, t1), t2))


def constrain_bar_region(bar: State, mask) -> State:
    """ConstrainBarBodyRegion: zero velocity and both angular velocities."""
    out = dict(bar)
    m = mask[:, None]
    out["Velocity"] = jnp.where(m, 0.0, bar["Velocity"])
    out["AngularVelocity"] = jnp.where(m, 0.0, bar["AngularVelocity"])
    out["BinormalAngularVelocity"] = jnp.where(
        m, 0.0, bar["BinormalAngularVelocity"])
    return out
