"""Thin-shell (Mindlin-Reissner) structural dynamics — 2D implementation.

Counterpart of /root/reference/src/shared/particle_dynamics/solid_dynamics/
thin_structure_dynamics.{h,cpp} and thin_structure_math.cpp: shells are
mid-surface particle strips with a rotation DOF; the pseudo-normal tracks
the rotated director, stresses are integrated through the thickness at
Gauss points with a plane-stress correction and a 5/6 shear correction
factor, and the pair interaction exchanges resultant stress, moment and
shear (thin_structure_dynamics.h:44-378).

Like total-Lagrangian solids, the topology is the frozen initial
configuration (ReferencePairs).  Rotation DOFs follow the reference's
angle convention (thin_structure_math.cpp): 2D stores the angle about z
in component 0; 3D stores (theta_x, theta_y, 0) and the local pseudo
normal is Ry(theta_y) Rx(theta_x) e_n.

Local frames: transformation_matrix0 = Q0 maps global -> initial local
with the LAST local axis along the initial normal
(vector_functions.cpp getTransformationMatrix):
    2D: Q0 = [[ n_y, -n_x],
              [ n_x,  n_y]]       (local y = normal)
    3D: the z->n Rodrigues rotation, rows = the local axes (local z = n)
F, F_bending, B, rotation live in the initial local frame; positions,
velocities, pseudo normals, global stress/moment in the global frame.
"""

from __future__ import annotations

import math

import jax.numpy as jnp

from sphinxsys_jax.core.state import State
from sphinxsys_jax.neighbors.neighbor_list import NeighborList, gather
from sphinxsys_jax.physics.solid import ReferencePairs

TINY = 1.0e-15

import dataclasses


@dataclasses.dataclass(frozen=True)
class ReducedKernel:
    """Dimension-reduced smoothing kernel for codim-1 surface particles
    (base_kernel.cpp Kernel::reduceOnce, applied by SurfaceParticles):
    a d-dimensional shell's pair sums run over a (d-1)-manifold of
    particles, so W/dW use the (d-1)-dimensional normalization."""

    base: object  # SmoothingKernel

    @property
    def h(self):
        return self.base.h

    @property
    def cutoff(self):
        return self.base.cutoff

    def W(self, r, dim: int):
        return self.base.W(r, dim - 1)

    def dW(self, r, dim: int):
        return self.base.dW(r, dim - 1)

    def w0(self, dim: int):
        return self.base.w0(dim - 1)


GAUSS_3_POINTS = (0.0, 0.7745966692414834, -0.7745966692414834)
GAUSS_3_WEIGHTS = (0.8888888888888889, 0.5555555555555556, 0.5555555555555556)
SHEAR_CORRECTION = 5.0 / 6.0


def transformation_matrix_2d(n):
    """(N,2) normals -> (N,2,2) global->local maps."""
    nx, ny = n[..., 0], n[..., 1]
    return jnp.stack([
        jnp.stack([ny, -nx], axis=-1),
        jnp.stack([nx, ny], axis=-1),
    ], axis=-2)


def rotate_pseudo_normal_2d(theta):
    """R(theta) @ [0,1] = [sin, cos] (thin_structure_math.cpp 2D)."""
    return jnp.stack([jnp.sin(theta), jnp.cos(theta)], axis=-1)


def pseudo_normal_rate_2d(theta, omega):
    return jnp.stack([jnp.cos(theta) * omega, -jnp.sin(theta) * omega], axis=-1)


def rotation_accel_from_pseudo_normal_2d(a_local, theta, omega):
    """domega/dt from the local pseudo-normal acceleration
    (thin_structure_math.cpp getRotationFromPseudoNormal 2D)."""
    c, s = jnp.cos(theta), jnp.sin(theta)
    return c * (a_local[..., 0] + s * omega * omega) - \
        s * (a_local[..., 1] + c * omega * omega)


# ---------------------------------------------------------------------------
# 3D rotation algebra (thin_structure_math.cpp, Vec3d overloads)
# ---------------------------------------------------------------------------

def transformation_matrix_3d(n):
    """(N,3) normals -> (N,3,3) global->local maps: the z->n Rodrigues
    rotation, rows = local axes (vector_functions.cpp:111-127)."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    temp = 1.0 + nz
    frac = temp / (temp * temp + TINY)
    row0 = jnp.stack([nz + ny * ny * frac, -nx * ny * frac, -nx], axis=-1)
    row1 = jnp.stack([-nx * ny * frac, nz + nx * nx * frac, -ny], axis=-1)
    row2 = jnp.stack([nx, ny, nz], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2)


def rotate_pseudo_normal_3d(rot):
    """Ry(theta_1) Rx(theta_0) e_z = (sin t1 cos t0, -sin t0, cos t0 cos t1)
    (getVectorAfterThinStructureRotation, Vec3d)."""
    s0, c0 = jnp.sin(rot[..., 0]), jnp.cos(rot[..., 0])
    s1, c1 = jnp.sin(rot[..., 1]), jnp.cos(rot[..., 1])
    return jnp.stack([s1 * c0, -s0, c0 * c1], axis=-1)


def pseudo_normal_rate_3d(rot, angvel):
    """(getVectorChangeRateAfterThinStructureRotation, Vec3d)."""
    s0, c0 = jnp.sin(rot[..., 0]), jnp.cos(rot[..., 0])
    s1, c1 = jnp.sin(rot[..., 1]), jnp.cos(rot[..., 1])
    w0, w1 = angvel[..., 0], angvel[..., 1]
    return jnp.stack([-s0 * s1 * w0 + c0 * c1 * w1,
                      -c0 * w0,
                      -s0 * c1 * w0 - c0 * s1 * w1], axis=-1)


def rotation_accel_from_pseudo_normal_3d(a_local, rot, angvel):
    """(domega0/dt, domega1/dt) from the local pseudo-normal acceleration
    (getRotationFromPseudoNormal, Vec3d overload)."""
    a0, a1, a2 = a_local[..., 0], a_local[..., 1], a_local[..., 2]
    s0, c0 = jnp.sin(rot[..., 0]), jnp.cos(rot[..., 0])
    s1, c1 = jnp.sin(rot[..., 1]), jnp.cos(rot[..., 1])
    w0, w1 = angvel[..., 0], angvel[..., 1]

    r0a = -(a2 * c1 + a0 * s1 + w1 * w1 * c0 + w0 * w0 * c0)
    r0b = s0 * w0 * w0 - a1
    acc0 = s0 * r0a + c0 * r0b

    r1a = a0 * c1 - a2 * s1 + 2.0 * w1 * w0 * s0
    r1b1 = (a0 * c0 + w1 * w1 * c0 * c0 * s1 + w0 * w0 * s1
            - a1 * s1 * s0 + 2.0 * w1 * w0 * c1 * c0 * s0)
    r1b2 = -(a2 * c0 + w1 * w1 * c1 * c0 * c0 + w0 * w0 * c1
             - a1 * c1 * s0 - 2.0 * w1 * w0 * c0 * s1 * s0)
    acc1 = (r1a * r1a * (r1b1 * c1 + r1b2 * s1)
            / (r1b1 * r1b1 + r1b2 * r1b2 + TINY))
    return jnp.stack([acc0, acc1, jnp.zeros_like(acc0)], axis=-1)


# ---------------------------------------------------------------------------
# dimension dispatch
# ---------------------------------------------------------------------------

def transformation_matrix(n, dim: int):
    return transformation_matrix_2d(n) if dim == 2 else transformation_matrix_3d(n)


def rotate_pseudo_normal(rot, dim: int):
    """Local pseudo normal from the rotation angles, padded to (N, dim)."""
    if dim == 2:
        return rotate_pseudo_normal_2d(rot[..., 0])
    return rotate_pseudo_normal_3d(rot)


def pseudo_normal_rate(rot, angvel, dim: int):
    if dim == 2:
        return pseudo_normal_rate_2d(rot[..., 0], angvel[..., 0])
    return pseudo_normal_rate_3d(rot, angvel)


def rotation_accel_from_pseudo_normal(a_local, rot, angvel, dim: int):
    """(N, dim) angular acceleration; unused trailing components zero."""
    if dim == 2:
        acc = rotation_accel_from_pseudo_normal_2d(a_local, rot[..., 0],
                                                   angvel[..., 0])
        return jnp.stack([acc, jnp.zeros_like(acc)], axis=-1)
    return rotation_accel_from_pseudo_normal_3d(a_local, rot, angvel)


def correction_matrix(A_local, dim: int):
    """getCorrectionMatrix: inverse of the in-plane block, normal row/col
    zero (thin_structure_math.cpp:180-194)."""
    B = jnp.zeros_like(A_local)
    if dim == 2:
        return B.at[..., 0, 0].set(1.0 / A_local[..., 0, 0])
    inv2 = jnp.linalg.inv(A_local[..., :2, :2])
    return B.at[..., :2, :2].set(inv2)


def corrected_almansi_strain(almansi, nu, dim: int):
    """Plane-stress correction: eps_nn = -nu * tr_inplane / (1-nu)
    (getCorrectedAlmansiStrain)."""
    tr_inplane = jnp.einsum("...kk->...", almansi[..., :dim - 1, :dim - 1])
    return almansi.at[..., dim - 1, dim - 1].set(-nu * tr_inplane / (1.0 - nu))


def make_shell_state(pos, normal, spacing: float, thickness: float, material,
                     dtype=jnp.float32, volume=None) -> State:
    """Shell particle state (SurfaceParticles variables,
    surface_particles.cpp:28-43): VolumetricMeasure is the MID-SURFACE
    measure spacing^(d-1) — no thickness factor (the shell case generators
    register particle_spacing as the measure, e.g. 2d_shell.cpp:56) —
    plus the shell kinematic registry."""
    import numpy as np
    from sphinxsys_jax.core.state import make_base_state

    pos = np.asarray(pos)
    n, dim = pos.shape
    # `volume` overrides the lattice measure (CVT generators use
    # total_area / n, test_3d_shell_stability_half_sphere.cpp:132)
    vol = spacing ** (dim - 1) if volume is None else volume
    state = dict(make_base_state(pos, vol, material.rho0, dtype=dtype))
    # Mass carries the thickness factor (surface_particles.h:52
    # ParticleVolume = Vol * thickness): VolumetricMeasure stays the
    # mid-surface AREA, so external (coupling) forces divide by the TRUE
    # mass; the internal stress-relaxation accelerations cancel Mass and
    # are unchanged.
    state["Mass"] = state["Mass"] * jnp.asarray(thickness, dtype=dtype)
    normal = jnp.asarray(np.asarray(normal), dtype=dtype)
    zeros_v = jnp.zeros((n, dim), dtype=dtype)
    eye = jnp.broadcast_to(jnp.eye(dim, dtype=dtype), (n, dim, dim))
    state.update({
        "InitialPosition": state["Position"],
        "Velocity": zeros_v,
        "Force": zeros_v,
        "ForcePrior": zeros_v,
        "NormalDirection": normal,
        "InitialNormalDirection": normal,
        "PseudoNormal": normal,
        "Rotation": zeros_v,             # component 0 = angle about z
        "AngularVelocity": zeros_v,
        "AngularAcceleration": zeros_v,
        "Thickness": jnp.full((n,), thickness, dtype=dtype),
        "DeformationGradient": eye,
        "DeformationRate": jnp.zeros((n, dim, dim), dtype=dtype),
        "BendingDeformationGradient": jnp.zeros((n, dim, dim), dtype=dtype),
        "BendingDeformationRate": jnp.zeros((n, dim, dim), dtype=dtype),
        "GlobalStress": jnp.zeros((n, dim, dim), dtype=dtype),
        "GlobalMoment": jnp.zeros((n, dim, dim), dtype=dtype),
        "GlobalShearStress": zeros_v,
        "GlobalF": eye,
        "GlobalFBending": jnp.zeros((n, dim, dim), dtype=dtype),
        "MidSurfaceCauchyStress": jnp.zeros((n, dim, dim), dtype=dtype),
        "PseudoNormalRate": zeros_v,
        "TransformationMatrix0": transformation_matrix(normal, dim),
    })
    return state


def shell_correct_configuration(shell: State, rp: ReferencePairs) -> State:
    """ShellCorrectConfiguration (thin_structure_dynamics.h:89-105): B from
    the LOCAL in-plane configuration (getCorrectionMatrix)."""
    out = dict(shell)
    dim = shell["Position"].shape[-1]
    vol_j, _ = gather(shell["VolumetricMeasure"], rp.idx)
    grad = (rp.dW * vol_j * rp.mask)[..., None] * rp.e
    r_ji = -rp.r[..., None] * rp.e
    A = jnp.einsum("nki,nkj->nij", r_ji, grad) + 1e-7 * jnp.eye(dim, dtype=grad.dtype)
    Q0 = shell["TransformationMatrix0"]
    A_local = Q0 @ A @ jnp.swapaxes(Q0, -1, -2)
    out["LinearGradientCorrectionMatrix"] = correction_matrix(A_local, dim)
    return out


def _stress_cauchy_linear(almansi, lambda0, G0):
    eye = jnp.eye(almansi.shape[-1], dtype=almansi.dtype)
    tr = jnp.trace(almansi, axis1=-2, axis2=-1)
    return lambda0 * tr[..., None, None] * eye + 2.0 * G0 * almansi


def shell_stress_relaxation_1st_half(shell: State, rp: ReferencePairs,
                                     material, dt, smoothing_length: float,
                                     n_gauss: int = 3) -> State:
    """ShellStressRelaxationFirstHalf (thin_structure_dynamics.cpp:
    initialization through-thickness Gauss integration + pair interaction
    exchanging resultant stress/moment/shear + velocity/rotation kick)."""
    out = dict(shell)
    dim = shell["Position"].shape[-1]
    rho0 = material.rho0
    nu = material.poisson_ratio
    G0 = material.shear_modulus
    lambda0 = material.lambda0
    # plane-stress lambda (elastic_solid Cauchy uses 3D lambda; the shell
    # plane-stress correction of the strain handles the reduction)
    Q0 = shell["TransformationMatrix0"]
    Q0T = jnp.swapaxes(Q0, -1, -2)
    thickness = shell["Thickness"]

    # ---- initialization ----------------------------------------------------
    pos = shell["Position"] + shell["Velocity"] * (0.5 * dt)
    rot = shell["Rotation"] + shell["AngularVelocity"] * (0.5 * dt)
    pseudo_n = jnp.einsum("nij,nj->ni", Q0T, rotate_pseudo_normal(rot, dim))
    F = shell["DeformationGradient"] + shell["DeformationRate"] * (0.5 * dt)
    Fb = shell["BendingDeformationGradient"] + shell["BendingDeformationRate"] * (0.5 * dt)
    global_F = Q0T @ F @ Q0
    global_Fb = Q0T @ Fb @ Q0
    J = jnp.linalg.det(F)
    inv_T_global_F = jnp.swapaxes(jnp.linalg.inv(global_F), -1, -2)
    rho = rho0 / J

    Qc = transformation_matrix(pseudo_n, dim)  # current local frame
    Q0c = Qc @ Q0T  # initial local -> current local

    resultant_stress = jnp.zeros_like(F)
    resultant_moment = jnp.zeros_like(F)
    resultant_shear = jnp.zeros_like(pos)
    mid_cauchy = None
    # numerical damping scaling (cpp: diag(h, ..., min(thickness, h)))
    scale_diag = jnp.stack(
        [jnp.full_like(thickness, smoothing_length)] * (dim - 1)
        + [jnp.minimum(thickness, smoothing_length)], axis=-1)
    cs0 = math.sqrt(G0 / rho0)
    c0 = material.sound_speed

    for gp, gw in zip(GAUSS_3_POINTS[:n_gauss], GAUSS_3_WEIGHTS[:n_gauss]):
        F_g = F + gp * Fb * (thickness * 0.5)[..., None, None]
        dF_g = shell["DeformationRate"] + gp * shell["BendingDeformationRate"] * (
            thickness * 0.5)[..., None, None]
        inv_F_g = jnp.linalg.inv(F_g)
        eye = jnp.eye(dim, dtype=F.dtype)
        almansi = Q0c @ (0.5 * (eye - jnp.swapaxes(inv_F_g, -1, -2) @ inv_F_g)) @ jnp.swapaxes(Q0c, -1, -2)
        # plane-stress correction (thin_structure_math getCorrectedAlmansiStrain)
        almansi = corrected_almansi_strain(almansi, nu, dim)
        cauchy = _stress_cauchy_linear(almansi, lambda0, G0)
        # numerical damping (NumericalDampingRightCauchy with diag scaling)
        strain_rate = 0.5 * (jnp.swapaxes(dF_g, -1, -2) @ F_g + jnp.swapaxes(F_g, -1, -2) @ dF_g)
        normal_rate = strain_rate * jnp.eye(dim, dtype=F.dtype)
        damping = 0.5 * rho0 * (cs0 * (strain_rate - normal_rate) + c0 * normal_rate)
        damping = damping * scale_diag[..., None, :]  # column scaling
        cauchy = cauchy + (Q0c @ F_g @ damping @ jnp.swapaxes(F_g, -1, -2) @ jnp.swapaxes(Q0c, -1, -2)) / jnp.linalg.det(F_g)[..., None, None]
        # modeling assumptions: shear correction + zero normal stress
        corr = jnp.ones((dim, dim), dtype=F.dtype).at[dim - 1, :].mul(SHEAR_CORRECTION) \
                                   .at[:, dim - 1].mul(SHEAR_CORRECTION) \
                                   .at[dim - 1, dim - 1].set(0.0)
        cauchy = cauchy * corr
        if mid_cauchy is None:
            mid_cauchy = cauchy
        half_t = (0.5 * thickness * gw)[..., None, None]
        resultant_stress = resultant_stress + half_t * cauchy
        resultant_moment = resultant_moment + half_t * cauchy * (gp * 0.5 * thickness)[..., None, None]
        resultant_shear = resultant_shear - half_t[..., 0] * cauchy[..., :, dim - 1]
        resultant_stress = resultant_stress.at[..., :, dim - 1].set(0.0)
        resultant_moment = resultant_moment.at[..., :, dim - 1].set(0.0)

    QcT = jnp.swapaxes(Qc, -1, -2)
    global_stress = J[..., None, None] * (QcT @ resultant_stress @ Qc @ inv_T_global_F)
    global_moment = J[..., None, None] * (QcT @ resultant_moment @ Qc @ inv_T_global_F)
    global_shear = J[..., None] * jnp.einsum("nij,nj->ni", QcT, resultant_shear)

    # ---- interaction --------------------------------------------------------
    vol_j, _ = gather(shell["VolumetricMeasure"], rp.idx)
    gs_j, _ = gather(global_stress, rp.idx)
    gm_j, _ = gather(global_moment, rp.idx)
    coeff = (rp.dW * vol_j * rp.mask)[..., None]
    mass = shell["Mass"]
    force = mass[:, None] * jnp.sum(jnp.einsum(
        "nkij,nkj->nki", global_stress[:, None] + gs_j, rp.e) * coeff, axis=1)
    pseudo_acc = global_shear + jnp.sum(jnp.einsum(
        "nkij,nkj->nki", global_moment[:, None] + gm_j, rp.e) * coeff, axis=1)

    force = force / (rho0 * thickness)[..., None]
    dpseudo_n_d2t = pseudo_acc * (12.0 / (rho0 * thickness**3))[..., None]
    a_local = jnp.einsum("nij,nj->ni", Q0, dpseudo_n_d2t)
    omega = shell["AngularVelocity"]
    domega_dt = rotation_accel_from_pseudo_normal(a_local, rot, omega, dim)

    # ---- update --------------------------------------------------------------
    vel = shell["Velocity"] + (shell["ForcePrior"] + force) / mass[:, None] * dt
    omega_new = omega + domega_dt * dt

    out.update({
        "Position": pos, "Density": rho, "PseudoNormal": pseudo_n,
        "DeformationGradient": F, "BendingDeformationGradient": Fb,
        "GlobalF": global_F, "GlobalFBending": global_Fb,
        "GlobalStress": global_stress, "GlobalMoment": global_moment,
        "GlobalShearStress": global_shear,
        "MidSurfaceCauchyStress": mid_cauchy,
        "Force": force,
        "Rotation": rot,
        "AngularVelocity": omega_new,
        "AngularAcceleration": domega_dt,
        "Velocity": vel,
    })
    return out


def shell_stress_relaxation_2nd_half(shell: State, rp: ReferencePairs, dt) -> State:
    """ShellStressRelaxationSecondHalf: position/rotation drift, deformation
    rate from pair velocity/pseudo-normal-rate gradients, F drift."""
    out = dict(shell)
    dim = shell["Position"].shape[-1]
    Q0 = shell["TransformationMatrix0"]
    Q0T = jnp.swapaxes(Q0, -1, -2)

    pos = shell["Position"] + shell["Velocity"] * (0.5 * dt)
    rot = shell["Rotation"] + shell["AngularVelocity"] * (0.5 * dt)
    omega = shell["AngularVelocity"]
    dpseudo_n_dt = jnp.einsum("nij,nj->ni", Q0T,
                              pseudo_normal_rate(rot, omega, dim))
    pseudo_n = jnp.einsum("nij,nj->ni", Q0T, rotate_pseudo_normal(rot, dim))

    vel = shell["Velocity"]
    vol_j, _ = gather(shell["VolumetricMeasure"], rp.idx)
    vel_j, _ = gather(vel, rp.idx)
    dn_j, _ = gather(dpseudo_n_dt, rp.idx)
    grad = (rp.dW * vol_j * rp.mask)[..., None] * rp.e
    part1 = -jnp.einsum("nki,nkj->nij", vel[:, None] - vel_j, grad)
    part2 = -jnp.einsum("nki,nkj->nij", dpseudo_n_dt[:, None] - dn_j, grad)

    B = shell["LinearGradientCorrectionMatrix"]
    dF_dt = Q0 @ part1 @ Q0T @ B
    dF_dt = dF_dt.at[..., :, dim - 1].set(
        jnp.einsum("nij,nj->ni", Q0, dpseudo_n_dt))
    dFb_dt = Q0 @ part2 @ Q0T @ B

    out.update({
        "Position": pos,
        "Rotation": rot,
        "PseudoNormal": pseudo_n, "PseudoNormalRate": dpseudo_n_dt,
        "DeformationRate": dF_dt, "BendingDeformationRate": dFb_dt,
        "DeformationGradient": shell["DeformationGradient"] + dF_dt * (0.5 * dt),
        "BendingDeformationGradient": shell["BendingDeformationGradient"] + dFb_dt * (0.5 * dt),
    })
    return out


def shell_acoustic_time_step(shell: State, material, smoothing_length: float,
                             cfl: float = 0.6):
    """ShellAcousticTimeStepSize (thin_structure_dynamics.cpp)."""
    mass = shell["Mass"]
    accel = jnp.linalg.norm((shell["Force"] + shell["ForcePrior"]), axis=-1) / mass
    v = jnp.linalg.norm(shell["Velocity"], axis=-1)
    c0 = material.sound_speed
    E0, nu = material.youngs_modulus, material.poisson_ratio
    rho0 = material.rho0
    t0 = jnp.minimum(jnp.sqrt(smoothing_length / (accel + TINY)),
                     smoothing_length / (c0 + v))
    domega = jnp.linalg.norm(shell["AngularAcceleration"], axis=-1)
    omega = jnp.linalg.norm(shell["AngularVelocity"], axis=-1)
    t1 = jnp.minimum(jnp.sqrt(1.0 / (domega + TINY)), 1.0 / (omega + TINY))
    th = shell["Thickness"]
    t2 = smoothing_length * jnp.sqrt(
        rho0 * (1.0 - nu * nu) / E0 /
        (2.0 + (math.pi**2 / 12.0) * (1.0 - nu) *
         (1.0 + 1.5 * (smoothing_length / th) ** 2)))
    per = jnp.minimum(jnp.minimum(t0, t1), t2)
    return cfl * jnp.min(per)


def update_shell_normal(shell: State) -> State:
    """UpdateShellNormalDirection (thin_structure_dynamics.cpp): the current
    mid-surface normal from the LOCAL deformation gradient, rotated back to
    the global frame (getNormalFromDeformationGradientTensor)."""
    out = dict(shell)
    F = shell["DeformationGradient"]          # local frame
    dim = F.shape[-1]
    if dim == 2:
        c0 = F[..., :, 0]
        v = jnp.stack([-c0[..., 1], c0[..., 0]], axis=-1)
    else:
        v = jnp.cross(F[..., :, 0], F[..., :, 1])
    v = v / (jnp.linalg.norm(v, axis=-1, keepdims=True) + 1.0e-15)
    Q0T = jnp.swapaxes(shell["TransformationMatrix0"], -1, -2)
    out["NormalDirection"] = jnp.einsum("nij,nj->ni", Q0T, v)
    return out
