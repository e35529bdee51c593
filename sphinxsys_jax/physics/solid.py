"""Total-Lagrangian elastic solid dynamics.

Counterpart of /root/reference/src/shared/particle_dynamics/solid_dynamics/
elastic_dynamics.{h,cpp} and general_dynamics/kernel_correction.cpp.

The solid pair topology lives on the INITIAL configuration: the inner
relation is built once on the undeformed positions and never rebuilt —
ideal for XLA (one static neighbor tensor, kernel values precomputed).
`ReferencePairs` freezes dW_ij, e_ij, r_ij, W_ij of that configuration.

Verlet scheme (elastic_dynamics.cpp):
  1st half:
    init:     x += v dt/2 ; F += dF/dt dt/2 ; rho = rho0/det(F)
              S_i = StressPK1(F_i) B_i^T
    interact: force_i = m_i/rho0 sum_j dW_ij V_j
                  (S_i + S_j + factor (W_ij/W0) * 0.5 (F_i+F_j) pair_damping) e_ij
              pair_damping = 0.5 rho0 c0 h * (dim/r_ij)^2 (x_i-x_j).(v_i-v_j)
    update:   v += (F + F_prior)/m dt
  2nd half:
    init:     x += v dt/2
    interact: dF/dt_i = -[sum_j (v_i - v_j) outer (dW_ij V_j e_ij)] B_i
    update:   F += dF/dt dt/2
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from sphinxsys_jax.core.state import State
from sphinxsys_jax.neighbors.neighbor_list import NeighborList, gather
from sphinxsys_jax.physics.pair import pair_geometry, PairGeometry

TINY = 1.0e-15


class ReferencePairs(NamedTuple):
    """Frozen initial-configuration pair data for total-Lagrangian ops."""

    idx: jnp.ndarray    # (N, K) neighbor indices (sentinel = N_src)
    W: jnp.ndarray      # (N, K)
    dW: jnp.ndarray     # (N, K)
    r: jnp.ndarray      # (N, K)
    e: jnp.ndarray      # (N, K, dim)  unit j -> i
    mask: jnp.ndarray   # (N, K)


def freeze_reference_pairs(pos0, nl: NeighborList, kernel, dim: int) -> ReferencePairs:
    pg = pair_geometry(pos0, pos0, nl, kernel, dim)
    return ReferencePairs(idx=nl.idx, W=pg.W, dW=pg.dW, r=pg.r, e=pg.e, mask=pg.mask)


def freeze_adaptive_reference_pairs(pos0, h_ratio, nl: NeighborList,
                                    kernel, dim: int) -> ReferencePairs:
    """Adaptive-h variant of freeze_reference_pairs for multi-resolution
    solids (the reference's ParticleWithLocalRefinement /
    AdaptiveWithinShape bodies, test_2d_mr_cantilever_beam.cpp:190): each
    frozen pair is evaluated at the pair smoothing length max(h_i, h_j)
    (= min of the h-ratios), and W is pre-normalized by that pair's W(0)
    so integration_1st_half_pk2's damping weight runs with w0 = 1."""
    pos_j, mask = gather(pos0, nl.idx)
    hr_j, _ = gather(h_ratio, nl.idx)
    hr_pair = jnp.minimum(h_ratio[:, None], hr_j)   # pair h = max(h_i, h_j)
    disp = pos0[:, None, :] - pos_j
    r = jnp.sqrt(jnp.sum(disp * disp, axis=-1) + TINY)
    e = disp / (r[..., None] + TINY)
    fmask = mask.astype(pos0.dtype)
    W = kernel.W_adaptive(r, hr_pair, dim) * fmask
    dW = kernel.dW_adaptive(r, hr_pair, dim) * fmask
    w0_pair = (kernel._factor_w(dim) * (hr_pair ** dim)
               * kernel._w(jnp.zeros((), pos0.dtype))).astype(W.dtype)
    return ReferencePairs(idx=nl.idx, W=(W / w0_pair).astype(W.dtype), dW=dW,
                          r=r, e=e, mask=mask)


def linear_gradient_correction_matrix(rp: ReferencePairs, vol, alpha: float = 0.0,
                                      eps: float = 1.0e-8):
    """B matrix (kernel_correction.cpp LinearGradientCorrectionMatrix):
    A_i = -sum_j r_ji outer gradW_ij V_j  with r_ji = r_ij e_ij;
    B_i = w1 * tikhonov_inverse(A_i) + w2 * I   with determinant weighting."""
    vol_j, _ = gather(vol, rp.idx)
    grad = (rp.dW * vol_j)[..., None] * rp.e  # (N, K, dim)
    r_ji = rp.r[..., None] * rp.e
    A = -jnp.einsum("nki,nkj->nij", r_ji, grad)
    det = jnp.linalg.det(A)
    dim = A.shape[-1]
    eye = jnp.eye(dim, dtype=A.dtype)
    At = jnp.swapaxes(A, -1, -2)
    inv = jnp.linalg.inv(At @ A + eps * eye) @ At  # inverseTikhonov
    det_sqr = jnp.maximum(alpha - det, 0.0)
    w1 = det / (det + det_sqr)
    w2 = det_sqr / (det + det_sqr)
    return w1[..., None, None] * inv + w2[..., None, None] * eye


def integration_1st_half_pk2(solid: State, rp: ReferencePairs, material,
                             dt, smoothing_length: float, w0: float,
                             numerical_dissipation_factor: float = 0.25,
                             active_stress_fn=None, pk1_fn=None) -> State:
    """`active_stress_fn(solid, F) -> PK2 active stress` implements
    ActiveMuscle / ActiveContractionForce (active_muscle_dynamics,
    complex_solid.h:42-96): typically Ta * fiber outer fiber from the
    electrophysiology's ActiveContractionStress species.

    `pk1_fn(solid, F) -> PK1 stress` REPLACES the constitutive evaluation
    entirely (before the B-matrix correction) — the hook for per-particle
    composite materials like the fish ActiveModelSolid whose stress is
    natively first Piola-Kirchhoff (active_model.cpp StressPK1)."""
    out = dict(solid)
    dim = solid["Position"].shape[1]
    rho0 = material.rho0
    c0 = material.sound_speed

    # --- initialization ---------------------------------------------------
    pos = solid["Position"] + solid["Velocity"] * (0.5 * dt)
    F = solid["DeformationGradient"] + solid["DeformationRate"] * (0.5 * dt)
    rho = rho0 / jnp.linalg.det(F)
    B = solid["LinearGradientCorrectionMatrix"]
    if pk1_fn is not None:
        P = pk1_fn(solid, F)
    else:
        S2 = material.stress_PK2(F)
        if active_stress_fn is not None:
            S2 = S2 + active_stress_fn(solid, F)
        P = F @ S2
    S = P @ jnp.swapaxes(B, -1, -2)  # StressPK1OnParticle

    # --- interaction -------------------------------------------------------
    vel = solid["Velocity"]
    vol = solid["VolumetricMeasure"]
    vol_j, _ = gather(vol, rp.idx)
    S_j, _ = gather(S, rp.idx)
    F_j, _ = gather(F, rp.idx)
    pos_j, _ = gather(pos, rp.idx)
    vel_j, _ = gather(vel, rp.idx)

    dim_over_r = dim / (rp.r + TINY)
    strain_rate = dim_over_r * dim_over_r * jnp.sum(
        (pos[:, None, :] - pos_j) * (vel[:, None, :] - vel_j), axis=-1)
    pair_damping = 0.5 * rho0 * c0 * strain_rate * smoothing_length  # PairNumericalDamping
    weight = rp.W / w0
    stress_ij = (S[:, None, :, :] + S_j
                 + (numerical_dissipation_factor * weight * pair_damping)[..., None, None]
                 * 0.5 * (F[:, None, :, :] + F_j))
    coeff = (rp.dW * vol_j * rp.mask)[..., None]
    force = (solid["Mass"] / rho0)[:, None] * jnp.sum(
        jnp.einsum("nkij,nkj->nki", stress_ij, rp.e) * coeff, axis=1)

    # --- update -------------------------------------------------------------
    vel = solid["Velocity"] + (solid["ForcePrior"] + force) / solid["Mass"][:, None] * dt

    out.update({
        "Position": pos, "DeformationGradient": F, "Density": rho,
        "StressPK1OnParticle": S, "Force": force, "Velocity": vel,
    })
    return out


def cauchy_pk1_fn(material):
    """PK1 hook implementing Integration1stHalfCauchy
    (elastic_dynamics.cpp:148-160): obtain PK1 from the Cauchy stress of
    the Almansi strain, P = J sigma(eps_almansi) F^-T; pass as
    `pk1_fn` to integration_1st_half_pk2."""
    def pk1(solid, F):
        dim = F.shape[-1]
        eye = jnp.eye(dim, dtype=F.dtype)
        J = jnp.linalg.det(F)
        FFT = F @ jnp.swapaxes(F, -1, -2)
        almansi = 0.5 * (eye - jnp.linalg.inv(FFT))
        invFT = jnp.swapaxes(jnp.linalg.inv(F), -1, -2)
        return J[..., None, None] * material.stress_cauchy(almansi) @ invFT
    return pk1


def decomposed_integration_1st_half(solid: State, rp: ReferencePairs,
                                    material, dt, smoothing_length: float,
                                    correction_factor: float = 1.07) -> State:
    """DecomposedIntegration1stHalf (elastic_dynamics.cpp:162-184,
    elastic_dynamics.h:259-287): Kirchhoff stress decomposition — the
    volumetric part rides the usual stress-pair sum while the deviatoric
    (shear) part becomes a pairwise hourglass-free central force along the
    CURRENT pair direction:

      S_i      = F_i^-T [VolK(J) - cf G J^{-2/d} tr(F F^T)/d]
                 + NumericalDampingLeftCauchy(F, dF/dt, h) F_i^-T
      shear_ij = cf G (J_i^{-2/d} + J_j^{-2/d}) (x_i - x_j)/r0_ij
      F_i      = m_i/rho0 sum_j [(S_i + S_j) e0_ij + shear_ij] dW0 V_j

    (frozen reference kernel/volumes; robust for very large rotation, used
    by test_3d_twisting_column.)"""
    out = dict(solid)
    dim = solid["Position"].shape[1]
    rho0 = material.rho0
    G = material.shear_modulus

    # --- initialization ----------------------------------------------------
    pos = solid["Position"] + solid["Velocity"] * (0.5 * dt)
    F = solid["DeformationGradient"] + solid["DeformationRate"] * (0.5 * dt)
    dF = solid["DeformationRate"]
    J = jnp.linalg.det(F)
    rho = rho0 / J
    Jm2d = (1.0 / (J * J)) ** (1.0 / dim)
    invFT = jnp.swapaxes(jnp.linalg.inv(F), -1, -2)
    trFFT = jnp.einsum("nij,nij->n", F, F)
    scalar = (material.volumetric_kirchhoff(J)
              - correction_factor * G * Jm2d * trFFT / dim)
    # NumericalDampingLeftCauchy (elastic_solid.h:91-97)
    sr = 0.5 * (dF @ jnp.swapaxes(F, -1, -2) + F @ jnp.swapaxes(dF, -1, -2))
    diag = jnp.eye(dim, dtype=F.dtype) * sr
    damp = 0.5 * rho0 * (material.shear_wave_speed * (sr - diag)
                         + material.sound_speed * diag) * smoothing_length
    S = scalar[:, None, None] * invFT + damp @ invFT

    # --- interaction ---------------------------------------------------------
    vol_j, _ = gather(solid["VolumetricMeasure"], rp.idx)
    S_j, _ = gather(S, rp.idx)
    Jm2d_j, _ = gather(Jm2d, rp.idx)
    pos_j, _ = gather(pos, rp.idx)
    shear = (correction_factor * G * (Jm2d[:, None] + Jm2d_j)
             / (rp.r + TINY))[..., None] * (pos[:, None, :] - pos_j)
    pair = jnp.einsum("nkij,nkj->nki", S[:, None] + S_j, rp.e) + shear
    coeff = (rp.dW * vol_j * rp.mask)[..., None]
    force = (solid["Mass"] / rho0)[:, None] * jnp.sum(pair * coeff, axis=1)

    # --- update ----------------------------------------------------------------
    vel = solid["Velocity"] + (solid["ForcePrior"] + force) / solid["Mass"][:, None] * dt
    out.update({
        "Position": pos, "DeformationGradient": F, "Density": rho,
        "Force": force, "Velocity": vel,
    })
    return out


def decomposed_plastic_integration_1st_half(solid: State, rp: ReferencePairs,
                                            material, dt,
                                            smoothing_length: float) -> State:
    """DecomposedPlasticIntegration1stHalf (inelastic_dynamics.cpp:16-33,
    inelastic_dynamics.h:44-80): the essentially non-hourglass
    volumetric-deviatoric decomposition for J2-plastic solids.  Per
    particle the radial-return map updates the carried plastic state
    (InversePlasticStrain, HardeningParameter) and yields the normalized
    elastic left Cauchy-Green tensor be:

      scaling_i = be_i F_i^-T
      S_i       = F_i^-T [VolK(J) - G tr(be)/d] + 0.125 damping F_i^-T
      e_diff    = 0.5 (F_i^-1 + F_j^-1) (x_i - x_j)/r0_ij - e0_ij
      limiter   = min(10 max(|e_diff| - 0.05, 0), 1)
      shear_ij  = G (scaling_i + scaling_j) (e0_ij + limiter e_diff)
      F_i      += m_i/rho0 sum_j [(S_i + S_j) e0_ij + shear_ij] dW0 V_j

    (frozen reference pairs r0/e0/dW0; the limiter feeds the deviatoric
    force the *current* pair direction only once particles shear visibly,
    which keeps the quasi-static necking free of hourglass modes)."""
    out = dict(solid)
    dim = solid["Position"].shape[1]
    rho0 = material.rho0
    G = material.shear_modulus

    # --- initialization ----------------------------------------------------
    pos = solid["Position"] + solid["Velocity"] * (0.5 * dt)
    F = solid["DeformationGradient"] + solid["DeformationRate"] * (0.5 * dt)
    dF = solid["DeformationRate"]
    J = jnp.linalg.det(F)
    rho = rho0 / J
    nbe, inv_ps, kappa = material.elastic_left_cauchy(
        F, solid["InversePlasticStrain"], solid["HardeningParameter"])
    invF = jnp.linalg.inv(F)
    invFT = jnp.swapaxes(invF, -1, -2)
    scaling = nbe @ invFT
    iso = G * jnp.trace(nbe, axis1=-2, axis2=-1) / dim
    # NumericalDampingLeftCauchy (elastic_solid.h:91-97), 0.125-weighted
    sr = 0.5 * (dF @ jnp.swapaxes(F, -1, -2) + F @ jnp.swapaxes(dF, -1, -2))
    diag = jnp.eye(dim, dtype=F.dtype) * sr
    damp = 0.5 * rho0 * (material.shear_wave_speed * (sr - diag)
                         + material.sound_speed * diag) * smoothing_length
    S = ((material.volumetric_kirchhoff(J) - iso)[:, None, None] * invFT
         + 0.125 * damp @ invFT)

    # --- interaction --------------------------------------------------------
    vol_j, _ = gather(solid["VolumetricMeasure"], rp.idx)
    S_j, _ = gather(S, rp.idx)
    scal_j, _ = gather(scaling, rp.idx)
    invF_j, _ = gather(invF, rp.idx)
    pos_j, _ = gather(pos, rp.idx)
    pair_d = pos[:, None, :] - pos_j                      # (N,K,d)
    pair_invF = 0.5 * (invF[:, None] + invF_j)            # (N,K,d,d)
    e_diff = (jnp.einsum("nkij,nkj->nki", pair_invF, pair_d)
              / (rp.r + TINY)[..., None]) - rp.e
    e_norm = jnp.linalg.norm(e_diff, axis=-1)
    limiter = jnp.minimum(10.0 * jnp.maximum(e_norm - 0.05, 0.0), 1.0)
    shear = G * jnp.einsum("nkij,nkj->nki", scaling[:, None] + scal_j,
                           rp.e + limiter[..., None] * e_diff)
    pair = jnp.einsum("nkij,nkj->nki", S[:, None] + S_j, rp.e) + shear
    coeff = (rp.dW * vol_j * rp.mask)[..., None]
    force = (solid["Mass"] / rho0)[:, None] * jnp.sum(pair * coeff, axis=1)

    # --- update --------------------------------------------------------------
    vel = solid["Velocity"] + (solid["ForcePrior"] + force) / solid["Mass"][:, None] * dt
    out.update({
        "Position": pos, "DeformationGradient": F, "Density": rho,
        "Force": force, "Velocity": vel,
        "InversePlasticStrain": inv_ps, "HardeningParameter": kappa,
    })
    return out


def integration_2nd_half(solid: State, rp: ReferencePairs, dt) -> State:
    out = dict(solid)
    pos = solid["Position"] + solid["Velocity"] * (0.5 * dt)
    vel = solid["Velocity"]
    vol = solid["VolumetricMeasure"]
    vol_j, _ = gather(vol, rp.idx)
    vel_j, _ = gather(vel, rp.idx)
    grad = (rp.dW * vol_j * rp.mask)[..., None] * rp.e  # (N,K,dim)
    dvel = vel[:, None, :] - vel_j
    dF_dt_raw = -jnp.einsum("nki,nkj->nij", dvel, grad)
    dF_dt = dF_dt_raw @ solid["LinearGradientCorrectionMatrix"]
    F = solid["DeformationGradient"] + dF_dt * (0.5 * dt)
    out.update({"Position": pos, "DeformationRate": dF_dt, "DeformationGradient": F})
    return out


def deformation_gradient_by_summation(solid: State, rp: ReferencePairs) -> State:
    """F_i = [-sum_j (x_i - x_j) outer gradW_ij V_j] B_i
    (elastic_dynamics.h:107-122)."""
    out = dict(solid)
    pos = solid["Position"]
    vol_j, _ = gather(solid["VolumetricMeasure"], rp.idx)
    pos_j, _ = gather(pos, rp.idx)
    grad = (rp.dW * vol_j * rp.mask)[..., None] * rp.e
    F_raw = -jnp.einsum("nki,nkj->nij", pos[:, None, :] - pos_j, grad)
    out["DeformationGradient"] = F_raw @ solid["LinearGradientCorrectionMatrix"]
    return out


def von_mises_stress(solid: State, material):
    """Derived observable (solid_dynamics_variable.*): von Mises equivalent
    of the Cauchy stress sigma = F S F^T / J."""
    F = solid["DeformationGradient"]
    dim = F.shape[-1]
    S = material.stress_PK2(F)
    J = jnp.linalg.det(F)
    sigma = (F @ S @ jnp.swapaxes(F, -1, -2)) / J[..., None, None]
    tr = jnp.trace(sigma, axis1=-2, axis2=-1) / dim
    dev = sigma - tr[..., None, None] * jnp.eye(dim, dtype=F.dtype)
    return jnp.sqrt(1.5 * jnp.sum(dev * dev, axis=(-2, -1)))


def von_mises_strain(solid: State):
    """Von Mises equivalent of the Green-Lagrange strain."""
    F = solid["DeformationGradient"]
    dim = F.shape[-1]
    E = 0.5 * (jnp.swapaxes(F, -1, -2) @ F - jnp.eye(dim, dtype=F.dtype))
    tr = jnp.trace(E, axis1=-2, axis2=-1) / dim
    dev = E - tr[..., None, None] * jnp.eye(dim, dtype=F.dtype)
    return jnp.sqrt(2.0 / 3.0 * jnp.sum(dev * dev, axis=(-2, -1)))


def active_fiber_stress(ta_key: str = "ActiveContractionStress",
                        fiber_key: str = "Fiber"):
    """ActiveMuscle active stress: S_active = Ta * f outer f
    (complex_solid.h ActiveMuscle / active_muscle_dynamics
    ActiveContractionForce); Ta comes from the electrophysiology species."""

    def fn(solid: State, F):
        ta = solid[ta_key]
        f = solid[fiber_key]
        return ta[..., None, None] * (f[..., :, None] * f[..., None, :])

    return fn


def solid_acoustic_time_step(solid: State, c0: float, h_min: float,
                             cfl: float = 0.6):
    """AcousticTimeStep (elastic_dynamics.cpp): per-particle
    CFL * min(sqrt(h/|a|), h/(c0 + |v|)), reduced by min."""
    n = solid["Position"].shape[0]
    valid = jnp.arange(n) < solid["NReal"]
    accel = jnp.linalg.norm(
        (solid["Force"] + solid["ForcePrior"]) / solid["Mass"][:, None], axis=-1)
    v = jnp.linalg.norm(solid["Velocity"], axis=-1)
    per = jnp.minimum(jnp.sqrt(h_min / (accel + TINY)), h_min / (c0 + v))
    return cfl * jnp.min(jnp.where(valid, per, jnp.inf))


def fix_constraint(solid: State, part_mask) -> State:
    """FixBodyPartConstraint (general_constraint.h FixConstraint):
    pos = pos0, vel = 0 on the constrained part."""
    out = dict(solid)
    m = part_mask[:, None]
    out["Position"] = jnp.where(m, solid["InitialPosition"], solid["Position"])
    out["Velocity"] = jnp.where(m, 0.0, solid["Velocity"])
    return out


def make_elastic_solid_state(pos, volume, material, kernel=None, dtype=jnp.float32,
                             capacity: int | None = None) -> State:
    """Solid body state with the elastic-dynamics variables
    (elastic_dynamics.cpp:60-95 registrations)."""
    from sphinxsys_jax.core.state import make_base_state

    state = make_base_state(pos, volume, material.rho0, capacity, dtype)
    n = state["Position"].shape[0]
    dim = state["Position"].shape[1]
    eye = jnp.broadcast_to(jnp.eye(dim, dtype=dtype), (n, dim, dim))
    zeros_v = jnp.zeros((n, dim), dtype=dtype)
    state.update({
        "InitialPosition": state["Position"],
        "Velocity": zeros_v,
        "Force": zeros_v,
        "ForcePrior": zeros_v,
        "DeformationGradient": eye,
        "DeformationRate": jnp.zeros((n, dim, dim), dtype=dtype),
        "StressPK1OnParticle": jnp.zeros((n, dim, dim), dtype=dtype),
        "LinearGradientCorrectionMatrix": eye,
    })
    return state


def active_model_pk1(F, active_strain, lambda0, G0):
    """ActiveModelSolid::StressPK1 (the fish case's active-strain
    decomposition, tests/2d_examples/test_2d_flow_stream_around_fish/
    active_model.cpp:21-34): F = F_e F0 with the active part
    F0 = chol(2 E_a + I); the passive StVK stress acts on the elastic
    strain E_e = E - E_a and is pushed forward by F0* = det(F0) F0^-T.
    lambda0/G0 may be per-particle arrays (composite bodies)."""
    dim = F.shape[-1]
    eye = jnp.eye(dim, dtype=F.dtype)
    F0 = jnp.linalg.cholesky(2.0 * active_strain + eye)
    F0_inv = jnp.linalg.inv(F0)
    F_e = F @ F0_inv
    F0_star = jnp.linalg.det(F0)[..., None, None] * jnp.swapaxes(F0_inv, -1, -2)
    E_e = 0.5 * (jnp.swapaxes(F, -1, -2) @ F - eye) - active_strain
    lam = jnp.asarray(lambda0, dtype=F.dtype)
    G = jnp.asarray(G0, dtype=F.dtype)
    if lam.ndim == 1:
        lam = lam[:, None, None]
    if G.ndim == 1:
        G = G[:, None, None]
    tr = jnp.trace(E_e, axis1=-2, axis2=-1)[..., None, None]
    passive = lam * tr * eye + 2.0 * G * E_e
    return F_e @ passive @ F0_star
