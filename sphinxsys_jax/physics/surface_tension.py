"""Momentum-conservative multiphase surface tension.

Counterpart of /root/reference/src/shared/particle_dynamics/fluid_dynamics/
surface_tension.{h,cpp} (Zhang & Hu stress-form surface tension): the
interface is carried as a color gradient computed from CONTACT (other-phase)
neighbors only; the tension enters the momentum equation as the divergence
of a tangential stress sigma*(I - n n^T)*|grad C| plus a penalty
("hourglass") force that suppresses the zero-surface-energy modes.

The reference's per-particle while-loops become dense masked (N, K) tensor
contractions; the C++ i/j neighborhood iteration maps to one gather per
contact relation.  Semantics notes (kept bug-compatible, single-contact use):
  * surface_tension.cpp:29-52 OVERWRITES ColorGradient/NormDirection per
    contact body k and ACCUMULATES the stress — with one contact body (the
    only configuration the reference ships) both agree; we accumulate the
    stress and keep the last k's gradient likewise.
  * matrix norms are Frobenius (Eigen .norm()).
"""

from __future__ import annotations

from typing import Sequence

import jax.numpy as jnp

from sphinxsys_jax.core.state import State
from sphinxsys_jax.neighbors.neighbor_list import NeighborList, gather
from sphinxsys_jax.physics.pair import pair_geometry

TINY = 1.0e-15


def contact_fraction(rho0_self: float, rho0_other: float) -> float:
    """rho0_i / (rho0_i + rho0_k) — surface_tension.cpp:24-26."""
    return rho0_self / (rho0_self + rho0_other)


def surface_tension_stress(fluid: State, contacts: Sequence[tuple], kernel,
                           dim: int, coeff: float, box=None) -> State:
    """SurfaceTensionStress::interaction (surface_tension.cpp:29-52).

    contacts: [(other_state, nl_contact, fraction_k)] with fraction_k =
    contact_fraction(rho0_self, rho0_other).  Registers ColorGradient,
    NormDirection and SurfaceTensionStress ((N, dim, dim)) on the state.
    """
    pos = fluid["Position"]
    n = pos.shape[0]
    dtype = pos.dtype
    eye = jnp.eye(dim, dtype=dtype)
    cg = jnp.zeros((n, dim), dtype)
    norm_dir = jnp.zeros((n, dim), dtype)
    stress = jnp.zeros((n, dim, dim), dtype)
    for other, nl, frac_k in contacts:
        pg = pair_geometry(pos, other["Position"], nl, kernel, dim,
                           need_W=False, box=box)
        vol_j, _ = gather(other["VolumetricMeasure"], nl.idx)
        cg_k = -jnp.sum((2.0 * frac_k * pg.dW * vol_j)[..., None] * pg.e,
                        axis=1)
        cg = cg_k                                   # overwrite (per ref)
        norm_dir = cg_k / (jnp.linalg.norm(cg_k, axis=-1, keepdims=True)
                           + TINY)
        tangent = eye - norm_dir[:, :, None] * norm_dir[:, None, :]
        stress = stress + coeff * tangent * jnp.linalg.norm(
            cg_k, axis=-1)[:, None, None]
    out = dict(fluid)
    out["ColorGradient"] = cg
    out["NormDirection"] = norm_dir
    out["SurfaceTensionStress"] = stress
    return out


def _mismatch(cg_avg, e, r, identity_part):
    """M = (cg_avg (x) e_ij) * r_ij;  identity_part - M M / (|M|_F + eps).

    surface_tension.cpp:67-69 (inner, identity_part=0) and :111-112
    (contact, identity_part=I)."""
    M = cg_avg[..., :, None] * e[..., None, :] * r[..., None, None]
    MM = jnp.einsum("...ij,...jk->...ik", M, M)
    frob = jnp.sqrt(jnp.sum(M * M, axis=(-2, -1)) + TINY)
    return identity_part - MM / (frob[..., None, None] + TINY)


def surface_stress_force(fluid: State, nl_inner: NeighborList,
                         contacts: Sequence[tuple], kernel, dim: int,
                         coeff: float, hourglass_coeff: float = 4.5,
                         box=None) -> State:
    """SurfaceStressForceComplex = SurfaceStressForce<Inner<>, Contact<>>
    (surface_tension.cpp:55-124), accumulated into ForcePrior.

    Inner:   F_i = m_i/rho_i sum_j dW V_j (S_i + S_j + HG_ij) e_ij with the
             hourglass penalty HG_ij = k sigma (T_i+T_j)/2 mismatch /(r+eps),
             mismatch = -M M/|M| from the averaged color gradient.
    Contact: F_i += m_i/rho_i sum_j dW V_j (2(1-f) S_i + 2 f S_j + HG^c) e_ij,
             HG^c = -4 f (1-f) k sigma (n_i n_i^T + n_j n_j^T)/2 mismatch^c /r,
             mismatch^c = I - M M/|M|.
    """
    pos = fluid["Position"]
    dtype = pos.dtype
    eye = jnp.eye(dim, dtype=dtype)
    cg_i = fluid["ColorGradient"]
    nd_i = fluid["NormDirection"]
    S_i = fluid["SurfaceTensionStress"]
    mass = fluid["Mass"]
    vol = fluid["VolumetricMeasure"]
    rho = fluid["Density"]
    tangent_i = eye - nd_i[:, :, None] * nd_i[:, None, :]

    # --- inner (same phase) ---
    pg = pair_geometry(pos, pos, nl_inner, kernel, dim, need_W=False, box=box)
    cg_j, _ = gather(cg_i, nl_inner.idx)
    nd_j, _ = gather(nd_i, nl_inner.idx)
    S_j, _ = gather(S_i, nl_inner.idx)
    vol_j, _ = gather(vol, nl_inner.idx)
    tangent_j = eye - nd_j[..., :, None] * nd_j[..., None, :]
    cg_avg = 0.5 * (cg_i[:, None, :] + cg_j)
    mism = _mismatch(cg_avg, pg.e, pg.r, 0.0)
    hg = (hourglass_coeff * coeff * 0.5
          * jnp.einsum("...ij,...jk->...ik",
                       tangent_i[:, None] + tangent_j, mism)
          / (pg.r[..., None, None] + TINY))
    S_sum = S_i[:, None] + S_j + hg
    force = jnp.sum((pg.dW * vol_j)[..., None]
                    * jnp.einsum("...ij,...j->...i", S_sum, pg.e), axis=1)

    # --- other-phase contacts ---
    for other, nl, frac_k in contacts:
        pgc = pair_geometry(pos, other["Position"], nl, kernel, dim,
                            need_W=False, box=box)
        cg_jk, _ = gather(other["ColorGradient"], nl.idx)
        nd_jk, _ = gather(other["NormDirection"], nl.idx)
        S_jk, _ = gather(other["SurfaceTensionStress"], nl.idx)
        vol_jk, _ = gather(other["VolumetricMeasure"], nl.idx)
        cg_avg_c = 0.5 * (cg_i[:, None, :] + cg_jk)
        mism_c = _mismatch(cg_avg_c, pgc.e, pgc.r, eye)
        nn = 0.5 * (nd_i[:, None, :, None] * nd_i[:, None, None, :]
                    + nd_jk[..., :, None] * nd_jk[..., None, :])
        hg_c = (-4.0 * frac_k * (1.0 - frac_k) * hourglass_coeff * coeff
                * jnp.einsum("...ij,...jk->...ik", nn, mism_c)
                / (pgc.r[..., None, None] + TINY))
        S_c = (2.0 * (1.0 - frac_k) * S_i[:, None]
               + 2.0 * frac_k * S_jk + hg_c)
        force = force + jnp.sum(
            (pgc.dW * vol_jk)[..., None]
            * jnp.einsum("...ij,...j->...i", S_c, pgc.e), axis=1)

    force = mass[:, None] * force / (rho[:, None] + TINY)
    out = dict(fluid)
    prev = fluid.get("SurfaceTensionForcePrev", jnp.zeros_like(force))
    out["SurfaceTensionForce"] = force
    out["ForcePrior"] = fluid["ForcePrior"] + force - prev
    out["SurfaceTensionForcePrev"] = force
    return out


def surface_tension_time_step(fluid: State, eos, h_min: float, rho0: float,
                              coeff: float, cfl: float = 0.6):
    """SurfaceTensionTimeStep (fluid_time_step.cpp:33-42): the acoustic
    signal speed is floored by the capillary wave speed
    sqrt(2 pi sigma / (rho0 h))."""
    c = eos.sound_speed(fluid["Pressure"], fluid["Density"])
    speed = jnp.linalg.norm(fluid["Velocity"], axis=-1)
    n = fluid["Position"].shape[0]
    valid = jnp.arange(n) < fluid["NReal"]
    reduced = jnp.max(jnp.where(valid, c + speed, 0.0))
    cap = jnp.sqrt(2.0 * jnp.pi * coeff / (rho0 * h_min)).astype(reduced.dtype)
    return cfl * h_min / (jnp.maximum(reduced, cap) + TINY)
