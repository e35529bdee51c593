"""Surface-contact machinery: solid<->solid, solid<->shell, shell<->shell
dynamic contact and shell SELF contact.

Counterpart of the reference's SurfaceContactRelation /
ShellSelfContactRelation stack:
  * builders: NeighborBuilderSurfaceContactFromSolid (pair kernel with the
    AVERAGED smoothing length h = (h_a + h_b)/2, W offset-reduced by
    W(dp_avg) — neighborhood.cpp:486-529), NeighborBuilderSurfaceContact-
    FromShell (same averaged kernel + the curvature-corrected dummy-
    particle stack along the shell normal — neighborhood.cpp:255-310,478-
    484), NeighborBuilderShellSelfContact (UNreduced own kernel, pairs far
    in the INITIAL configuration only, per-pair sign-corrected normals —
    neighborhood.cpp:403-476);
  * RepulsionFactorSummation<Contact<>> sigma_i = sum W_ij ParticleVolume_j
    (repulsion_factor_summation.cpp:35-49; SurfaceParticles::ParticleVolume
    = area * thickness, surface_particles.h:52);
  * RepulsionForce<Contact<>> f_i = ParticleVolume_i sum_k K_ave_k
    sum_j -2 sigma* e_ij dW_ij V_j with sigma* = (sigma_i + sigma_j)/2 and
    the harmonic contact stiffness (contact_repulsion.cpp:34-75);
  * RepulsionForce<Contact<Inner<>>> (self contact) adds the acoustic
    impedance damping 0.5 sqrt(rho K) (v_i - v_j).(-e)
    (contact_repulsion.cpp:9-32).

XLA shape: pair quantities are dense masked (N, K) tensors built from the
fixed-capacity neighbor lists; the dummy-particle while-loop is the same
fori_loop stack as physics/shell_fluid.py (provably equal: dummy distance
is convex in the step index, volume factors monotone).  All "builders"
return a SurfacePairs with the volume measures FOLDED IN, so the factor
and force reductions are body-type agnostic.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from sphinxsys_jax.core.kernels import WendlandC2
from sphinxsys_jax.core.state import State
from sphinxsys_jax.neighbors.neighbor_list import NeighborList, gather
from sphinxsys_jax.physics.pair import pair_geometry
from sphinxsys_jax.physics.shell_fluid import n_dummy_static

TINY = 1.0e-15


class SurfacePairs(NamedTuple):
    """Per-(i, slot) surface-contact quantities with volumes folded in:
    sigma contribution = Wv; force term = -2 sigma* e dWV."""

    Wv: jnp.ndarray     # W_ij * ParticleVolume_j  (offset/dummy corrected)
    dWV: jnp.ndarray    # dW_ij * V_j (shell: corrected dWV * area_j)
    e: jnp.ndarray      # unit vector j -> i (shell: dummy-stack weighted)
    mask: jnp.ndarray
    idx: jnp.ndarray    # neighbor indices (for gathering sigma_j)


def surface_kernel(h_a: float, h_b: float) -> WendlandC2:
    """The averaged-smoothing-length contact kernel
    (NeighborBuilderSurfaceContact, neighborhood.cpp:162-168)."""
    return WendlandC2(h=0.5 * (h_a + h_b))


def solid_surface_pairs(pos_q, target: State, nl: NeighborList, kernel,
                        dim: int, dp_q: float, dp_target: float,
                        box=None) -> SurfacePairs:
    """NeighborBuilderSurfaceContactFromSolid: W reduced by the rest-
    separation offset W(dp_avg) so the factor vanishes at resting touch."""
    pg = pair_geometry(pos_q, target["Position"], nl, kernel, dim, box=box)
    vol_j, _ = gather(target["VolumetricMeasure"], nl.idx)
    dtype = pos_q.dtype
    with jax.ensure_compile_time_eval():
        offset = kernel.W(jnp.asarray(0.5 * (dp_q + dp_target), dtype), dim)
    W_red = jnp.maximum(pg.W - offset, 0.0) * pg.mask
    return SurfacePairs(Wv=W_red * vol_j, dWV=pg.dW * vol_j, e=pg.e,
                        mask=pg.mask, idx=nl.idx)


def _dummy_stack(pos_q, pos_j, n_j, k1_j, k2_j, base_W, base_dW, base_e,
                 fmask, kernel, dim: int, shell_spacing: float):
    """The corrected (W, dW, e) totals of the normal-ray dummy stack
    (BaseNeighborBuilderContactFromShell::update_neighbors)."""
    d = shell_spacing
    cutoff = kernel.cutoff
    n_dum = n_dummy_static(kernel, shell_spacing)

    def add_dummy(k, carry):
        W_t, dW_t, dWe_t = carry
        kf = k.astype(base_W.dtype)
        pos_dum = pos_j + n_j * (kf * d)
        disp = pos_q[:, None, :] - pos_dum
        r_dum = jnp.sqrt(jnp.sum(disp * disp, axis=-1) + TINY)
        f1 = 1.0 + kf * k1_j * d
        f2 = 1.0 + kf * k2_j * d
        ok = (r_dum < cutoff) & (f1 > 0.0) & (f2 > 0.0)
        vol_f = jnp.where(ok, f1 * f2, 0.0) * fmask
        Wd = kernel.W(r_dum, dim) * vol_f
        dWd = kernel.dW(r_dum, dim) * vol_f
        return (W_t + Wd, dW_t + dWd,
                dWe_t + dWd[..., None] * (disp / r_dum[..., None]))

    return jax.lax.fori_loop(1, n_dum + 1, add_dummy,
                             (base_W, base_dW, base_dW[..., None] * base_e))


def shell_surface_pairs(pos_q, shell: State, k1_ave, k2_ave,
                        nl: NeighborList, kernel, dim: int,
                        shell_spacing: float,
                        normal_correction: bool = False,
                        box=None) -> SurfacePairs:
    """NeighborBuilderSurfaceContactFromShell: the shell seen as a volume
    through its dummy stack; W scaled from area to volume by
    d/thickness then multiplied by ParticleVolume = area * thickness
    (the thickness cancels: Wv = W_ttl d area_j)."""
    pg = pair_geometry(pos_q, shell["Position"], nl, kernel, dim, box=box)
    corr = -1.0 if normal_correction else 1.0
    n_j, _ = gather(shell["NormalDirection"], nl.idx)
    k1_j, _ = gather(k1_ave, nl.idx)
    k2_j, _ = gather(k2_ave, nl.idx)
    pos_j, _ = gather(shell["Position"], nl.idx)
    area_j, _ = gather(shell["VolumetricMeasure"], nl.idx)
    fmask = pg.mask.astype(pg.r.dtype)

    W_ttl, dW_ttl, dW_e_ttl = _dummy_stack(
        pos_q, pos_j, corr * n_j, corr * k1_j, corr * k2_j,
        pg.W, pg.dW, pg.e, fmask, kernel, dim, shell_spacing)
    e_corr = dW_e_ttl / (dW_ttl[..., None] - TINY)
    return SurfacePairs(Wv=W_ttl * shell_spacing * area_j,
                        dWV=dW_ttl * shell_spacing * area_j,
                        e=e_corr, mask=pg.mask, idx=nl.idx)


def shell_self_pairs(shell: State, k1, k2, nl: NeighborList, kernel,
                     dim: int, shell_spacing: float,
                     box=None) -> SurfacePairs:
    """NeighborBuilderShellSelfContact: UNreduced own-h kernel; only pairs
    FAR in the initial configuration (|r0| > cutoff) contact; the
    neighbor's normal is sign-corrected per pair to point from i toward j
    (so the dummy stack grows AWAY from i).  Pass the shell's OWN
    curvatures (1st/2ndPrincipleCurvature), not the averaged ones."""
    pos = shell["Position"]
    pg = pair_geometry(pos, pos, nl, kernel, dim, box=box)
    pos0 = shell["InitialPosition"]
    pos0_j, _ = gather(pos0, nl.idx)
    r0 = jnp.linalg.norm(pos0[:, None, :] - pos0_j, axis=-1)
    far0 = r0 > kernel.cutoff
    mask = pg.mask & far0
    fmask = mask.astype(pg.r.dtype)

    n_j, _ = gather(shell["NormalDirection"], nl.idx)
    # direction_corrector = -sgn(disp . n_j): dummies extend away from i
    corr = -jnp.sign(jnp.sum(pg.e * n_j, axis=-1))[..., None]
    k1_j, _ = gather(k1, nl.idx)
    k2_j, _ = gather(k2, nl.idx)
    pos_j, _ = gather(pos, nl.idx)
    area_j, _ = gather(shell["VolumetricMeasure"], nl.idx)

    W_ttl, dW_ttl, dW_e_ttl = _dummy_stack(
        pos, pos_j, corr * n_j, corr[..., 0] * k1_j, corr[..., 0] * k2_j,
        pg.W * fmask, pg.dW * fmask, pg.e, fmask, kernel, dim, shell_spacing)
    e_corr = dW_e_ttl / (dW_ttl[..., None] - TINY)
    thick_j, _ = gather(shell["Thickness"], nl.idx)
    return SurfacePairs(Wv=W_ttl * shell_spacing * area_j,
                        dWV=dW_ttl * shell_spacing * area_j,
                        e=e_corr, mask=mask, idx=nl.idx)


# ---------------------------------------------------------------------------
# factor + force reductions (body-type agnostic over SurfacePairs)
# ---------------------------------------------------------------------------

def repulsion_factor(pairs_list) -> jnp.ndarray:
    """RepulsionFactorSummation<Contact<>>: sigma_i = sum over all contact
    bodies of W_ij ParticleVolume_j."""
    sigma = None
    for pairs in pairs_list:
        s = jnp.sum(pairs.Wv, axis=1)
        sigma = s if sigma is None else sigma + s
    return sigma


def repulsion_force(state: State, sigma, contacts,
                    particle_volume=None) -> jnp.ndarray:
    """RepulsionForce<Contact<>>: contacts = (pairs, sigma_other, K_ave)
    triples; returns the force array (fold into ForcePrior via the caller's
    force-prior discipline).  `particle_volume`: ParticleVolume_i array
    (defaults to VolumetricMeasure; pass area*thickness for shells)."""
    v_i = (state["VolumetricMeasure"] if particle_volume is None
           else particle_volume)
    force = jnp.zeros_like(state["Position"])
    for pairs, sigma_other, k_ave in contacts:
        sig_j, _ = gather(sigma_other, pairs.idx)
        sig_star = 0.5 * (sigma[:, None] + sig_j)
        f_k = -2.0 * jnp.sum((sig_star * pairs.dWV)[..., None] * pairs.e,
                             axis=1)
        force = force + k_ave * f_k
    return force * v_i[:, None]


def self_repulsion_force(shell: State, sigma_self, pairs: SurfacePairs,
                         contact_stiffness: float, rho0: float,
                         particle_volume) -> jnp.ndarray:
    """RepulsionForce<Contact<Inner<>>> (contact_repulsion.cpp:9-32) on the
    shell self-contact pairs: pressure-like 2(p* + impedance) term with
    p = sigma K and the acoustic impedance sqrt(rho K)."""
    impedance = (rho0 * contact_stiffness) ** 0.5
    p = sigma_self * contact_stiffness
    p_j, _ = gather(p, pairs.idx)
    p_star = 0.5 * (p[:, None] + p_j)
    vel_j, _ = gather(shell["Velocity"], pairs.idx)
    dv = shell["Velocity"][:, None, :] - vel_j
    imp_p = 0.5 * impedance * jnp.sum(dv * (-pairs.e), axis=-1)
    f = -2.0 * jnp.sum(((p_star + imp_p) * pairs.dWV)[..., None] * pairs.e,
                       axis=1)
    return f * particle_volume[:, None]
