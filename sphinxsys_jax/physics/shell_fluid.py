"""Shell <-> fluid coupling: curvature-corrected dummy-particle contacts.

A shell is a single layer of surface particles, but the fluid needs the
kernel support of a SOLID wall behind it.  The reference fills the gap
with a stack of DUMMY particles along the shell normal whose volumes
grow/shrink with the shell's principal curvatures, folded into corrected
per-pair kernel quantities at neighbor-build time
(/root/reference/src/shared/particle_neighborhood/neighborhood.cpp:
BaseNeighborBuilderContactFromShell::update_neighbors:259-317 and
NeighborBuilderContactFromFluidToShell:335-395; curvature:
thin_structure_dynamics.cpp AverageShellCurvature).

Here the same corrections are dense (N, K) tensors computed ONCE per
advection step (the reference also builds them once per configuration
update) and passed frozen into the acoustic sub-steps:

  W_corr   = [W(r)   + sum_k W(d_k) f_k] * spacing / thickness_j
  dWV_corr = [dW(r)  + sum_k dW(d_k) f_k] * spacing
  e_corr   = [dW(r) e + sum_k dW(d_k) f_k e_k] / [dW(r) + sum_k dW(d_k) f_k]
  f_k      = (1 + k k1 D)(1 + k k2 D),  dummy k at pos_j + k D n_j

The reference's while-loop breaks (distance >= cutoff; factor <= 0) are
replicated exactly by masks: the dummy distance along a ray is convex in
k, so it crosses the cutoff upward once, and the volume factors are
monotone in k, so both break conditions equal their pointwise masks.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp

from sphinxsys_jax.core.state import State
from sphinxsys_jax.neighbors.neighbor_list import NeighborList, gather
from sphinxsys_jax.physics.pair import pair_geometry

TINY = 1.0e-15


class ShellContactPairs(NamedTuple):
    """Frozen corrected pair quantities of a fluid->shell (or solid->shell)
    contact, shapes (N, K) / (N, K, dim)."""

    r: jnp.ndarray       # true distance to the shell particle
    e: jnp.ndarray       # CORRECTED unit vector (dummy-stack weighted)
    W: jnp.ndarray       # corrected W_ij (area -> volume scaled)
    dWV: jnp.ndarray     # corrected dW (volume-factor + spacing folded in);
                         # multiply by the shell AREA measure for dW V_j
    n: jnp.ndarray       # direction-corrected shell normal (fluid -> shell)
    mask: jnp.ndarray


def shell_curvature(shell: State, nl_inner: NeighborList, kernel, dim: int,
                    normal_key: str = "NormalDirection"):
    """AverageShellCurvature (thin_structure_dynamics.cpp): principal
    curvatures from the normal-gradient tensor dn = -sum (n_i - n_j) x
    (dW V_j e_ij) over shell inner neighbors built with the CONTACT body's
    kernel (reduced once — pass the fluid kernel wrapped in
    shell.ReducedKernel).  Returns (k1, k2) per shell particle."""
    n = shell[normal_key]
    pos = shell["Position"]
    pg = pair_geometry(pos, pos, nl_inner, kernel, dim, need_W=False)
    n_j, _ = gather(n, nl_inner.idx)
    vol_j, _ = gather(shell["VolumetricMeasure"], nl_inner.idx)
    gradw = (pg.dW * vol_j)[..., None] * pg.e           # (N, K, d)
    dn = -jnp.sum((n[:, None, :] - n_j)[..., :, None]
                  * gradw[..., None, :], axis=1)        # (N, d, d)
    if dim == 2:
        k1 = dn[:, 0, 0] + dn[:, 1, 1]
        return k1, jnp.zeros_like(k1)
    tr = dn[:, 0, 0] + dn[:, 1, 1] + dn[:, 2, 2]
    H = 0.5 * tr
    K = (dn[:, 0, 0] * dn[:, 1, 1] + dn[:, 0, 0] * dn[:, 2, 2]
         + dn[:, 1, 1] * dn[:, 2, 2] - dn[:, 0, 1] * dn[:, 1, 0]
         - dn[:, 0, 2] * dn[:, 2, 0] - dn[:, 1, 2] * dn[:, 2, 1])
    root = jnp.maximum(H * H - K, 0.0)
    s = jnp.sqrt(root)
    return H + s, H - s


def n_dummy_static(kernel, shell_spacing: float) -> int:
    """Static unroll length covering every dummy the reference while-loop
    can visit: the dummy distance stays under the cutoff for at most
    ~2 cutoff / spacing steps along the normal ray."""
    return int(2.0 * kernel.cutoff / shell_spacing) + 2


def shell_contact_pairs(pos_q, shell: State, k1, k2, nl: NeighborList,
                        kernel, dim: int, shell_spacing: float,
                        normal_correction: bool = False,
                        box=None) -> ShellContactPairs:
    """Corrected pair quantities for a fluid (or solid) body seeing a shell
    as a wall-type contact (NeighborBuilderContactFromShellToFluid).
    `normal_correction=True` when the stored shell normals point from the
    shell TOWARD this body (they must point away from it)."""
    corr = -1.0 if normal_correction else 1.0
    pg = pair_geometry(pos_q, shell["Position"], nl, kernel, dim, box=box)
    n_j, _ = gather(shell["NormalDirection"], nl.idx)
    n_j = corr * n_j
    k1_j, _ = gather(k1, nl.idx)
    k2_j, _ = gather(k2, nl.idx)
    k1_j = corr * k1_j
    k2_j = corr * k2_j
    thick_j, _ = gather(shell["Thickness"], nl.idx)
    pos_j, _ = gather(shell["Position"], nl.idx)

    fmask = pg.mask.astype(pg.r.dtype)
    d = shell_spacing
    cutoff = kernel.cutoff
    n_dum = n_dummy_static(kernel, shell_spacing)

    def add_dummy(k, carry):
        # k traced -> ONE trace of the stack body regardless of n_dum
        # (a Python unroll at n_dum ~ 12 made the pipe case's XLA graph
        # minutes-slow to compile)
        W_t, dW_t, dWe_t = carry
        kf = k.astype(pg.r.dtype)
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

    W_ttl, dW_ttl, dW_e_ttl = jax.lax.fori_loop(
        1, n_dum + 1, add_dummy,
        (pg.W, pg.dW, pg.dW[..., None] * pg.e))
    e_corr = dW_e_ttl / (dW_ttl[..., None] - TINY)   # dW < 0: no cancel
    W_corr = W_ttl * d / jnp.maximum(thick_j, TINY)
    dWV_corr = dW_ttl * d
    return ShellContactPairs(r=pg.r, e=e_corr, W=W_corr, dWV=dWV_corr,
                             n=n_j, mask=pg.mask)


def fluid_to_shell_pairs(shell: State, k1, k2, fluid_pos, nl: NeighborList,
                         kernel, dim: int, shell_spacing: float,
                         normal_correction: bool = False,
                         box=None) -> ShellContactPairs:
    """Corrected pair quantities for the SHELL feeling the fluid
    (NeighborBuilderContactFromFluidToShell): dummies stack along the
    shell's OWN normal at particle i; W is left uncorrected (unused by
    the pressure force)."""
    corr = -1.0 if normal_correction else 1.0
    pos_i = shell["Position"]
    pg = pair_geometry(pos_i, fluid_pos, nl, kernel, dim, box=box)
    n_i = corr * shell["NormalDirection"]
    k1_i = (corr * k1)[:, None]
    k2_i = (corr * k2)[:, None]
    pos_j, _ = gather(fluid_pos, nl.idx)

    fmask = pg.mask.astype(pg.r.dtype)
    d = shell_spacing
    cutoff = kernel.cutoff
    n_dum = n_dummy_static(kernel, shell_spacing)

    def add_dummy(k, carry):
        dW_t, dWe_t = carry
        kf = k.astype(pg.r.dtype)
        pos_dum = pos_i[:, None, :] + n_i[:, None, :] * (kf * d)
        disp = pos_dum - pos_j
        r_dum = jnp.sqrt(jnp.sum(disp * disp, axis=-1) + TINY)
        f1 = 1.0 + kf * k1_i * d
        f2 = 1.0 + kf * k2_i * d
        ok = (r_dum < cutoff) & (f1 > 0.0) & (f2 > 0.0)
        vol_f = jnp.where(ok, f1 * f2, 0.0) * fmask
        dWd = kernel.dW(r_dum, dim) * vol_f
        return (dW_t + dWd,
                dWe_t + dWd[..., None] * (disp / r_dum[..., None]))

    dW_ttl, dW_e_ttl = jax.lax.fori_loop(
        1, n_dum + 1, add_dummy, (pg.dW, pg.dW[..., None] * pg.e))
    e_corr = dW_e_ttl / (dW_ttl[..., None] - TINY)
    dWV_corr = dW_ttl * d
    return ShellContactPairs(r=pg.r, e=e_corr, W=pg.W, dWV=dWV_corr,
                             n=shell["NormalDirection"], mask=pg.mask)


# ---------------------------------------------------------------------------
# fluid-side contact terms (frozen corrected pairs)
# ---------------------------------------------------------------------------

def density_summation_shell_term(fluid: State, shell: State,
                                 pairs: ShellContactPairs, nl: NeighborList,
                                 rho0: float, sigma0: float, shell_rho0: float):
    """Contact contribution to rho_sum (density_summation.cpp Contact<>):
    sigma += W_corr m_k / rho0_k, added as sigma rho0^2 / sigma0 / m_i."""
    mass_k, _ = gather(shell["Mass"], nl.idx)
    sigma_c = jnp.sum(pairs.W * mass_k / shell_rho0, axis=1)
    return sigma_c * rho0 * rho0 / sigma0 / fluid["Mass"]


def acoustic_1st_half_shell_term(p, rho, fluid: State, shell: State,
                                 pairs: ShellContactPairs, nl: NeighborList,
                                 riemann):
    """Wall-contact pressure/density terms of the 1st half against a shell
    (fluid_integration.hpp:89-113 with the corrected neighborhood).
    Returns (force_without_Vol_i, rho_dissipation_rate)."""
    area_k, _ = gather(shell["VolumetricMeasure"], nl.idx)
    acc_ave_k, _ = gather(shell["AverageAcceleration"], nl.idx)
    dWV = pairs.dWV * area_k
    acc_prior = fluid["ForcePrior"] / fluid["Mass"][:, None]
    face_acc = jnp.sum((acc_prior[:, None, :] - acc_ave_k) * (-pairs.e),
                       axis=-1)
    p_in_wall = p[:, None] + rho[:, None] * pairs.r * jnp.maximum(face_acc, 0.0)
    force = -jnp.sum((p[:, None] + p_in_wall)[..., None] * dWV[..., None]
                     * pairs.e, axis=1)
    rho_diss = jnp.sum(riemann.dissipative_u_jump(p[:, None] - p_in_wall)
                       * dWV, axis=1)
    return force, rho_diss


def acoustic_2nd_half_shell_term(vel, fluid: State, shell: State,
                                 pairs: ShellContactPairs, nl: NeighborList,
                                 riemann):
    """Wall-contact terms of the 2nd half against a shell
    (fluid_integration.hpp:159-231).  Returns (p_dissipation_force_without
    _Vol_i, density_change_rate_contrib)."""
    area_k, _ = gather(shell["VolumetricMeasure"], nl.idx)
    vel_ave_k, _ = gather(shell["AverageVelocity"], nl.idx)
    # raw stored normals: face_n = sgn(e.n) n is invariant to the normal's
    # orientation, so no direction correction is needed here
    n_k, _ = gather(shell["NormalDirection"], nl.idx)
    dWV = pairs.dWV * area_k
    e_dot_n = jnp.sum(pairs.e * n_k, axis=-1)
    face_n = jnp.sign(e_dot_n)[..., None] * n_k
    dv = vel[:, None, :] - (2.0 * vel_ave_k - vel[:, None, :])
    dcr = jnp.sum(jnp.sum(dv * pairs.e, axis=-1) * dWV, axis=1)
    u_jump = 2.0 * jnp.sum((vel[:, None, :] - vel_ave_k) * face_n, axis=-1)
    force = jnp.sum((riemann.dissipative_p_jump(u_jump) * dWV)[..., None]
                    * face_n, axis=1)
    return force, dcr


def pressure_force_from_fluid_on_shell(shell: State, fluid: State,
                                       pairs: ShellContactPairs,
                                       nl: NeighborList, riemann) -> jnp.ndarray:
    """PressureForceFromFluid (fluid_structure_interaction.hpp:interaction)
    on shell particles through the fluid->shell corrected neighborhood;
    returns the force array (the caller folds it into ForcePrior via the
    force-prior update discipline)."""
    vol_k, _ = gather(fluid["VolumetricMeasure"], nl.idx)
    rho_k, _ = gather(fluid["Density"], nl.idx)
    mass_k, _ = gather(fluid["Mass"], nl.idx)
    p_k, _ = gather(fluid["Pressure"], nl.idx)
    vel_k, _ = gather(fluid["Velocity"], nl.idx)
    fprior_k, _ = gather(fluid["ForcePrior"], nl.idx)
    mask = pairs.mask.astype(p_k.dtype)

    acc_ave = shell["AverageAcceleration"]
    vel_ave = shell["AverageVelocity"]
    n_i = shell["NormalDirection"]

    face_acc = jnp.sum((fprior_k / jnp.maximum(mass_k, TINY)[..., None]
                        - acc_ave[:, None, :]) * pairs.e, axis=-1)
    p_in_wall = p_k + rho_k * pairs.r * jnp.maximum(face_acc, 0.0)
    e_dot_n = jnp.sum(pairs.e * n_i[:, None, :], axis=-1)
    face_to_fluid_n = -jnp.sign(e_dot_n)[..., None] * n_i[:, None, :]
    u_jump = 2.0 * jnp.sum((vel_k - vel_ave[:, None, :]) * face_to_fluid_n,
                           axis=-1)
    term = (riemann.dissipative_p_jump(u_jump)[..., None] * face_to_fluid_n
            + (p_in_wall + p_k)[..., None] * pairs.e)
    force = -jnp.sum(term * (pairs.dWV * vol_k * mask)[..., None], axis=1)
    return force * shell["VolumetricMeasure"][:, None]
