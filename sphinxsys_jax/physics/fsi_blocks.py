"""FSI force coupling against a BLOCK-layout fluid (the fast path).

Same physics as physics/fsi.py (reference fluid_structure_interaction.hpp)
with the fluid living in occupied-cell blocks (neighbors/cell_blocks.py):
each solid particle reads its 3^dim window of fluid blocks directly —
(n_solid, 3^dim, cap, ch) dense gathers instead of per-pair neighbor
lists.  Solid bodies are small relative to the fluid, so this stays cheap
even though it re-gathers per acoustic step (the reference recomputes the
same contact sums per step too, fsi2.cpp:228-231).
"""

from __future__ import annotations

import jax.numpy as jnp

from sphinxsys_jax.neighbors.cell_blocks import cross_neighbor_blocks
from sphinxsys_jax.physics.fluid_blocks import _min_image, pack_channels
from sphinxsys_jax.physics.fsi import force_prior_update

TINY = 1.0e-15


def solid_windows(solid_pos, grid, bm_fluid, fluid_dense_map):
    """(n_s, 3^dim) fluid block rows of each solid particle's cell window
    (sentinel = fluid c_max, the all-padding row).  Rebuild whenever the
    fluid re-slots (once per advection step)."""
    cid = grid.cell_id(solid_pos).astype(jnp.int32)
    return cross_neighbor_blocks(cid, grid, bm_fluid,
                                 src_dense_map=fluid_dense_map)


def _pair_geom_sf(solid_pos, pj_pos, mask_j, box):
    """(n_s, W, cap) pair geometry, e pointing solid -> fluid-neighbor
    displacement direction (i - j), matching pair_geometry."""
    disp = solid_pos[:, None, None, :] - pj_pos
    disp = _min_image(disp, box)
    r2 = jnp.sum(disp * disp, axis=-1)
    r = jnp.sqrt(r2 + TINY)
    e = disp / (r[..., None] + TINY)
    return r, e, mask_j


def viscous_force_from_fluid_b(solid: dict, fluid_b: dict, windows, kernel,
                               dim: int, mu: float, smoothing_length: float,
                               box=None) -> dict:
    """Block twin of fsi.viscous_force_from_fluid
    (fluid_structure_interaction.cpp): F_i = V_i sum_j 2 mu * 2
    (v_ave_i - v_j)/(r + 0.01 h) dW V_j."""
    packed = pack_channels(fluid_b["Position"], fluid_b["Velocity"],
                           fluid_b["VolumetricMeasure"])
    pj = packed[windows]                       # (n_s, W, cap, 5)
    mask = fluid_b["SlotMask"][windows]
    r, e, m = _pair_geom_sf(solid["Position"], pj[..., :dim], mask, box)
    dWV = kernel.dW(r, dim) * m.astype(r.dtype) * pj[..., 2 * dim]
    vel_j = pj[..., dim:2 * dim]
    vderiv = 2.0 * (solid["AverageVelocity"][:, None, None, :] - vel_j) \
        / (r + 0.01 * smoothing_length)[..., None]
    force = 2.0 * mu * jnp.sum(vderiv * dWV[..., None], axis=(1, 2))
    force = force * solid["VolumetricMeasure"][:, None]
    return force_prior_update(solid, "ViscousForceFromFluid", force)


def pressure_force_from_fluid_b(solid: dict, fluid_b: dict, windows, kernel,
                                dim: int, riemann, box=None) -> dict:
    """Block twin of fsi.pressure_force_from_fluid
    (fluid_structure_interaction.hpp:31-60): wall-contact pressure +
    dissipation terms mirrored onto the solid, fluid read from blocks."""
    packed = pack_channels(fluid_b["Position"], fluid_b["Pressure"],
                           fluid_b["Density"], fluid_b["Mass"],
                           fluid_b["Velocity"], fluid_b["VolumetricMeasure"],
                           fluid_b["ForcePrior"])
    pj = packed[windows]                       # (n_s, W, cap, 10)
    mask = fluid_b["SlotMask"][windows]
    r, e, m = _pair_geom_sf(solid["Position"], pj[..., :dim], mask, box)
    p_j = pj[..., dim]
    rho_j = pj[..., dim + 1]
    mass_j = pj[..., dim + 2]
    vel_j = pj[..., dim + 3:2 * dim + 3]
    vol_j = pj[..., 2 * dim + 3]
    fp_j = pj[..., 2 * dim + 4:3 * dim + 4]

    acc_ave = solid["AverageAcceleration"][:, None, None, :]
    vel_ave = solid["AverageVelocity"][:, None, None, :]
    n_i = solid["NormalDirection"][:, None, None, :]

    face_acc = jnp.sum((fp_j / jnp.maximum(mass_j, TINY)[..., None]
                        - acc_ave) * e, axis=-1)
    p_in_wall = p_j + rho_j * r * jnp.maximum(face_acc, 0.0)
    e_dot_n = jnp.sum(e * n_i, axis=-1)
    face_to_fluid_n = -jnp.sign(e_dot_n)[..., None] * n_i
    u_jump = 2.0 * jnp.sum((vel_j - vel_ave) * face_to_fluid_n, axis=-1)
    term = (riemann.dissipative_p_jump(u_jump)[..., None] * face_to_fluid_n
            + (p_in_wall + p_j)[..., None] * e)
    dWV = kernel.dW(r, dim) * m.astype(r.dtype) * vol_j
    force = -jnp.sum(term * dWV[..., None], axis=(1, 2))
    force = force * solid["VolumetricMeasure"][:, None]
    return force_prior_update(solid, "PressureForceFromFluid", force)
