"""Solid <-> shell tie coupling (Shepard-weight kinematic/force mappings).

Counterpart of /root/reference/src/shared/particle_dynamics/solid_dynamics/
solid_to_shell_coupling.{h,hpp} (TotalWeightComputation, ConsistentMapping,
ConservativeMapping): a volumetric solid body tied to a shell mid-surface
exchanges kinematics and forces through FROZEN cross-body contact pairs.

  * TotalWeight: tw_i = sum_j W_ij Vol_j over the contact body — the Shepard
    denominator, computed ONCE from the initial configuration (the reference
    never calls updateConfiguration on the coupling contact relations — the
    tie is total-Lagrangian).
  * ConsistentMapping (kinematics, shell <- solid): where tw_i > tiny,
    field_i = sum_j W_ij Vol_j field_j / tw_i.
  * ConservativeMapping (force, solid <- shell): field_i = sum_j W_ij Vol_i
    / tw_j field_j — each shell force unit is distributed over the solid
    particles in proportion to their weight share, so the total transferred
    force equals the total tied shell force (Newton's third law in the
    Shepard sense).

Frozen pairs are (idx, W, vol, tw) tensors; the reference's per-neighborhood
while loops become masked dense reductions.  The contact search runs at the
MAX smoothing length of the two bodies (MaxSmoothingLengthContactRelation,
contact_body_relation.h:132-150) — pass that cutoff to `freeze_coupling`.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from sphinxsys_jax.neighbors.neighbor_list import NeighborList, gather
from sphinxsys_jax.physics.pair import pair_geometry

TINY = 1.0e-15


class CouplingPairs(NamedTuple):
    """Frozen tie-contact pairs from body A's particles to body B's."""

    idx: jnp.ndarray       # (Na, K) neighbor row in body B
    W: jnp.ndarray         # (Na, K) kernel value at the tie configuration
    mask: jnp.ndarray      # (Na, K) slot validity (1.0 / 0.0)
    vol_j: jnp.ndarray     # (Na, K) body-B volumetric measure
    total_weight: jnp.ndarray  # (Na,) sum_j W_ij Vol_j


def freeze_coupling(pos_a, pos_b, vol_b, nl: NeighborList, kernel,
                    dim: int) -> CouplingPairs:
    """Build the frozen coupling pairs for body A against body B from a
    cross-body NeighborList (built at max-h cutoff) and compute TotalWeight
    (solid_to_shell_coupling.hpp TotalWeightComputation::update)."""
    pg = pair_geometry(pos_a, pos_b, nl, kernel, dim, need_dW=False)
    vol_j, _ = gather(vol_b, nl.idx)
    fmask = pg.mask.astype(pos_a.dtype)
    W = pg.W * fmask
    tw = jnp.sum(W * vol_j, axis=1)
    return CouplingPairs(idx=nl.idx, W=W, mask=fmask, vol_j=vol_j,
                         total_weight=tw)


def consistent_mapping(cp: CouplingPairs, data_b, current, part_mask=None):
    """ConsistentMapping::update: interpolate `data_b` (body-B per-particle
    values, e.g. Velocity) onto body A where the tie has support; particles
    with tw < tiny (or outside `part_mask`) keep `current`."""
    data_j, _ = gather(data_b, cp.idx)
    w = cp.W * cp.vol_j
    if data_j.ndim == 3:
        num = jnp.sum(w[..., None] * data_j, axis=1)
    else:
        num = jnp.sum(w * data_j, axis=1)
    tied = cp.total_weight > TINY
    if part_mask is not None:
        tied = tied & part_mask
    out = num / (cp.total_weight + TINY)[..., None] if data_j.ndim == 3 \
        else num / (cp.total_weight + TINY)
    sel = tied[..., None] if data_j.ndim == 3 else tied
    return jnp.where(sel, out, current)


def conservative_mapping(cp: CouplingPairs, vol_a, tw_b, data_b):
    """ConservativeMapping::update: distribute body-B per-particle values
    (e.g. Force) onto body A conserving the total: each pair contributes
    W_ij Vol_a_i / tw_b_j * data_b_j; pairs whose source has no tie support
    (tw_b_j < tiny) contribute nothing."""
    data_j, _ = gather(data_b, cp.idx)
    tw_j, _ = gather(tw_b, cp.idx)
    share = jnp.where(tw_j > TINY,
                      cp.W * vol_a[:, None] / (tw_j + TINY), 0.0)
    if data_j.ndim == 3:
        return jnp.sum(share[..., None] * data_j, axis=1)
    return jnp.sum(share * data_j, axis=1)
