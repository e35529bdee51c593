"""Pairwise geometry for interaction ops.

The XLA analog of the reference CK `Neighbor<>::SmoothingKernel`
(/root/reference/src/shared/shared_ck/body_relation/neighbor_method.h:53-116):
kernel values W_ij, dW_ij and the unit vector e_ij are recomputed from the
current positions at every use — the fixed-capacity neighbor index tensor
stays valid across acoustic sub-steps while positions move (same discipline
as the reference, which rebuilds lists once per advection step only).

Conventions (match the reference, particle_neighborhood/neighborhood.h):
    disp = pos_i - pos_j,  e_ij = disp / r_ij   (points from j toward i)
    dW_ij = dW/dr < 0; the kernel gradient is grad_i W = dW_ij * e_ij.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from sphinxsys_jax.neighbors.neighbor_list import NeighborList, gather

TINY = 1.0e-15


class PairGeometry(NamedTuple):
    """Per-(i, slot) pair quantities, shape (Nq, K) / (Nq, K, dim)."""

    r: jnp.ndarray      # |pos_i - pos_j|
    e: jnp.ndarray      # unit vector j -> i
    W: jnp.ndarray      # kernel value, 0 for masked slots
    dW: jnp.ndarray     # radial kernel derivative, 0 for masked slots
    mask: jnp.ndarray   # (Nq, K) bool


def min_image(disp, box):
    """Minimum-image displacement for periodic axes.  `box` is the tuple of
    per-axis periodic lengths (0 = not periodic), e.g.
    grid.periodic_lengths."""
    L = jnp.asarray(box, dtype=disp.dtype)
    safe_L = jnp.where(L > 0, L, 1.0)
    return jnp.where(L > 0, disp - L * jnp.round(disp / safe_L), disp)


def pair_geometry(pos_q, pos_s, nl: NeighborList, kernel, dim: int,
                  need_W: bool = True, need_dW: bool = True,
                  box=None) -> PairGeometry:
    pos_j, mask = gather(pos_s, nl.idx)
    disp = pos_q[:, None, :] - pos_j
    if box is not None and any(b > 0 for b in box):
        disp = min_image(disp, box)
    r2 = jnp.sum(disp * disp, axis=-1)
    r = jnp.sqrt(r2 + TINY)
    e = disp / (r[..., None] + TINY)
    fmask = mask.astype(pos_q.dtype)
    W = kernel.W(r, dim) * fmask if need_W else None
    dW = kernel.dW(r, dim) * fmask if need_dW else None
    return PairGeometry(r=r, e=e, W=W, dW=dW, mask=mask)


def psum(x, mask=None):
    """Sum over the neighbor-slot axis (axis 1)."""
    return jnp.sum(x, axis=1)
