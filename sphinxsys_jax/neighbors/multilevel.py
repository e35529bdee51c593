"""Multi-level (adaptive smoothing length) neighbor engine.

Counterpart of the reference's MultilevelCellLinkedList + adaptive
neighborhood builders (meshes/cell_linked_list.h:169-219,
neighborhood.cpp:100-121, adaptations/adaptation.h:125):

  * particles carry SmoothingLengthRatio  h_ratio = h_ref / h_i  (>= 1
    for refined particles);
  * a pair (i, j) is a neighbor when  r < cutoff(min(h_ratio_i,
    h_ratio_j)) = kernel_size * max(h_i, h_j);
  * W_ij is evaluated at i's OWN h and zeroed beyond i's own cutoff
    (asymmetric, neighborhood.cpp:53), dW_ij at the pair minimum ratio
    (= the larger h, symmetric);
  * the cell structure is a LADDER of grids whose spacing doubles per
    level; level-l particles are tabulated on their own level's grid for
    same-or-finer queries, and every finer level is ALSO tabulated on the
    coarser grids so coarse-radius queries stay 3^d-window searches
    (static shapes — the reference instead walks a variable cell radius
    per level, cell_linked_list.hpp).

XLA-native: everything is fixed-capacity and mask-filtered; the combined
neighbor list concatenates the per-level searches along the slot axis.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from sphinxsys_jax.neighbors.cell_list import CellGrid, build_cell_table, grid_from_bounds
from sphinxsys_jax.neighbors.neighbor_list import NeighborList, build_neighbor_list, gather


class MultilevelTables(NamedTuple):
    """Per-level cell tables of one body.  tables[l] tabulates all
    particles with level >= l (their own and every finer level) on the
    level-l grid, so a level-l-radius query is a single 3^d window."""

    grids: tuple            # (L,) CellGrid, coarse -> fine
    tables: tuple           # (L,) CellTable
    level_of: jnp.ndarray   # (N,) int32 particle level (0 = coarsest)
    cutoffs: tuple          # (L,) float level cutoff radii


def particle_levels(h_ratio, n_levels: int):
    """Level of each particle: l = floor(log2(h_ratio)) clipped — level 0
    holds h in (h_ref/2, h_ref], level 1 (h_ref/4, h_ref/2], ..."""
    lv = jnp.floor(jnp.log2(jnp.maximum(h_ratio, 1.0)) + 1e-6).astype(jnp.int32)
    return jnp.clip(lv, 0, n_levels - 1)


def build_multilevel_tables(pos, valid, h_ratio, lower, upper, h_ref: float,
                            kernel_size: float = 2.0, n_levels: int = 2,
                            cap: int = 24, periodic=None) -> MultilevelTables:
    level_of = particle_levels(h_ratio, n_levels)
    n = pos.shape[0]
    if getattr(valid, "ndim", 0) == 0:
        valid = jnp.arange(n) < valid
    grids, tables, cutoffs = [], [], []
    for l in range(n_levels):
        cutoff_l = kernel_size * h_ref / (2 ** l)
        grid = (grid_from_bounds(lower, upper, cutoff_l, periodic=periodic)
                if periodic is not None else
                grid_from_bounds(lower, upper, cutoff_l))
        mask = valid & (level_of >= l)
        tables.append(build_cell_table(pos, mask, grid, cap=cap * (2 ** l)))
        grids.append(grid)
        cutoffs.append(cutoff_l)
    return MultilevelTables(grids=tuple(grids), tables=tuple(tables),
                            level_of=level_of, cutoffs=tuple(cutoffs))


def build_adaptive_neighbor_list(pos_q, valid_q, h_ratio_q, pos_s, h_ratio_s,
                                 ml: MultilevelTables, kernel_size: float,
                                 h_ref: float, k_max_per_level: Sequence[int],
                                 include_self: bool = False, box=None):
    """Adaptive neighbor search: per level l, a 3^d-window query of the
    level-l table at the level-l cutoff, post-filtered by the pair
    criterion r < kernel_size * max(h_i, h_j); level-(l+1..) sources found
    at level l are dropped there (they are found exactly once, at their
    own level's search, where the radius already covers them if the pair
    criterion holds... rather: sources are kept at level l only if their
    own level is <= l, so each (i, j) pair appears exactly once)."""
    n_levels = len(ml.grids)
    nls = []
    lvl_s = ml.level_of
    h_s = h_ref / jnp.maximum(h_ratio_s, 1e-30)
    h_q = h_ref / jnp.maximum(h_ratio_q, 1e-30)
    for l in range(n_levels):
        nl = build_neighbor_list(pos_q, valid_q, pos_s,
                                 jnp.ones(pos_s.shape[0], bool),
                                 ml.tables[l], ml.grids[l], ml.cutoffs[l],
                                 k_max=k_max_per_level[l],
                                 include_self=True)
        # a pair's level is set by its COARSER member (that member's h is
        # the pair max, so level-l's search radius covers it exactly);
        # keeping only min(lvl_i, lvl_j) == l makes each pair appear once
        lvl_q = particle_levels(h_ratio_q, n_levels)
        lvl_j, mask = gather(lvl_s, nl.idx)
        hr_j, _ = gather(jnp.asarray(h_ratio_s), nl.idx)
        pos_j, _ = gather(pos_s, nl.idx)
        disp = pos_q[:, None, :] - pos_j
        if box is not None and any(b > 0 for b in box):
            from sphinxsys_jax.physics.pair import min_image
            disp = min_image(disp, box)
        r = jnp.linalg.norm(disp, axis=-1)
        h_j = h_ref / jnp.maximum(hr_j, 1e-30)
        pair_cut = kernel_size * jnp.maximum(h_q[:, None], h_j)
        pair_level = jnp.minimum(lvl_q[:, None], lvl_j)
        keep = mask & (pair_level == l) & (r < pair_cut)
        if not include_self:
            keep = keep & (nl.idx != jnp.arange(pos_q.shape[0])[:, None])
        ns = pos_s.shape[0]
        idx = jnp.where(keep, nl.idx, ns)
        nls.append(NeighborList(idx=idx, count=jnp.sum(keep, axis=1),
                                overflow=nl.overflow))
    idx = jnp.concatenate([nl.idx for nl in nls], axis=1)
    count = sum(nl.count for nl in nls)
    overflow = jnp.any(jnp.stack([nl.overflow for nl in nls]))
    return NeighborList(idx=idx, count=count, overflow=overflow)


def adaptive_density_summation(pos, mass, h_ratio, nl: NeighborList, kernel,
                               dim: int, h_ref: float):
    """rho_i = m_i W(0; h_i) + sum_j m_j W(r_ij; h_i) — the physical
    summation with each particle's own kernel (gather side of the
    reference's DensitySummationAdaptive)."""
    pos_j, mask = gather(pos, nl.idx)
    m_j, _ = gather(mass, nl.idx)
    r = jnp.linalg.norm(pos[:, None, :] - pos_j, axis=-1)
    hr_i = h_ratio[:, None]
    W = kernel.W_adaptive(r, hr_i, dim) * mask
    w0 = kernel._factor_w(dim) * (h_ratio ** dim) * kernel._w(jnp.zeros(()))
    return mass * w0 + jnp.sum(m_j * W, axis=1)
