"""Fixed-capacity neighbor lists (fixed-shape relations).

Counterpart of the reference CK relations
(/root/reference/src/shared/shared_ck/body_relation/relation_ck.h:60-175 —
CSR `dv_neighbor_index_`/`dv_particle_offset_` built by a two-pass
count->scan->fill with atomics, update_body_relation.hpp:62-145).  XLA wants
static shapes and no atomics, so the CSR becomes a dense (Nq, K) index
tensor with a per-row count; pairs are found by scanning the 3^dim cell
window around each query particle (cell_linked_list.hpp searchNeighborsByMesh
semantics) and compacted left with a cumsum scatter — fully deterministic.

Like the CK stack (neighbor_method.h:53-116), no kernel values are stored:
W/dW/e_ij are recomputed from positions inside each interaction op, which
keeps the list valid across acoustic sub-steps and trades cheap VPU flops
for HBM bandwidth.

An InnerRelation is build_neighbor_list(query=body, source=body,
include_self=False); a ContactRelation is query=body_a, source=body_b.
"""

from __future__ import annotations

import itertools
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from sphinxsys_jax.neighbors.cell_list import CellGrid, CellTable


class NeighborList(NamedTuple):
    """idx: (Nq, K) int32 neighbor indices into the source body, padded
    with sentinel = source capacity; count: (Nq,) int32; overflow: () bool
    (a row had more than K neighbors — rebuild with larger K)."""

    idx: jnp.ndarray
    count: jnp.ndarray
    overflow: jnp.ndarray

    @property
    def k_max(self) -> int:
        return self.idx.shape[1]


def _window_offsets(dim: int):
    return list(itertools.product(*([(-1, 0, 1)] * dim)))


def build_neighbor_list(
    pos_q, n_real_q, pos_s, n_real_s, table: CellTable, grid: CellGrid,
    cutoff: float, k_max: int, include_self: bool,
) -> NeighborList:
    """Find all source particles within `cutoff` of each query particle.

    pos_q: (Nq, dim) query positions; rows >= n_real_q ignored (n_real_q may
           also be a (Nq,) bool validity mask for open-boundary bodies).
    pos_s: (Ns, dim) source positions, already count-sorted into `table`.
    include_self: False for inner relations (q is the same body as s).
    """
    nq, dim = pos_q.shape
    ns = pos_s.shape[0]
    ncells = grid.ncells
    cap = table.table.shape[1]

    q_valid = (n_real_q if getattr(n_real_q, "ndim", 0) == 1
               else jnp.arange(nq) < n_real_q)
    coords = grid.cell_coords(pos_q)  # (Nq, dim)
    gshape = jnp.asarray(grid.shape, dtype=jnp.int32)
    periodic = grid.periodic or (False,) * dim
    pmask = jnp.asarray(periodic)

    # candidate indices from the 3^dim cell window -> (Nq, 3^dim * cap);
    # periodic axes wrap modulo the grid (ghost-image-free periodicity)
    cands = []
    for off in _window_offsets(dim):
        nc = coords + jnp.asarray(off, dtype=jnp.int32)
        if any(periodic):
            nc = jnp.where(pmask, jnp.mod(nc, gshape), nc)
        inb = jnp.all((nc >= 0) & (nc < gshape), axis=-1)
        flat = jnp.where(inb, grid.flatten_coords(jnp.clip(nc, 0, gshape - 1)), ncells)
        cands.append(table.table[flat])  # row ncells is all-sentinel
    cand = jnp.concatenate(cands, axis=1)  # (Nq, W*cap)

    # distance test with minimum-image wrapping on periodic axes (sentinel
    # rows gather from a clipped index but are masked out explicitly, so
    # garbage positions are harmless)
    safe = jnp.minimum(cand, ns - 1)
    pos_j = pos_s[safe]  # (Nq, W*cap, dim)
    disp = pos_q[:, None, :] - pos_j
    lengths = jnp.asarray(grid.periodic_lengths, dtype=pos_q.dtype)
    if any(periodic):
        disp = jnp.where(lengths > 0, disp - lengths * jnp.round(disp / jnp.where(
            lengths > 0, lengths, 1.0)), disp)
    r2 = jnp.sum(disp * disp, axis=-1)
    mask = (cand < ns) & (r2 < cutoff * cutoff) & q_valid[:, None]
    if not include_self:
        mask &= cand != jnp.arange(nq, dtype=cand.dtype)[:, None]

    # left-compaction: stable scatter of candidates to their rank in the row
    rank = jnp.cumsum(mask.astype(jnp.int32), axis=1) - 1
    rank = jnp.where(mask, rank, k_max)  # dropped by mode="drop"
    rows = jnp.broadcast_to(jnp.arange(nq, dtype=jnp.int32)[:, None], cand.shape)
    idx = jnp.full((nq, k_max), ns, dtype=jnp.int32)
    idx = idx.at[rows, rank].set(cand.astype(jnp.int32), mode="drop")
    count = jnp.sum(mask, axis=1).astype(jnp.int32)
    overflow = jnp.max(count) > k_max
    return NeighborList(idx=idx, count=count, overflow=overflow | table.overflow)


def gather(src, nbr_idx):
    """Gather source per-particle data for each neighbor slot.

    src: (Ns, ...) array; nbr_idx: (Nq, K) with sentinel Ns.
    Returns (values (Nq, K, ...), mask (Nq, K))."""
    ns = src.shape[0]
    safe = jnp.minimum(nbr_idx, ns - 1)
    return src[safe], nbr_idx < ns


def brute_force_neighbors(pos_q, n_real_q, pos_s, n_real_s, cutoff: float,
                          include_self: bool):
    """O(Nq*Ns) reference pair finder for tests. Returns a python set of
    (i, j) pairs."""
    pos_q = np.asarray(pos_q)[: int(n_real_q)]
    pos_s = np.asarray(pos_s)[: int(n_real_s)]
    pairs = set()
    for i in range(len(pos_q)):
        d = np.linalg.norm(pos_s - pos_q[i], axis=-1)
        js = np.nonzero(d < cutoff)[0]
        for j in js:
            if include_self or j != i:
                pairs.add((i, int(j)))
    return pairs
