"""Cell-linked lists as sort-based count-sort tables.

Counterpart of the reference CK stack's count-sort cell list
(/root/reference/src/shared/shared_ck/particle_dynamics/configuration_dynamics/
update_cell_linked_list.hpp:40-106): there, an atomic histogram + exclusive
scan + scatter builds `particle_index_`/`cell_offset_` arrays.  The XLA
programming model has no atomics, so we get the identical data structure
deterministically:

    cell id per particle  ->  stable argsort by cell id  ->  offsets by
    searchsorted  ->  dense (ncells, cap) table scattered by in-cell rank.

The dense fixed-capacity table replaces the CSR `cell_offset_` walk
(shared_ck cell_linked_list.hpp:145-155) because XLA wants static shapes;
`cap` is the max particles per cell (cell size = kernel cutoff, so lattice
occupancy is ~ (cutoff/dx)^dim; overflow is detected and reported).

Morton (Z-order) keys for the periodic spatial resort
(shared_ck/.../particle_sort_ck.hpp:64-105, meshes/base_mesh.h:104) are in
`morton_key`.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class CellGrid:
    """Static background-grid metadata (meshes/base_mesh.h Mesh).

    `periodic` marks axes with wrap-around topology; on those axes the grid
    exactly tiles the domain (spacing = L/n >= cutoff) and neighbor-window
    cells wrap modulo the shape — the XLA replacement for the reference's
    ghost image cells (domain_bounding.h PeriodicConditionUsingCellLinkedList).
    """

    lower: Tuple[float, ...]
    spacing: Tuple[float, ...]  # cell edge length per axis, >= kernel cutoff
    shape: Tuple[int, ...]  # number of cells per axis
    periodic: Tuple[bool, ...] | None = None

    @property
    def dim(self) -> int:
        return len(self.shape)

    @property
    def ncells(self) -> int:
        return int(np.prod(self.shape))

    @property
    def periodic_lengths(self) -> Tuple[float, ...]:
        """Domain length per axis where periodic, else 0 (no wrap)."""
        if self.periodic is None:
            return (0.0,) * self.dim
        return tuple(s * n if p else 0.0
                     for s, n, p in zip(self.spacing, self.shape, self.periodic))

    def cell_coords(self, pos):
        """(..., dim) float positions -> (..., dim) int32 cell coords:
        wrapped modulo shape on periodic axes, clipped otherwise (the
        reference uses a buffer band instead, cell_linked_list.h; clipping
        is equivalent for in-domain physics)."""
        lo = jnp.asarray(self.lower, dtype=pos.dtype)
        sp = jnp.asarray(self.spacing, dtype=pos.dtype)
        c = jnp.floor((pos - lo) / sp).astype(jnp.int32)
        n = jnp.asarray(self.shape, dtype=jnp.int32)
        if self.periodic is not None and any(self.periodic):
            pmask = jnp.asarray(self.periodic)
            c = jnp.where(pmask, jnp.mod(c, n), jnp.clip(c, 0, n - 1))
        else:
            c = jnp.clip(c, 0, n - 1)
        return c

    def flatten_coords(self, coords):
        """Row-major linear cell index."""
        strides = np.ones(self.dim, dtype=np.int64)
        for d in range(self.dim - 2, -1, -1):
            strides[d] = strides[d + 1] * self.shape[d + 1]
        s = jnp.asarray(strides, dtype=jnp.int32)
        return jnp.sum(coords * s, axis=-1)

    def cell_id(self, pos):
        return self.flatten_coords(self.cell_coords(pos))


def grid_from_bounds(lower, upper, cutoff: float, buffer_cells: int = 1,
                     periodic=None) -> CellGrid:
    """Build the grid covering [lower, upper].  Non-periodic axes get cell
    size = cutoff and a safety band of `buffer_cells` on each side;
    periodic axes exactly tile [lower, upper] with n = floor(L/cutoff)
    cells of size L/n >= cutoff (required for minimum-image wrapping)."""
    lower = np.asarray(lower, dtype=np.float64)
    upper = np.asarray(upper, dtype=np.float64)
    dim = len(lower)
    periodic = tuple(periodic) if periodic is not None else (False,) * dim
    lo, spacing, shape = [], [], []
    for d in range(dim):
        if periodic[d]:
            L = upper[d] - lower[d]
            n = max(int(np.floor(L / cutoff)), 1)
            lo.append(float(lower[d]))
            spacing.append(L / n)
            shape.append(n)
        else:
            lo.append(float(lower[d] - buffer_cells * cutoff))
            extent = upper[d] + buffer_cells * cutoff - lo[-1]
            shape.append(max(int(np.ceil(extent / cutoff)), 1))
            spacing.append(float(cutoff))
    return CellGrid(lower=tuple(lo), spacing=tuple(spacing),
                    shape=tuple(shape),
                    periodic=periodic if any(periodic) else None)


def wrap_positions(pos, grid: CellGrid):
    """Periodic bounding (domain_bounding.h bounding_): map positions back
    into the primary domain on periodic axes."""
    if grid.periodic is None or not any(grid.periodic):
        return pos
    lo = jnp.asarray(grid.lower, dtype=pos.dtype)
    L = jnp.asarray([s * n for s, n in zip(grid.spacing, grid.shape)], dtype=pos.dtype)
    pmask = jnp.asarray(grid.periodic)
    wrapped = lo + jnp.mod(pos - lo, L)
    return jnp.where(pmask, wrapped, pos)


class CellTable(NamedTuple):
    """Dense per-cell particle table (the XLA analog of
    `dv_particle_index_` + `dv_cell_offset_`, update_cell_linked_list.hpp).

    table:   (ncells + 1, cap) int32 — particle indices, padded with the
             sentinel `n_capacity`; the extra last row is all-sentinel and
             serves as the target for out-of-grid cell lookups.
    counts:  (ncells,) int32 — particles in each cell.
    overflow: () bool — any cell exceeded `cap` (its extra particles were
             dropped; the caller must rebuild with a larger cap).
    """

    table: jnp.ndarray
    counts: jnp.ndarray
    overflow: jnp.ndarray


def build_cell_table(pos, n_real, grid: CellGrid, cap: int) -> CellTable:
    """Count-sort the particles into the dense cell table.

    pos:    (N, dim) positions (padding rows may be garbage/far away)
    n_real: int32 scalar (rows >= n_real ignored) OR a (N,) bool validity
            mask (for open boundaries where alive particles are not a
            contiguous prefix)
    """
    n = pos.shape[0]
    ncells = grid.ncells
    valid = n_real if getattr(n_real, "ndim", 0) == 1 else jnp.arange(n) < n_real
    cid = jnp.where(valid, grid.cell_id(pos), ncells)
    order = jnp.argsort(cid)  # stable: preserves index order within a cell
    sorted_cid = cid[order]
    # offsets[c] = first sorted position with cell id >= c
    offsets = jnp.searchsorted(sorted_cid, jnp.arange(ncells + 1, dtype=sorted_cid.dtype))
    rank = jnp.arange(n, dtype=jnp.int32) - offsets[jnp.minimum(sorted_cid, ncells)].astype(jnp.int32)
    table = jnp.full((ncells + 1, cap), n, dtype=jnp.int32)
    # out-of-bounds rows (sentinel cell) and ranks >= cap are dropped
    table = table.at[sorted_cid, rank].set(order.astype(jnp.int32), mode="drop")
    counts = (offsets[1:] - offsets[:-1]).astype(jnp.int32)
    overflow = jnp.max(counts) > cap
    return CellTable(table=table, counts=counts, overflow=overflow)


# ---------------------------------------------------------------------------
# Morton (Z-order) keys for spatial locality resorting
# ---------------------------------------------------------------------------

def _part1by1(x):
    """Interleave 16-bit value with zeros (x -> bits at even positions)."""
    x = x & 0xFFFF
    x = (x | (x << 8)) & 0x00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F
    x = (x | (x << 2)) & 0x33333333
    x = (x | (x << 1)) & 0x55555555
    return x


def _part1by2(x):
    """Interleave 10-bit value with two zero bits each."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton_key(coords):
    """(..., dim) int cell coords -> (...,) uint32 Morton code
    (meshes/base_mesh.h:85-104 MortonCode)."""
    c = coords.astype(jnp.uint32)
    dim = coords.shape[-1]
    if dim == 1:
        return c[..., 0]
    if dim == 2:
        return _part1by1(c[..., 0]) | (_part1by1(c[..., 1]) << 1)
    if dim == 3:
        return _part1by2(c[..., 0]) | (_part1by2(c[..., 1]) << 1) | (_part1by2(c[..., 2]) << 2)
    raise ValueError(f"dim must be 1/2/3, got {dim}")


def spatial_sort_permutation(pos, n_real, grid: CellGrid):
    """Permutation placing real particles in Morton order (padding rows
    stay at the tail).  Applying it to every evolving variable is the
    analog of ParticleSortCK (particle_sort_ck.hpp:64-105)."""
    n = pos.shape[0]
    valid = jnp.arange(n) < n_real
    key = morton_key(grid.cell_coords(pos))
    key = jnp.where(valid, key, jnp.uint32(0xFFFFFFFF))
    return jnp.argsort(key)
