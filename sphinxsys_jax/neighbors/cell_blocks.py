"""Cell-block pair engine — the fluid hot path.

The fixed-capacity neighbor-list engine (neighbor_list.py) gathers one
element per PAIR (`pos[nbr_idx]`, shape (N, K)).  This module replaces
per-pair gathers with per-CELL block gathers:

  * particles are count-sorted into dense per-occupied-cell blocks of
    `cap` slots: block arrays have shape (C_max+1, cap, ...) with an
    all-padding sentinel row at index C_max;
  * each occupied cell precomputes the block index of its 3^dim window
    neighbors (`nbr_block`) through a dense cell -> block-row map — so a
    pair sweep gathers whole contiguous (cap, ch) rows instead of single
    elements;
  * pair interactions are dense (C, cap_i, cap_j) broadcast ops, masked
    by the distance test.

This is the reference CK stack's count-sort cell list + cell-offset walk
(shared_ck/.../update_cell_linked_list.hpp:40-106, cell_linked_list.hpp:
145-155) re-shaped for a vector machine: the CSR walk becomes a dense
block bilinear sweep, and atomics become sort + deterministic gathers.

The trade: cap^2 * 3^dim / avg_pairs ~ 10-16x more (perfectly regular)
pair slots than true pairs, in exchange for no per-pair indexing.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from sphinxsys_jax.neighbors.cell_list import CellGrid


def _window_offsets(dim: int):
    return list(itertools.product(*([(-1, 0, 1)] * dim)))


class BlockMap(NamedTuple):
    """Slotting of particles into occupied-cell blocks.

    occ_cells:     (C_max,) int32 — sorted occupied cell ids, padded with
                   `ncells` sentinels.
    n_occ:         () int32 — number of occupied cells.
    nbr_block:     (C_max, 3^dim) int32 — block row of each window
                   neighbor cell; sentinel C_max (the all-padding row).
    slot_particle: (C_max*cap,) int32 — particle index filling each slot,
                   sentinel N for empty slots.
    slot_mask:     (C_max*cap,) bool — slot holds a real particle.
    particle_slot: (N,) int32 — inverse map (slot of each particle;
                   undefined for invalid particles); None unless
                   `with_inverse` (it costs a second argsort — IO only).
    overflow:      () bool — cap or C_max exceeded; results invalid.
    order_n:       (M,) int32 — first M entries of the cid argsort (all
                   valid particles in block order); M = min(n_max, N).
    start:         (C_max,) int32 — sorted position where block row r's
                   run begins (sentinel M).
    """

    occ_cells: jnp.ndarray
    n_occ: jnp.ndarray
    nbr_block: jnp.ndarray
    slot_particle: jnp.ndarray
    slot_mask: jnp.ndarray
    particle_slot: jnp.ndarray
    overflow: jnp.ndarray
    order_n: jnp.ndarray
    start: jnp.ndarray

    @property
    def c_max(self) -> int:
        return self.occ_cells.shape[0]

    @property
    def cap(self) -> int:
        return self.slot_particle.shape[0] // self.occ_cells.shape[0]


def _flat_strides(grid: CellGrid):
    shape = grid.shape
    strides = [1] * len(shape)
    for d in range(len(shape) - 2, -1, -1):
        strides[d] = strides[d + 1] * shape[d + 1]
    return strides


def _shift_flat(col, off: int, fill):
    """out[i] = col[i + off], `fill` beyond the ends."""
    if off == 0:
        return col
    if off > 0:
        return jnp.concatenate([col[off:], jnp.full((off,), fill, col.dtype)])
    return jnp.concatenate([jnp.full((-off,), fill, col.dtype), col[:off]])


# window tables: shifted copies of the dense cell map (contiguous slices)
# turn the 3^dim per-window dense-map lookups of the naive construction
# into ONE row gather.  Cross-boundary shifts give wrong neighbors on
# non-periodic axes — masked by the same in-bounds test the naive path
# uses.  Axis-0 wrap is a flat roll; wrap on any later axis cannot be
# expressed as a flat shift -> return None (callers fall back).

_TABLE_BYTES_BUDGET = 192 * 1024 * 1024


def _window_table_full(dense_map, grid: CellGrid, c_max_src: int):
    """(ncells+1,) -> (ncells+1, 3^dim) per-window row table, or None."""
    dim = grid.dim
    ncells = grid.ncells
    periodic = grid.periodic or (False,) * dim
    if any(periodic[1:]):
        return None
    nw = 3 ** dim
    if (ncells + 1) * nw * 4 > _TABLE_BYTES_BUDGET:
        return None
    strides = _flat_strides(grid)
    core = dense_map[:ncells]
    fill = jnp.int32(c_max_src)
    cols = []
    for off in _window_offsets(dim):
        o = sum(off[d] * strides[d] for d in range(dim))
        if periodic[0] and off[0] != 0:
            cols.append(jnp.roll(core, -o))
        else:
            cols.append(_shift_flat(core, o, fill))
    table = jnp.stack(cols, axis=-1)
    sent = jnp.full((1, nw), c_max_src, jnp.int32)
    return jnp.concatenate([table, sent], axis=0)


def _window_table_tri(dense_map, grid: CellGrid, c_max_src: int):
    """(ncells+1,) -> (ncells+1, 3) last-axis-offset table (big 3D grids
    where the full table exceeds the budget), or None."""
    periodic = grid.periodic or (False,) * grid.dim
    if periodic[-1]:
        return None
    core = dense_map[:grid.ncells]
    fill = jnp.int32(c_max_src)
    table = jnp.stack([_shift_flat(core, o, fill) for o in (-1, 0, 1)],
                      axis=-1)
    sent = jnp.full((1, 3), c_max_src, jnp.int32)
    return jnp.concatenate([table, sent], axis=0)


def neighbor_window_rows(occ_cells, grid: CellGrid, dense_map,
                         c_max_src: int):
    """(C,) occupied cell ids + (ncells+1,) dense cell->row map ->
    (C, 3^dim) window-neighbor block rows (sentinel c_max_src), using
    shifted window tables + row gathers where the grid allows, else
    per-window dense lookups."""
    dim = grid.dim
    ncells = grid.ncells
    gshape = jnp.asarray(grid.shape, dtype=jnp.int32)
    periodic = grid.periodic or (False,) * dim
    pmask = jnp.asarray(periodic)
    coords = _unflatten(occ_cells, grid)
    safe_occ = jnp.minimum(occ_cells, ncells)

    def _inb(nc):
        ncw = jnp.where(pmask, jnp.mod(nc, gshape), nc) if any(periodic) \
            else nc
        return ncw, jnp.all((ncw >= 0) & (ncw < gshape), axis=-1)

    table = _window_table_full(dense_map, grid, c_max_src)
    if table is not None:
        rows = table[safe_occ]                       # ONE row gather
        outs = []
        for w, off in enumerate(_window_offsets(dim)):
            _, inb = _inb(coords + jnp.asarray(off, dtype=jnp.int32))
            outs.append(jnp.where(inb, rows[:, w], c_max_src))
        return jnp.stack(outs, axis=1)

    tri = _window_table_tri(dense_map, grid, c_max_src)
    if tri is not None:
        lead_offs = list(itertools.product(*([(-1, 0, 1)] * (dim - 1))))
        outs = [None] * 3 ** dim
        win = _window_offsets(dim)
        for lead in lead_offs:
            nc_l, inb_l = _inb(coords + jnp.asarray(lead + (0,), jnp.int32))
            target = jnp.where(inb_l, grid.flatten_coords(
                jnp.clip(nc_l, 0, gshape - 1)), ncells)
            rows3 = tri[target]                      # (C, 3) row gather
            for k, oz in enumerate((-1, 0, 1)):
                w = win.index(lead + (oz,))
                zc = coords[:, dim - 1] + oz
                inb_z = (zc >= 0) & (zc < grid.shape[dim - 1]) \
                    if not periodic[-1] else jnp.ones_like(zc, bool)
                outs[w] = jnp.where(inb_l & inb_z, rows3[:, k], c_max_src)
        return jnp.stack(outs, axis=1)

    # fallback: per-window dense lookups (periodic beyond axis 0)
    nbrs = []
    for off in _window_offsets(dim):
        nc, inb = _inb(coords + jnp.asarray(off, dtype=jnp.int32))
        target = jnp.where(inb, grid.flatten_coords(
            jnp.clip(nc, 0, gshape - 1)), ncells)
        nbrs.append(dense_map[target])
    return jnp.stack(nbrs, axis=1)


def build_block_map(pos, valid, grid: CellGrid, cap: int, c_max: int,
                    n_max: int | None = None,
                    with_inverse: bool = True, carry=None):
    """Count-sort particles into occupied-cell blocks (one argsort + a few
    scatters; runs once per advection step).

    pos:   (N, dim) — N may itself be a slot array being re-slotted.
    valid: (N,) bool, or an int scalar n_real (rows >= n_real invalid).
    n_max: static upper bound on the number of valid rows (e.g. the
           particle capacity when re-slotting a (C_max*cap)-row slot
           array, which is 2-3x larger).  Everything after the argsort
           runs on the first n_max sorted rows only.
    with_inverse: compute `particle_slot` (costs a second argsort over all
           N rows; only IO paths need it).
    """
    n, dim = pos.shape
    ncells = grid.ncells
    m = n if n_max is None else min(n_max, n)
    if getattr(valid, "ndim", 0) == 0:
        valid = jnp.arange(n) < valid
    cid = jnp.where(valid, grid.cell_id(pos), ncells).astype(jnp.int32)

    # a key-value sort (cell id, particle index) is the form GPU sorts
    # handle fastest; the carried field columns then follow with ONE row
    # gather of the M valid rows (a multi-operand sort would move every
    # column on every pass over all N rows)
    iota = jnp.arange(n, dtype=jnp.int32)
    scid_full, order = jax.lax.sort((cid, iota), num_keys=1, is_stable=True)
    order_n = order[:m]
    scid = scid_full[:m]
    prev = jnp.concatenate([jnp.full((1,), -1, scid.dtype), scid[:-1]])
    is_first = (scid != prev) & (scid < ncells)
    csum = jnp.cumsum(is_first.astype(jnp.int32))
    occ_rank = csum - 1                       # (M,) block row per sorted particle
    n_occ = csum[-1]

    # Everything below is gather/sort-based (no scatters).
    r_idx = jnp.arange(c_max, dtype=jnp.int32)
    # p_r = sorted position where occupied cell r's run begins = position
    # of the r-th is_first entry.  A stable 0/1-key sort compacts those
    # positions (and their cell ids) to the front.
    pos_m = jnp.arange(m, dtype=jnp.int32)
    _, p_sorted, cell_sorted = jax.lax.sort(
        (jnp.where(is_first, jnp.int32(0), jnp.int32(1)), pos_m, scid),
        num_keys=1, is_stable=True)
    if c_max > m:
        pad = jnp.full((c_max - m,), m, jnp.int32)
        p_sorted = jnp.concatenate([p_sorted, pad])
        cell_sorted = jnp.concatenate(
            [cell_sorted, jnp.full((c_max - m,), ncells, jnp.int32)])
    found = r_idx < n_occ
    start = jnp.where(found, p_sorted[:c_max], m).astype(jnp.int32)
    occ_cells = jnp.where(found, cell_sorted[:c_max], ncells)

    rank = jnp.arange(m, dtype=jnp.int32) - start[
        jnp.clip(occ_rank, 0, c_max - 1)]
    sort_valid = scid < ncells
    big = c_max * cap

    # slot_particle by direct row gathers: block row r's occupants are the
    # consecutive sorted positions start[r] .. start[r] + count[r]
    n_valid = jnp.sum(sort_valid.astype(jnp.int32))
    nxt = jnp.concatenate([start[1:], jnp.full((1,), m, jnp.int32)])
    count = jnp.minimum(nxt, n_valid) - jnp.minimum(start, n_valid)
    k_idx = jnp.arange(cap, dtype=jnp.int32)
    occ_pos = start[:, None] + k_idx[None, :]            # (c_max, cap)
    valid_slot = (k_idx[None, :] < jnp.minimum(count, cap)[:, None]) & found[:, None]
    slot_particle = jnp.where(
        valid_slot, order_n[jnp.minimum(occ_pos, m - 1)].astype(jnp.int32),
        n).reshape(-1)
    slot_mask = slot_particle < n

    if with_inverse:
        # inverse map (IO only), scatter-free: invert the sort permutation
        # with a second argsort
        slot_ok = sort_valid & (rank < cap) & (occ_rank < c_max)
        slot_m = jnp.where(slot_ok, occ_rank * cap + rank, big).astype(jnp.int32)
        slot_full = jnp.concatenate(
            [slot_m, jnp.full((n - m,), big, jnp.int32)]) if m < n else slot_m
        inv_order = jnp.argsort(order)
        particle_slot = slot_full[inv_order]
    else:
        particle_slot = None

    overflow = (n_occ > c_max) | jnp.any(sort_valid & (rank >= cap))
    # n_max too small: valid rows spilled past m (they sort before
    # invalid-sentinel rows, so a spill means row m-1 is still valid)
    if m < n:
        overflow = overflow | (cid[order[m]] < ncells)

    # window-neighbor block rows via a dense cell -> block-row map (one
    # small scatter, then shifted window tables + row gathers — see
    # neighbor_window_rows)
    dense_map = jnp.full((ncells + 1,), c_max, dtype=jnp.int32)
    dense_map = dense_map.at[jnp.minimum(occ_cells, ncells)].set(
        jnp.arange(c_max, dtype=jnp.int32), mode="drop")
    dense_map = dense_map.at[ncells].set(c_max)
    nbr_block = neighbor_window_rows(occ_cells, grid, dense_map, c_max)

    bm = BlockMap(occ_cells=occ_cells, n_occ=n_occ, nbr_block=nbr_block,
                  slot_particle=slot_particle, slot_mask=slot_mask,
                  particle_slot=particle_slot, overflow=overflow,
                  order_n=order_n, start=start)
    if carry is None:
        return bm
    # blocks from the sorted carry by one CHUNK gather per occupied block
    # row (cap consecutive sorted rows): vmap(dynamic_slice) lowers to a
    # gather with slice_sizes, one index per block instead of per slot
    sc = carry[order_n]                                 # (M, CH)
    pad = jnp.zeros((cap, sc.shape[1]), sc.dtype)
    sc = jnp.concatenate([sc, pad], axis=0)
    start_cl = jnp.minimum(start, m).astype(jnp.int32)
    zero = jnp.zeros((), start_cl.dtype)
    blocks = jax.vmap(
        lambda st: jax.lax.dynamic_slice(sc, (st, zero),
                                         (cap, sc.shape[1])))(
            start_cl)                                   # (c_max, cap, CH)
    return bm, blocks


def _unflatten(flat, grid: CellGrid):
    """Row-major flat cell id -> (..., dim) coords (sentinels give garbage
    coords, masked downstream)."""
    dims = grid.shape
    coords = []
    rem = flat
    for d in range(len(dims) - 1, -1, -1):
        coords.append(rem % dims[d])
        rem = rem // dims[d]
    return jnp.stack(coords[::-1], axis=-1).astype(jnp.int32)


def dense_cell_map(occ_cells, ncells: int, c_max: int):
    """Dense cell-id -> block-row lookup table ((ncells+1,), sentinel
    c_max).  Precompute once for STATIC bodies (walls) so contact window
    lookups are pure gathers."""
    dm = jnp.full((ncells + 1,), c_max, dtype=jnp.int32)
    dm = dm.at[jnp.minimum(occ_cells, ncells)].set(
        jnp.arange(c_max, dtype=jnp.int32), mode="drop")
    return dm.at[ncells].set(c_max)


def cross_neighbor_blocks(occ_cells_q, grid: CellGrid, bm_src: BlockMap,
                          src_dense_map=None):
    """Window-neighbor block rows of ANOTHER body's block map (contact
    relations): for each query occupied cell, the source block row of each
    of its 3^dim window cells (sentinel = src c_max).  Pass the source's
    precomputed `dense_cell_map` to replace binary searches with gathers
    (static contact bodies)."""
    c_max_s = bm_src.c_max
    dm = src_dense_map if src_dense_map is not None else dense_cell_map(
        bm_src.occ_cells, grid.ncells, c_max_s)
    return neighbor_window_rows(occ_cells_q, grid, dm, c_max_s)


# ---------------------------------------------------------------------------
# layout conversion
# ---------------------------------------------------------------------------

def to_blocks(bm: BlockMap, arr, fill=0.0):
    """Particle array (N, ...) -> block array (C_max+1, cap, ...) with an
    all-`fill` sentinel row at C_max."""
    n = arr.shape[0]
    cap = bm.cap
    safe = jnp.minimum(bm.slot_particle, n - 1)
    flat = jnp.where(
        bm.slot_mask.reshape((-1,) + (1,) * (arr.ndim - 1)), arr[safe],
        jnp.asarray(fill, dtype=arr.dtype))
    blocks = flat.reshape((bm.c_max, cap) + arr.shape[1:])
    sentinel = jnp.full((1, cap) + arr.shape[1:], fill, dtype=arr.dtype)
    return jnp.concatenate([blocks, sentinel], axis=0)


def from_blocks(bm: BlockMap, blocks, out_n: int):
    """Block array (C_max+1, cap, ...) -> particle array (N, ...)."""
    flat = blocks.reshape((-1,) + blocks.shape[2:])
    safe = jnp.minimum(bm.particle_slot, bm.c_max * bm.cap - 1)
    valid = bm.particle_slot < bm.c_max * bm.cap
    out = flat[safe[:out_n]]
    return jnp.where(valid[:out_n].reshape((-1,) + (1,) * (blocks.ndim - 2)),
                     out, jnp.zeros_like(out))


def from_blocks_packed(bm: BlockMap, fb: dict, fields, n_out: int):
    """Inverse of to_blocks_packed: recover per-particle rows for MANY
    block fields with ONE row gather through ``particle_slot`` (requires
    the map built with ``with_inverse=True``).  Rows whose slot is the
    sentinel come back as zeros + a False entry in the returned mask."""
    fdtype = jnp.result_type(*[fb[k].dtype for k in fields
                               if fb[k].dtype != jnp.int32] or [jnp.float32])
    idtype = jnp.int32 if fdtype == jnp.float32 else jnp.int64

    def _to_container(v):
        if v.dtype == jnp.int32:
            return jax.lax.bitcast_convert_type(v.astype(idtype), fdtype)
        return v.astype(fdtype)

    cols = []
    for k in fields:
        flat = fb[k].reshape((-1,) + fb[k].shape[2:])
        c = _to_container(flat)
        cols.append(c[:, None] if c.ndim == 1 else c)
    packed = jnp.concatenate(cols, axis=-1)          # ((C+1)*cap, CH)

    big = bm.c_max * bm.cap
    slot = bm.particle_slot[:n_out]
    valid = slot < big
    rows = packed[jnp.minimum(slot, packed.shape[0] - 1)]    # ONE gather

    out = {}
    col0 = 0
    for k in fields:
        v = fb[k]
        ncol = 1 if v.ndim == 2 else v.shape[2]
        sub = rows[:, col0:col0 + ncol]
        if v.dtype == jnp.int32:
            sub = jax.lax.bitcast_convert_type(sub, idtype).astype(jnp.int32)
        else:
            sub = sub.astype(v.dtype)
        sub = jnp.where(valid[:, None], sub, jnp.zeros_like(sub))
        out[k] = sub[:, 0] if v.ndim == 2 else sub
        col0 += ncol
    return out, valid


def gather_window(blocks, nbr_block):
    """Gather the 3^dim window neighbor blocks: (C_max+1, cap, ...) +
    (C_max, W) -> (C_max, W, cap, ...).  Row-granularity gather (each row
    is cap * channels contiguous elements)."""
    return blocks[nbr_block]


def to_blocks_packed(bm: BlockMap, fields: dict, fills: dict | None = None):
    """Re-slot MANY fields with ONE row gather.

    Packs every (N, ...) array into a single (N, ch) f32 matrix (int32
    fields ride along bit-cast, exact under pure gathers), gathers the
    packed rows through slot_particle, and unpacks to block arrays
    (C_max+1, cap, ...).  Ten separate 4-byte element gathers become one
    row gather.
    """
    fills = fills or {}
    n = next(iter(fields.values())).shape[0]
    # packing container = the widest float dtype present (production is
    # fp32; fp64 paths — x64 tests — must not silently downcast, and a
    # mixed-width concatenate would promote under x64 and break the int
    # bitcasts below)
    fdtype = jnp.result_type(*[v.dtype for v in fields.values()
                               if v.dtype != jnp.int32] or [jnp.float32])
    idtype = jnp.int32 if fdtype == jnp.float32 else jnp.int64

    def _to_container(v):
        if v.dtype == jnp.int32:
            return jax.lax.bitcast_convert_type(v.astype(idtype), fdtype)
        return v.astype(fdtype)

    cols = []
    for k, v in fields.items():
        c = _to_container(v)
        cols.append(c[:, None] if v.ndim == 1 else c)
    packed = jnp.concatenate(cols, axis=-1)                 # (N, CH)
    cap = bm.cap

    safe = jnp.minimum(bm.slot_particle, n - 1)
    rows = packed[safe]                                     # ONE gather
    maskc = bm.slot_mask[:, None]

    out = {}
    col0 = 0
    for k, v in fields.items():
        ncol = 1 if v.ndim == 1 else v.shape[1]
        sub = rows[:, col0:col0 + ncol]
        fill = fills.get(k, 0.0)
        if v.dtype == jnp.int32:
            sub = jax.lax.bitcast_convert_type(sub, idtype).astype(jnp.int32)
            sub = jnp.where(maskc, sub, jnp.asarray(fill, jnp.int32))
        else:
            sub = jnp.where(maskc, sub.astype(v.dtype),
                            jnp.asarray(fill, v.dtype))
        if v.ndim == 1:
            sub = sub[:, 0]
            sentinel = jnp.full((1, cap), fill, dtype=v.dtype)
        else:
            sentinel = jnp.full((1, cap, ncol), fill, dtype=v.dtype)
        blocks = sub.reshape((bm.c_max, cap) + v.shape[1:])
        out[k] = jnp.concatenate([blocks, sentinel], axis=0)
        col0 += ncol
    return out
