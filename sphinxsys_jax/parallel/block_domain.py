"""Distributed block engine: slab decomposition for the fast path.

parallel/domain.py distributes the gather engine; this module runs the
occupied-cell block engine (neighbors/cell_blocks.py +
physics/fluid_blocks.py — the fluid hot path) across a device ring with
the same slab/halo semantics.  The reference has no distributed backend at
all (SURVEY.md §2.1); its CK stack is single-address-space
(src/shared/shared_ck/).

Design (what differs from the gather-engine distribution):

  * migration and the initial halo exchange run once per advection step in
    FLAT rows (reusing domain.migrate_rows / domain.band_exchange), then
    the combined local+ghost rows are slotted into blocks;
  * halo-band membership is FROZEN for the advection step (computed from
    the step-start positions).  The k-th band slot therefore refers to the
    same particle across every mid-step refresh, which makes the refresh a
    pure value update in block layout:
       - gather the frozen band rows' values straight out of the block
         slots (particle_slot of the band rows — 2*halo_cap row gathers),
       - one ppermute each way,
       - scatter into the frozen ghost slots (2*halo_cap rows — small).
    No flatten/re-slot inside the acoustic loop.  Mid-step band entry is
    invisible until the next rebuild — the same staleness class as the
    per-advection-step neighbor structure itself (cutoff margin covers
    one advection step's CFL-bounded motion);
  * ghost slots carry an IsGhost channel so the dt reduces run over local
    slots only (a ghost's locally computed Force is one-sided garbage;
    its Velocity/Density are refreshed owner values) — with ghosts
    excluded, the local max + lax.pmax over the ring reproduces the
    single-device reduce exactly (max is order-free), so distributed and
    single-device runs take IDENTICAL time steps;
  * at step end the local rows are flattened back with ONE packed row
    gather (from_blocks_packed) — identity rides in OriginalID.

The wall stays replicated on every device, a jit argument exactly like
the single-device block case's.
"""

from __future__ import annotations

import dataclasses

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from sphinxsys_jax.neighbors.cell_blocks import (
    build_block_map, cross_neighbor_blocks, from_blocks_packed,
    to_blocks_packed,
)
from sphinxsys_jax.parallel.domain import (
    AXIS, FAR, HaloShard, SlabDecomposition, _perm_shift, band_exchange,
    migrate_rows,
)
from sphinxsys_jax.physics import fluid_blocks as fbops

TINY = 1.0e-12


HALO_FIELDS = ("Position", "Velocity", "Density", "DensityChangeRate",
               "VolumetricMeasure")
# ---------------------------------------------------------------------------
# Generic distributed BlockEngine (VERDICT r3 item 7): any fluid case built
# on engine/block_fluid.BlockEngine runs distributed with ZERO bespoke code
# — the wrapper below is the dambreak-specific make_distributed_block_
# dambreak_step generalized over dimension, fields, walls, viscosity/TVC.
# ---------------------------------------------------------------------------

from sphinxsys_jax.engine import block_fluid as engine


def default_c_max_loc(eng, n_dev: int) -> int:
    """Per-slab occupied-cell capacity: 1/n_dev of the global budget plus
    the halo band's worth of cell columns on each side."""
    import math

    shape = eng.grid.shape
    layers = int(math.ceil(eng.kernel.cutoff / eng.grid.spacing[0])) + 1
    cross = 1
    for s in shape[1:]:
        cross *= int(s)
    halo_cells = 2 * layers * cross
    return eng.c_max // n_dev + halo_cells


def make_distributed_engine_step(eng, mesh: Mesh, wall_b=None, bm_wall=None,
                                 wall_dense_map=None, halo_cap: int = 256,
                                 migrate_cap: int = 128,
                                 c_max_loc: int | None = None):
    """Distributed advection step for ANY BlockEngine-based fluid case.

    `eng` is the case's single-device engine (global c_max); the wall
    blocks (from engine.build_wall_blocks, optional) are replicated on
    every device and passed as jit arguments, like the single-device
    scene's (large arrays as closure constants would be embedded in the
    program).  The slab
    axis is the grid's axis 0 (SlabDecomposition default); periodic
    rings are not routed through this wrapper (the ghost wrap would
    need positions outside the global grid — TG keeps its bespoke
    halo-case path).

    Semantics match the single-device default step exactly: migration +
    halo exchange per advection step, frozen-band value refresh after
    density summation/prep and around each acoustic half-step, ghost-
    masked dt reduces (pmin over the ring == the single-device reduce),
    halo/migrate/block overflow folded into the step's overflow flag.
    """
    n_dev = mesh.devices.size
    decomp = SlabDecomposition(
        grid=eng.grid, n_dev=n_dev, cutoff=eng.kernel.cutoff,
        halo_cap=halo_cap, migrate_cap=migrate_cap, halo_fields=HALO_FIELDS)
    c_max = c_max_loc or default_c_max_loc(eng, n_dev)
    eng_loc = dataclasses.replace(eng, c_max=c_max)
    all_fields = tuple(eng.fluid_fields) + ("OriginalID",)
    n_ghost = 2 * halo_cap
    big = c_max * eng.cap
    oob = (c_max + 1) * eng.cap     # out-of-bounds: drop target for scatters
    fills = dict(eng.fills)
    fills["IsGhost"] = 1.0

    def local_step(fluid, aux, wall):
        wall_b, bm_wall, wall_dense_map = wall
        idx = jax.lax.axis_index(AXIS)
        my_lo = decomp.lo + decomp.slab_width * idx
        my_hi = my_lo + decomp.slab_width
        right_edge = (idx == n_dev - 1)
        left_edge = (idx == 0)

        # ---- 1. migration in flat rows ----------------------------------
        fluid, mig_ovf = migrate_rows(fluid, decomp, my_lo, my_hi,
                                      right_edge, left_edge, all_fields)
        alive = fluid["Alive"]
        pos = fluid["Position"]
        n_loc = pos.shape[0]

        # ---- 2. frozen halo bands + initial exchange --------------------
        near_r = alive & (pos[:, 0] >= my_hi - decomp.cutoff)
        near_l = alive & (pos[:, 0] < my_lo + decomp.cutoff)
        hf = {k: fluid[k] for k in HALO_FIELDS}
        ghost_l, ghost_r, halo_ovf = band_exchange(
            hf, near_r, near_l, decomp, right_edge, left_edge)

        # combined rows: [local | ghosts-from-left | ghosts-from-right]
        comb = {}
        for k in all_fields:
            v = fluid[k]
            if k in HALO_FIELDS:
                comb[k] = jnp.concatenate([v, ghost_l[k], ghost_r[k]], axis=0)
            else:
                pad = jnp.full((n_ghost,) + v.shape[1:],
                               fills.get(k, 0.0), dtype=v.dtype)
                comb[k] = jnp.concatenate([v, pad], axis=0)
        comb["IsGhost"] = jnp.concatenate(
            [jnp.zeros((n_loc,), pos.dtype), jnp.ones((n_ghost,), pos.dtype)])
        comb_alive = jnp.concatenate([alive, ghost_l["BandAlive"] > 0.5,
                                      ghost_r["BandAlive"] > 0.5])

        # ---- 3. slot into blocks (inverse map kept for the refresh) -----
        bm = build_block_map(comb["Position"], comb_alive, eng.grid,
                             cap=eng.cap, c_max=c_max, with_inverse=True)
        fb = to_blocks_packed(bm, comb, fills)
        fb["SlotMask"] = jnp.concatenate(
            [bm.slot_mask.reshape(c_max, eng.cap),
             jnp.zeros((1, eng.cap), bool)], axis=0)
        nbr_inner = bm.nbr_block
        wc = engine.WallCtx()
        if wall_b is not None:
            wc = engine.WallCtx(wall_b, engine.wall_windows(
                eng_loc, bm, bm_wall, wall_dense_map))

        # frozen refresh maps: band rows -> their slots; ghost rows' slots
        slot = bm.particle_slot                      # (n_loc + n_ghost,)
        band_rows_r = jnp.nonzero(near_r, size=halo_cap,
                                  fill_value=n_loc + n_ghost - 1)[0]
        band_rows_l = jnp.nonzero(near_l, size=halo_cap,
                                  fill_value=n_loc + n_ghost - 1)[0]
        band_valid_r = jnp.arange(halo_cap) < jnp.sum(near_r)
        band_valid_l = jnp.arange(halo_cap) < jnp.sum(near_l)
        band_slots_r = jnp.where(band_valid_r, slot[band_rows_r], big)
        band_slots_l = jnp.where(band_valid_l, slot[band_rows_l], big)
        gslot_l = slot[n_loc:n_loc + halo_cap]       # ghosts from the LEFT
        gslot_r = slot[n_loc + halo_cap:]
        galive_l = ghost_l["BandAlive"] > 0.5
        galive_r = ghost_r["BandAlive"] > 0.5
        # route dead/overflowed slots out of bounds (mode="drop") so the
        # sentinel block row is never clobbered
        tgt_l = jnp.where(galive_l & (gslot_l < big), gslot_l, oob)
        tgt_r = jnp.where(galive_r & (gslot_r < big), gslot_r, oob)

        def refresh(fb_now):
            out = dict(fb_now)
            for k in HALO_FIELDS:
                sh = fb_now[k].shape[2:]
                flat = fb_now[k].reshape((-1,) + sh)
                vals_r = flat[jnp.minimum(band_slots_r, flat.shape[0] - 1)]
                vals_l = flat[jnp.minimum(band_slots_l, flat.shape[0] - 1)]
                # band order on the wire == the frozen compaction order
                # band_exchange used, so row j lands in ghost slot j
                recv_l = _perm_shift(vals_r, n_dev, +1, decomp.periodic)
                recv_r = _perm_shift(vals_l, n_dev, -1, decomp.periodic)
                flat = flat.at[tgt_l].set(recv_l, mode="drop")
                flat = flat.at[tgt_r].set(recv_r, mode="drop")
                out[k] = flat.reshape(fb_now[k].shape)
            return out

        mask_loc = fb["SlotMask"] & (fb["IsGhost"] < 0.5)
        fb_loc = lambda f: dict(f, SlotMask=mask_loc)  # noqa: E731

        # ---- 4. the advection step's physics (engine-generic) -----------
        dt_adv = jax.lax.pmin(engine.advection_dt(eng_loc, fb_loc(fb)), AXIS)
        fb = engine.advection_prep(eng_loc, fb, nbr_inner, wc)
        fb = refresh(fb)

        def ac_cond(carry):
            _, rt, _ = carry
            return rt < dt_adv

        def ac_body(carry):
            f, rt, k = carry
            dt = jax.lax.pmin(
                engine.acoustic_dt(eng_loc, fb_loc(f), dt_adv), AXIS)
            f = engine.acoustic_step(eng_loc, f, nbr_inner, wc, dt,
                                     between=refresh)
            f = refresh(f)
            return (f, rt + dt, k + 1)

        fb, relax_t, n_ac = jax.lax.while_loop(
            ac_cond, ac_body,
            (fb, jnp.zeros_like(dt_adv), jnp.zeros((), jnp.int32)))

        # ---- 5. flatten local rows back (one packed gather) -------------
        flat, slot_valid = from_blocks_packed(bm, fb, all_fields, n_loc)
        out = dict(fluid)
        for k in all_fields:
            out[k] = jnp.where(
                slot_valid.reshape((-1,) + (1,) * (flat[k].ndim - 1)),
                flat[k], fluid[k])
        out["Position"] = jnp.where(alive[:, None], out["Position"], FAR)
        out["Alive"] = alive
        overflow = mig_ovf | halo_ovf | bm.overflow
        return out, aux, relax_t, n_ac, overflow

    @jax.jit
    def step(sim: HaloShard, wall) -> HaloShard:
        fluid_specs = {k: P(AXIS) for k in sim.fluid}
        aux_specs = jax.tree_util.tree_map(lambda _: P(), sim.aux)
        wall_specs = jax.tree_util.tree_map(lambda _: P(), wall)
        out, aux, relax_t, n_ac, ovf = shard_map(
            local_step, mesh=mesh,
            in_specs=(fluid_specs, aux_specs, wall_specs),
            out_specs=(fluid_specs, aux_specs, P(), P(), P()),
            check_vma=False,
        )(sim.fluid, sim.aux, wall)
        return HaloShard(fluid=out, time=sim.time + relax_t,
                         n_adv=sim.n_adv + 1, n_ac=sim.n_ac + n_ac,
                         overflow=sim.overflow | ovf, aux=aux)

    wall = jax.device_put((wall_b, bm_wall, wall_dense_map),
                          NamedSharding(mesh, P()))
    return lambda sim: step(sim, wall)


def distribute_block_engine(eng, fluid: dict, mesh: Mesh,
                            n_loc: int | None = None) -> HaloShard:
    """Partition a flat fluid state into per-slab shards for
    make_distributed_engine_step (identity rides in OriginalID)."""
    from sphinxsys_jax.parallel.domain import distribute

    n_dev = mesh.devices.size
    decomp = SlabDecomposition(grid=eng.grid, n_dev=n_dev,
                               cutoff=eng.kernel.cutoff)
    st = {k: fluid[k] for k in eng.fluid_fields}
    st["OriginalID"] = jnp.arange(fluid["Position"].shape[0],
                                  dtype=jnp.int32)
    st["NReal"] = fluid.get("NReal", jnp.asarray(
        fluid["Position"].shape[0], jnp.int32))
    return distribute(st, mesh, decomp, n_loc=n_loc)
