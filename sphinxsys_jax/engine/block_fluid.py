"""Case-agnostic cell-block WCSPH engine — the fast path for every
fluid case bound to it, not just the dambreak benchmark.

The reference's CK stack gives every wired physics op a device twin
(src/shared/shared_ck/particle_dynamics/fluid_dynamics/); here the
cell-block layout (neighbors/cell_blocks.py) and the block-form sweeps
(physics/fluid_blocks.py) play that role, and this module is the
case-agnostic glue:

  * `BlockEngine` — the static configuration (grid, kernel, EoS, Riemann
    solvers, viscosity, transport-velocity correction, periodicity,
    block capacities);
  * `slot_fluid` — (re-)slot flat particle fields into fresh cell blocks;
  * `build_wall_blocks` / `wall_windows` — wall-type contact bodies
    (static walls, or moving solids seen as walls à la FSI);
  * `advection_prep` — density summation (+ viscous force + TVC);
  * `acoustic_step` — the two half-step pressure/density relaxations.

Cases compose these into their own advection step (inflow conditions,
FSI sub-cycling etc. slot between the pieces) through engine/scene.py.

Periodic domains: the grid's periodic axes drive minimum-image wrapping
in the sweeps; padding slots are parked FAR *and* carry
VolumetricMeasure = 0 (every pair term is proportional to dW*V_j, which
keeps padding inert even when the wrap folds FAR positions back into
range).
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

from sphinxsys_jax.core.state import FAR_AWAY
from sphinxsys_jax.neighbors.cell_blocks import (
    build_block_map, cross_neighbor_blocks, dense_cell_map, to_blocks,
    to_blocks_packed,
)
from sphinxsys_jax.physics import fluid_blocks as fbops

# block-field fill values for padding slots: Vol = 0 keeps padding inert
# under periodic minimum-image wrap (see module docstring)
BASE_FILLS = {"Position": FAR_AWAY, "Mass": 1.0, "VolumetricMeasure": 0.0}

FLUID_FIELDS = ("Position", "Velocity", "Density", "Mass",
                "VolumetricMeasure", "Pressure", "DensityChangeRate",
                "Force", "ForcePrior", "DensitySummation")

WALL_FIELDS = ("Position", "VolumetricMeasure", "AverageVelocity",
               "AverageAcceleration", "NormalDirection")


class WallCtx(NamedTuple):
    """Wall-type contact bodies as the fluid sweeps see them."""

    wall_b: Any = None    # block state dict (None: no wall)
    nbr_wall: Any = None  # (C_fluid, 3^dim) int32 window block rows


@dataclasses.dataclass(frozen=True)
class BlockEngine:
    """Static engine configuration (hashable: closed over by jitted fns)."""

    grid: Any                 # CellGrid (shared by fluid and wall bodies)
    kernel: Any
    eos: Any
    riemann1: Any             # 1st-half (pressure) Riemann solver
    riemann2: Any             # 2nd-half (density) Riemann solver
    rho0: float
    sigma0: float
    h: float
    speed_ref: float
    dim: int = 2
    mu: float = 0.0           # Newtonian viscosity (0 = no viscous force)
    tvc_coef: float = 0.0     # transport-velocity correction (0 = off)
    tvc_limiter: float | None = None
    free_surface: bool = True
    cap: int = 12
    c_max: int = 0            # occupied-cell capacity
    cap_ac_dt: bool = True    # cap acoustic dt by the advection dt

    @property
    def box(self):
        return self.grid.periodic_lengths

    @property
    def fluid_fields(self):
        return FLUID_FIELDS + (("ViscousForcePrev",) if self.mu > 0.0 else ())

    @property
    def fills(self):
        f = dict(BASE_FILLS)
        f["Density"] = self.rho0
        f["OriginalID"] = jnp.iinfo(jnp.int32).max
        return f


def _slot_mask_2d(bm):
    m = bm.slot_mask.reshape(bm.c_max, bm.cap)
    return jnp.concatenate([m, jnp.zeros((1, bm.cap), dtype=bool)], axis=0)


def slot_fluid(eng: BlockEngine, flat: dict, valid, n_max: int | None = None):
    """(Re-)slot flat per-particle/per-slot arrays into fresh blocks.
    Returns (fb, bm): the block state (with SlotMask) and the BlockMap
    (its occ_cells feed wall window maps and solid->fluid lookups).
    Pass n_max = the particle capacity when re-slotting slot arrays
    (2-3x larger than the particle count) — it bounds the post-sort work.

    The field columns are packed into one carry that follows the block
    map's key-value sort with a single row gather; the blocks form by
    per-block-row chunk gathers (cell_blocks.build_block_map carry
    path)."""
    fdtype = flat["Position"].dtype
    cols, meta = [], []
    for k, v in flat.items():
        if v.ndim == 1:
            cols.append(v.astype(fdtype))
            meta.append((k, None, v.dtype))
        else:
            for d in range(v.shape[1]):
                cols.append(v[:, d].astype(fdtype))
                meta.append((k, d, v.dtype))
    carry = jnp.stack(cols, axis=-1)
    bm, blocks = build_block_map(flat["Position"], valid, eng.grid,
                                 cap=eng.cap, c_max=eng.c_max, n_max=n_max,
                                 with_inverse=False, carry=carry)
    mask2 = bm.slot_mask.reshape(eng.c_max, eng.cap)
    fills = eng.fills
    fb = {}
    comp = {}
    for j, (k, d, dt) in enumerate(meta):
        col = blocks[..., j]
        if d is None:
            fill = fills.get(k, 0.0)
            fill = 0 if k == "OriginalID" else fill
            col = jnp.where(mask2, col, jnp.asarray(fill, fdtype))
            if k == "OriginalID":
                col = col.astype(dt)
                col = jnp.where(mask2, col, jnp.iinfo(jnp.int32).max)
            else:
                col = col.astype(dt)
            fb[k] = jnp.concatenate(
                [col, jnp.full((1, eng.cap), fills.get(k, 0.0), dt)
                 if k != "OriginalID" else
                 jnp.full((1, eng.cap), jnp.iinfo(jnp.int32).max, dt)],
                axis=0)
        else:
            comp.setdefault(k, {})[d] = col
    for k, dcols in comp.items():
        dim = len(dcols)
        fill = fills.get(k, 0.0)
        arr = jnp.stack([dcols[d] for d in range(dim)], axis=-1)
        arr = jnp.where(mask2[..., None], arr, jnp.asarray(fill, fdtype))
        arr = arr.astype(flat[k].dtype)
        sent = jnp.full((1, eng.cap, dim), fill, flat[k].dtype)
        fb[k] = jnp.concatenate([arr, sent], axis=0)
    fb["SlotMask"] = _slot_mask_2d(bm)
    return fb, bm


def build_wall_blocks(eng: BlockEngine, wall_state: dict, c_max_wall: int,
                      fields=WALL_FIELDS, valid=None):
    """Slot a wall-type contact body into blocks on the engine grid.
    Returns (wall_b, bm_wall, dense_map).  For moving wall-type bodies
    (FSI solids) call this per advection step and `refresh_wall_blocks`
    per acoustic iteration."""
    n = wall_state["Position"].shape[0]
    if valid is None:
        valid = jnp.arange(n) < wall_state.get("NReal", n)
    bm = build_block_map(wall_state["Position"], valid, eng.grid,
                         cap=eng.cap, c_max=c_max_wall)
    wall_b = {k: to_blocks(bm, wall_state[k], fill=BASE_FILLS.get(k, 0.0))
              for k in fields if k in wall_state}
    wall_b["SlotMask"] = _slot_mask_2d(bm)
    dm = dense_cell_map(bm.occ_cells, eng.grid.ncells, bm.c_max)
    return wall_b, bm, dm


def refresh_wall_blocks(eng: BlockEngine, bm_wall, wall_state: dict,
                        wall_b: dict, fields=("Position", "AverageVelocity",
                                              "AverageAcceleration",
                                              "NormalDirection")):
    """Re-gather updated per-particle wall channels into the FIXED slots of
    an existing wall block map (moving FSI solids: slots freeze per
    advection step, kinematics change per acoustic iteration)."""
    out = dict(wall_b)
    for k in fields:
        if k in wall_state:
            out[k] = to_blocks(bm_wall, wall_state[k],
                               fill=BASE_FILLS.get(k, 0.0))
    return out


def wall_windows(eng: BlockEngine, bm_fluid, bm_wall, wall_dense_map):
    """(C_fluid, 3^dim) window block rows into the wall body's blocks."""
    return cross_neighbor_blocks(bm_fluid.occ_cells, eng.grid, bm_wall,
                                 src_dense_map=wall_dense_map)


def _jnp_walls(wc: WallCtx):
    return [(wc.wall_b, wc.nbr_wall)] if wc.wall_b is not None else []


def advection_prep(eng: BlockEngine, fb, nbr_inner, wc: WallCtx):
    """Density summation (+ viscous force + transport-velocity correction
    as configured) — the per-advection-step prep stage of the reference's
    dual-criteria loop (SURVEY.md §3.2)."""
    contacts = []
    if wc.wall_b is not None:
        # wall contact via the V = m/rho0 identity: sum W V0_k equals the
        # reference's sum W m_k/rho0_k for any per-body rho0 (so merged
        # wall+solid contact bodies work with one term)
        proxy = {"Position": wc.wall_b["Position"],
                 "Mass": wc.wall_b["VolumetricMeasure"],
                 "SlotMask": wc.wall_b["SlotMask"]}
        contacts = [(proxy, wc.nbr_wall, 1.0)]
    fb = fbops.density_summation_b(fb, nbr_inner, eng.kernel, eng.dim,
                                   eng.rho0, eng.sigma0, contacts=contacts,
                                   free_surface=eng.free_surface, box=eng.box)
    walls = _jnp_walls(wc)
    if eng.mu > 0.0:
        fb = fbops.viscous_force_b(fb, nbr_inner, eng.kernel, eng.dim, eng.mu,
                                   eng.h, walls=walls, box=eng.box)
    if eng.tvc_coef > 0.0:
        fb = fbops.transport_velocity_correction_b(
            fb, nbr_inner, eng.kernel, eng.dim, eng.h,
            coefficient=eng.tvc_coef, limiter_slope=eng.tvc_limiter,
            walls=walls, box=eng.box)
    return fb


def advection_dt(eng: BlockEngine, fb):
    if eng.mu > 0.0:
        return fbops.advection_viscous_time_step_b(fb, eng.h, eng.speed_ref,
                                                   eng.rho0, eng.mu)
    return fbops.advection_time_step_b(fb, eng.h, eng.speed_ref)


def acoustic_dt(eng: BlockEngine, fb, dt_adv=None):
    dt = fbops.acoustic_time_step_b(fb, eng.eos, eng.h)
    if eng.cap_ac_dt and dt_adv is not None:
        dt = jnp.minimum(dt, dt_adv)
    return dt


def acoustic_step(eng: BlockEngine, fb, nbr_inner, wc: WallCtx, dt,
                  between=None):
    """Both half-steps of the pressure/density relaxation
    (fluid_integration.hpp; physics/fluid_blocks.py for the math).
    `between` (optional, fb -> fb) runs between the halves — the
    distributed wrapper re-exchanges ghost values there (the 2nd half
    reads the 1st half's velocities)."""
    fb = acoustic_first_half(eng, fb, nbr_inner, wc, dt)
    if between is not None:
        fb = between(fb)
    return acoustic_second_half(eng, fb, nbr_inner, wc, dt)


def acoustic_first_half(eng: BlockEngine, fb, nbr_inner, wc: WallCtx, dt):
    """1st half only (pressure relaxation) — for loops that couple other
    bodies between the halves (FSI)."""
    return fbops.acoustic_step_1st_half_b(
        fb, nbr_inner, eng.kernel, eng.dim, eng.eos, eng.riemann1, dt,
        wall_b=wc.wall_b, nbr_wall=wc.nbr_wall, box=eng.box)


def acoustic_second_half(eng: BlockEngine, fb, nbr_inner, wc: WallCtx, dt):
    return fbops.acoustic_step_2nd_half_b(
        fb, nbr_inner, eng.kernel, eng.dim, eng.riemann2, dt,
        wall_b=wc.wall_b, nbr_wall=wc.nbr_wall, box=eng.box)


def blocks_to_particles(eng: BlockEngine, fb, n: int, fields=None) -> dict:
    """Recover per-particle arrays (by OriginalID) for IO/observation."""
    fields = fields or eng.fluid_fields
    ids = fb["OriginalID"].reshape(-1)
    mask = fb["SlotMask"].reshape(-1)
    tgt = jnp.where(mask, jnp.minimum(ids, n - 1), n)
    out = {}
    for k in fields:
        flat = fb[k].reshape((-1,) + fb[k].shape[2:])
        arr = jnp.zeros((n + 1,) + flat.shape[1:], dtype=flat.dtype)
        arr = arr.at[tgt].set(flat, mode="drop")
        out[k] = arr[:n]
    out["NReal"] = jnp.asarray(n, jnp.int32)
    return out


def round_to(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m
