"""Open-boundary particle recycling: emitters and disposers.

Counterpart of /root/reference/src/shared/particle_dynamics/fluid_dynamics/
boundary_condition/fluid_boundary.h:48-246 (EmitterInflowInjection — buffer
particles crossing the emitter plane respawn upstream and a reserve
particle is activated; DisposerOutflowDeletion — particles leaving the
domain are recycled into the reserve).

XLA-native formulation (SURVEY.md §7 stage 5): arrays have fixed capacity
and an explicit "Alive" (N,) bool mask replaces the reference's
real/buffer index juggling (base_particles.h:55-79).  Injection/deletion
are pure deterministic mask/scatter updates:

  * deletion: alive &= not in disposer region (dead slots are parked FAR)
  * injection: particles crossing the emitter's downstream plane are
    translated back by the emitter length (periodic-like recycling of the
    SAME slot), and a clone is activated in a dead slot at the particle's
    pre-wrap position, inheriting its state — matching the reference's
    "spawn a real particle from the buffer" semantics.

All neighbor builders accept the Alive mask directly
(build_cell_table/build_neighbor_list/build_block_map).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax.numpy as jnp

from sphinxsys_jax.core.state import State, FAR_AWAY

_PARTICLE_FIELDS_HINT = ("Position", "Velocity", "Density", "Mass",
                         "VolumetricMeasure", "Pressure", "DensityChangeRate",
                         "Force", "ForcePrior", "DensitySummation")


@dataclasses.dataclass(frozen=True)
class AlignedBoxRegion:
    """Axis-aligned box region with a designated flow axis
    (BodyAlignedBoxByParticle / OrientedBoxByCell analog)."""

    lower: Tuple[float, ...]
    upper: Tuple[float, ...]
    axis: int = 0

    def contains(self, pos):
        lo = jnp.asarray(self.lower, dtype=pos.dtype)
        hi = jnp.asarray(self.upper, dtype=pos.dtype)
        return jnp.all((pos >= lo) & (pos <= hi), axis=-1)


def ensure_alive_mask(state: State) -> State:
    """Convert an NReal-prefix state to explicit Alive masking."""
    if "Alive" in state:
        return state
    out = dict(state)
    n = state["Position"].shape[0]
    out["Alive"] = jnp.arange(n) < state["NReal"]
    return out


def disposer_outflow_deletion(state: State, region: AlignedBoxRegion) -> State:
    """Deactivate particles inside the disposer region
    (DisposerOutflowDeletion)."""
    out = ensure_alive_mask(state)
    pos = out["Position"]
    gone = out["Alive"] & region.contains(pos)
    out["Alive"] = out["Alive"] & ~gone
    out["Position"] = jnp.where(gone[:, None], FAR_AWAY, pos)
    return out


def emitter_inflow_injection(state: State, region: AlignedBoxRegion,
                             fields=_PARTICLE_FIELDS_HINT,
                             prev_pos=None,
                             crossing_band: float | None = None) -> State:
    """EmitterInflowInjection: emitter-region particles whose `axis`
    coordinate just crossed the emitter's downstream plane are recycled
    back by the emitter length, and a clone of their pre-wrap state is
    activated in a dead slot (the new "real" particle entering the domain).

    "Just crossed" means prev_pos <= plane < pos when `prev_pos` (the
    positions before this step's advection) is given — pass it whenever
    available, otherwise a particle sitting in the `crossing_band` past
    the plane (default band: half the emitter length) respawns every call.
    (The reference restricts the check to the emitter body part instead,
    fluid_boundary.h BodyAlignedBoxByParticle.)"""
    out = ensure_alive_mask(state)
    pos = out["Position"]
    alive = out["Alive"]
    axis = region.axis
    hi = region.upper[axis]
    lo = region.lower[axis]
    length = hi - lo
    band = crossing_band if crossing_band is not None else 0.5 * length

    # transverse containment in the emitter box
    lo_v = jnp.asarray(region.lower, dtype=pos.dtype)
    hi_v = jnp.asarray(region.upper, dtype=pos.dtype)
    transverse = jnp.ones(pos.shape[0], dtype=bool)
    for d in range(pos.shape[1]):
        if d != axis:
            transverse &= (pos[:, d] >= lo_v[d]) & (pos[:, d] <= hi_v[d])

    crossed = alive & transverse & (pos[:, axis] > hi)
    if prev_pos is not None:
        crossed &= prev_pos[:, axis] <= hi
    else:
        crossed &= pos[:, axis] <= hi + band
    n = pos.shape[0]

    # allocate dead slots for the clones, deterministically (rank of each
    # crossing particle -> rank-th dead slot)
    dead_rank = jnp.cumsum(~alive) - 1            # rank among dead slots
    cross_rank = jnp.cumsum(crossed) - 1          # rank among crossers
    n_dead = jnp.sum(~alive)
    can_clone = crossed & (cross_rank < n_dead)
    # target dead slot index for each crossing particle
    dead_slots = jnp.nonzero(~alive, size=n, fill_value=n - 1)[0]
    tgt = jnp.where(can_clone, dead_slots[jnp.minimum(cross_rank, n - 1)], n)

    for k in fields:
        if k not in out:
            continue
        src = out[k]
        out[k] = out[k].at[tgt].set(src[jnp.arange(n)], mode="drop")
    out["Alive"] = out["Alive"].at[tgt].set(True, mode="drop")

    # wrap the original crossers back to the emitter inlet
    out["Position"] = out["Position"].at[:, axis].add(
        jnp.where(crossed, -length, 0.0))
    overflow = jnp.sum(crossed) > n_dead
    out["_InjectionOverflow"] = out.get(
        "_InjectionOverflow", jnp.zeros((), bool)) | overflow
    return out


def bidirectional_buffer_exchange(state: State, region: AlignedBoxRegion,
                                  inward: int = +1,
                                  fields=_PARTICLE_FIELDS_HINT,
                                  prev_pos=None) -> State:
    """BidirectionalBuffer (extra_src/shared/pressure_boundary/
    bidirectional_buffer.h, used by the pulsatile-poiseuille / vessel
    pressure-BC cases): one buffer at a domain end that supports flow in
    EITHER direction.

      * a particle crossing the buffer's INNER plane into the bulk keeps
        going, and a clone respawns one buffer length behind it
        (replenishing the buffer — the reference's particle creation);
      * a particle crossing the OUTER plane (leaving the domain) is
        deleted into the reserve.

    ``inward`` = +1 when the bulk lies toward +axis of the buffer (a
    left/inlet buffer), -1 when toward -axis (a right/outlet buffer).
    Pass ``prev_pos`` (positions before this step's advection) for exact
    crossing detection."""
    axis = region.axis
    out = ensure_alive_mask(state)

    # deletion at the outer plane
    pos = out["Position"]
    outer = pos[:, axis] < region.lower[axis] if inward > 0 \
        else pos[:, axis] > region.upper[axis]
    lo_v = jnp.asarray(region.lower, dtype=pos.dtype)
    hi_v = jnp.asarray(region.upper, dtype=pos.dtype)
    transverse = jnp.ones(pos.shape[0], dtype=bool)
    for d in range(pos.shape[1]):
        if d != axis:
            transverse &= (pos[:, d] >= lo_v[d]) & (pos[:, d] <= hi_v[d])
    # deletion checks only the axial plane (bidirectional_buffer.h:157-169
    # Deletion: axial bound + buffer tag) — NOT transverse containment, so a
    # particle leaking past a corner slightly outside the transverse band is
    # still removed rather than lingering outside the domain forever
    gone = out["Alive"] & outer
    out["Alive"] = out["Alive"] & ~gone
    out["Position"] = jnp.where(gone[:, None], FAR_AWAY, out["Position"])

    # injection at the inner plane
    pos = out["Position"]
    alive = out["Alive"]
    length = region.upper[axis] - region.lower[axis]
    # a crosser must have been a BUFFER RESIDENT the previous step (the
    # reference's buffer_indicator == part_id tag, bidirectional_buffer.h:
    # 110-112).  Without the residency bound, a slot recycled this step for
    # a fresh clone still carries its stale prev position (often FAR_AWAY),
    # which can satisfy the bare one-sided prev test of the OTHER buffer
    # and duplicate the clone there every cycle.
    if inward > 0:
        plane = region.upper[axis]
        crossed = alive & transverse & (pos[:, axis] > plane)
        if prev_pos is not None:
            crossed &= (prev_pos[:, axis] <= plane) \
                & (prev_pos[:, axis] >= region.lower[axis])
        shift = -length
    else:
        plane = region.lower[axis]
        crossed = alive & transverse & (pos[:, axis] < plane)
        if prev_pos is not None:
            crossed &= (prev_pos[:, axis] >= plane) \
                & (prev_pos[:, axis] <= region.upper[axis])
        shift = length

    n = pos.shape[0]
    cross_rank = jnp.cumsum(crossed) - 1
    n_dead = jnp.sum(~alive)
    can_clone = crossed & (cross_rank < n_dead)
    dead_slots = jnp.nonzero(~alive, size=n, fill_value=n - 1)[0]
    tgt = jnp.where(can_clone, dead_slots[jnp.minimum(cross_rank, n - 1)], n)
    for k in fields:
        if k not in out:
            continue
        out[k] = out[k].at[tgt].set(out[k][jnp.arange(n)], mode="drop")
    out["Alive"] = out["Alive"].at[tgt].set(True, mode="drop")
    # the clone (not the crosser) is shifted back into the buffer
    out["Position"] = out["Position"].at[tgt, axis].add(
        jnp.full((n,), shift, pos.dtype), mode="drop")
    overflow = jnp.sum(crossed) > n_dead
    out["_InjectionOverflow"] = out.get(
        "_InjectionOverflow", jnp.zeros((), bool)) | overflow
    return out
