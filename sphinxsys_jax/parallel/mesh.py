"""Device-mesh sharding of particle state (SPH "sequence parallelism").

The reference is single-node/single-accelerator (SURVEY.md §2.1: no MPI, no
multi-GPU); scale-out is net-new design (SURVEY.md §5 "long-context /
sequence parallelism"): the Morton-sorted particle axis is sharded over the
device mesh, the global CFL reduces become psums, and neighbor gathers
across shard boundaries become XLA-inserted collectives over ICI.

Round-1 implementation: GSPMD-style — annotate the particle axis of every
(N, ...) array with NamedSharding(P("p")) and jit the unchanged single-chip
step functions over the mesh; XLA propagates shardings and inserts the
halo communication (all-gathers for the cell-window gathers).  A
shard_map + ppermute halo-exchange fast path comes next.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

PARTICLE_AXIS = "p"


def make_particle_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1D mesh over the particle axis."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (PARTICLE_AXIS,))


def particle_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P(PARTICLE_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_state(state: dict, mesh: Mesh) -> dict:
    """Place a particle-state dict on the mesh: (N, ...) arrays sharded
    along the particle axis, scalars replicated.  Capacities must be a
    multiple of the mesh size (pad via make_*_state(capacity=...))."""
    n_dev = mesh.devices.size
    sharded = {}
    for k, v in state.items():
        if getattr(v, "ndim", 0) >= 1 and v.shape[0] % n_dev == 0:
            sharded[k] = jax.device_put(v, particle_sharding(mesh))
        else:
            sharded[k] = jax.device_put(v, replicated(mesh))
    return sharded


def shard_pytree_leaves(tree: Any, mesh: Mesh, axis_size: int) -> Any:
    """Shard every leaf whose leading dim is divisible by the mesh size."""
    n_dev = mesh.devices.size

    def place(v):
        if getattr(v, "ndim", 0) >= 1 and v.shape[0] % n_dev == 0 and v.shape[0] >= n_dev:
            return jax.device_put(v, particle_sharding(mesh))
        return jax.device_put(v, replicated(mesh))

    return jax.tree_util.tree_map(place, tree)


def round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple
