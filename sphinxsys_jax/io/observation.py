"""Observation: kernel interpolation of fields at probe points.

Counterpart of /root/reference/src/shared/particle_dynamics/general_dynamics/
general_interpolation.h:63-84 (ObservingAQuantity — Shepard-normalized
kernel interpolation through a contact relation) and
io_system/io_observation.h:57-129 (ObservedQuantityRecording /
ReducedQuantityRecording .dat appenders).
"""

from __future__ import annotations

import jax.numpy as jnp

from sphinxsys_jax.neighbors.neighbor_list import NeighborList, gather
from sphinxsys_jax.physics.pair import pair_geometry

TINY = 1.0e-15


def observe_quantity(obs_pos, src_state, quantity: str, nl: NeighborList,
                     kernel, dim: int):
    """Shepard interpolation of `quantity` at observer positions:
    q_obs = sum_j q_j W_ij V_j / (sum_j W_ij V_j + tiny)."""
    pg = pair_geometry(obs_pos, src_state["Position"], nl, kernel, dim, need_dW=False)
    vol_j, _ = gather(src_state["VolumetricMeasure"], nl.idx)
    data_j, _ = gather(src_state[quantity], nl.idx)
    weight = pg.W * vol_j
    if data_j.ndim == 3:  # vector quantity
        num = jnp.sum(weight[..., None] * data_j, axis=1)
    else:
        num = jnp.sum(weight * data_j, axis=1)
    den = jnp.sum(weight, axis=1) + TINY
    return num / (den[:, None] if data_j.ndim == 3 else den)


class RecordedSeries:
    """Simple host-side time-series recorder (the .dat writer role of
    ObservedQuantityRecording); rows = (time, values...)."""

    def __init__(self, name: str):
        self.name = name
        self.times: list[float] = []
        self.values: list = []

    def append(self, t: float, value):
        import numpy as np

        self.times.append(float(t))
        self.values.append(np.asarray(value).copy())

    def asarray(self):
        import numpy as np

        return np.asarray(self.times), np.asarray(self.values)

    def write_dat(self, path: str, quantity_name: str | None = None):
        """Write in the reference's .dat layout: run_time then columns."""
        import numpy as np

        t, v = self.asarray()
        v2 = v.reshape(len(t), -1)
        header = "run_time\t" + "\t".join(
            f"{quantity_name or self.name}[{i}]" for i in range(v2.shape[1]))
        np.savetxt(path, np.column_stack([t, v2]), header=header, delimiter="\t")
