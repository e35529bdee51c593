"""Host-side (CPU backend) evaluation of setup-time geometry.

Scene construction (lattice fills, shape normals, signed distances) is
one-shot precompute on shapes that change with every case and
resolution.  Running it on the accelerator would compile a fresh device
program for each of those shapes, so it runs on the CPU backend, which
JAX always has, and returns NumPy.
"""

from __future__ import annotations

import jax
import numpy as np


def host_eval(fn, *args):
    """Run `fn(*args)` jitted on the CPU backend; returns NumPy arrays.
    Committing the inputs to the CPU device places the computation there."""
    cpu = jax.devices("cpu")[0]
    args = tuple(jax.device_put(np.asarray(a), cpu) if hasattr(a, "shape")
                 else a for a in args)
    out = jax.jit(fn)(*args)
    return jax.tree_util.tree_map(np.asarray, out)
