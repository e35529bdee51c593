"""Failure detection: dump state to VTP when the solution explodes.

Counterpart of the reference's WriteToVtpIfVelocityOutOfBound
(/root/reference/src/shared/io_system/io_vtk.h:116-134 and io_vtk.cpp):
a checkable IO object that scans a body's velocity magnitudes against a
bound and, on first violation, writes the offending body states to disk
so the blow-up configuration can be inspected.

XLA-native shape: the check is a single masked reduce over the state
arrays (one device->host scalar per call); the dump itself runs on host
through the standard VTP writer.
"""

from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np

from sphinxsys_jax.io.vtk import write_vtp


class WriteToVtpIfVelocityOutOfBound:
    """Check velocity bounds; dump every registered body on first failure.

    Usage (mirrors io_vtk.h:116-134):
        check = WriteToVtpIfVelocityOutOfBound(out_dir, bound=20.0)
        ...
        if check({"WaterBody": fluid, "Beam": solid}, time=t):
            raise RuntimeError("velocity out of bound; state dumped")
    """

    def __init__(self, output_dir: str, bound: float,
                 variables=("Velocity", "Pressure", "Density")):
        self.output_dir = output_dir
        self.bound = float(bound)
        self.variables = tuple(variables)
        self.out_of_bound = False

    def _body_exceeds(self, state: dict) -> bool:
        vel = state["Velocity"]
        n = vel.shape[0]
        nreal = state.get("NReal", n)
        valid = jnp.arange(n) < nreal
        if "Alive" in state:
            valid = valid & (state["Alive"] > 0)
        v2 = jnp.sum(vel * vel, axis=-1)
        vmax2 = jnp.max(jnp.where(valid, v2, 0.0))
        return bool(vmax2 > self.bound * self.bound)

    def __call__(self, bodies: dict, time: float = 0.0) -> bool:
        """Returns True (and writes one VTP per body) if any body has a
        particle beyond the velocity bound.  Idempotent after failure."""
        if self.out_of_bound:
            return True
        if not any(self._body_exceeds(s) for s in bodies.values()):
            return False
        self.out_of_bound = True
        os.makedirs(self.output_dir, exist_ok=True)
        for name, state in bodies.items():
            variables = [v for v in self.variables if v in state]
            path = os.path.join(
                self.output_dir, f"{name}_velocity_out_of_bound_{time:.6f}.vtp")
            write_vtp(path, {k: np.asarray(v) for k, v in state.items()
                             if hasattr(v, "shape")}, variables)
        return True
