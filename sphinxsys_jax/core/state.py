"""Particle state: string-keyed SoA pytrees of device arrays.

Counterpart of the reference's `BaseParticles` variable registry
(/root/reference/src/shared/particles/base_particles.h:80,119-147) and the
`DiscreteVariable` memory model (common/sphinxsys_variable.h:197).  Under
jit there is no host/device mirror to manage: a body's state is a plain dict
``{variable_name: jnp.ndarray}`` (a pytree), transformed by pure functions
and jit.  Variable names follow the reference exactly (SURVEY.md App. A) so
observers / restart files / regression data stay compatible:

    Position (N,dim)  VolumetricMeasure (N,)  Density (N,)  Mass (N,)
    Velocity (N,dim)  Pressure (N,)  DensityChangeRate (N,)  Force (N,dim)
    ForcePrior (N,dim) ...

Fixed capacity replaces the reference's real/buffer/ghost particle groups
(base_particles.h:55-79): arrays are padded to a static capacity, and a
validity mask (index < n_real) plays the role of the
``total_real_particles_`` boundary.  `n_real` is stored in the dict under
the reserved key "NReal" (an int32 scalar) so it can change under jit
(particle injection/deletion) while shapes stay static.
"""

from __future__ import annotations

from typing import Dict

import jax.numpy as jnp
import numpy as np

State = Dict[str, jnp.ndarray]

N_REAL = "NReal"  # reserved key: int32 scalar, number of real particles
FAR_AWAY = 1.0e16  # padding particles parked far outside any domain


def capacity_of(state: State) -> int:
    return state["Position"].shape[0]


def dim_of(state: State) -> int:
    return state["Position"].shape[1]


def valid_mask(state: State) -> jnp.ndarray:
    """(N,) bool — True for real particles.  Open-boundary bodies carry an
    explicit "Alive" mask (physics/boundary.py); otherwise validity is the
    index < NReal prefix."""
    if "Alive" in state:
        return state["Alive"]
    n = capacity_of(state)
    return jnp.arange(n) < state[N_REAL]


def _pad(arr: np.ndarray, capacity: int, fill: float = 0.0) -> np.ndarray:
    n = arr.shape[0]
    if n > capacity:
        raise ValueError(f"capacity {capacity} < number of particles {n}")
    pad_width = [(0, capacity - n)] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad_width, constant_values=fill)


def make_base_state(pos: np.ndarray, volume, rho0: float, capacity: int | None = None,
                    dtype=jnp.float32) -> State:
    """Register the basic variables every body has
    (base_particles.cpp:31-44 + base_material.cpp:37-40):
    Position, VolumetricMeasure, Density, Mass."""
    pos = np.asarray(pos)
    n, dim = pos.shape
    capacity = capacity or n
    vol = np.broadcast_to(np.asarray(volume, dtype=np.float64), (n,)).copy()
    # padding rows get safe non-zero Mass/Density/Vol so derived quantities
    # (v += F/m dt, p = EoS(rho), ...) stay finite; they are excluded from
    # every neighbor table, gather and reduction via NReal masking.
    state: State = {
        "Position": jnp.asarray(_pad(pos, capacity, FAR_AWAY), dtype=dtype),
        "VolumetricMeasure": jnp.asarray(_pad(vol, capacity, 1.0), dtype=dtype),
        "Density": jnp.asarray(_pad(np.full(n, rho0), capacity, rho0), dtype=dtype),
        "Mass": jnp.asarray(_pad(rho0 * vol, capacity, 1.0), dtype=dtype),
        N_REAL: jnp.asarray(n, dtype=jnp.int32),
    }
    return state


def make_fluid_state(pos: np.ndarray, volume, rho0: float, capacity: int | None = None,
                     dtype=jnp.float32) -> State:
    """Fluid body state: base + the variables registered by the WCSPH
    integration ops (fluid_integration.hpp:12-23)."""
    state = make_base_state(pos, volume, rho0, capacity, dtype)
    cap = capacity_of(state)
    dim = dim_of(state)
    zeros_v = jnp.zeros((cap, dim), dtype=dtype)
    zeros_s = jnp.zeros((cap,), dtype=dtype)
    state.update({
        "Velocity": zeros_v,
        "Force": zeros_v,
        "ForcePrior": zeros_v,
        "Pressure": zeros_s,
        "DensityChangeRate": zeros_s,
        "DensitySummation": zeros_s,
    })
    return state


def make_solid_state(pos: np.ndarray, volume, rho0: float, capacity: int | None = None,
                     dtype=jnp.float32) -> State:
    """Wall/solid body state: base + normals and the FSI averaged wall
    kinematics the fluid wall BC reads (solid_dynamics/
    fluid_structure_interaction.h:112-130; zero for static walls)."""
    state = make_base_state(pos, volume, rho0, capacity, dtype)
    cap = capacity_of(state)
    dim = dim_of(state)
    zeros_v = jnp.zeros((cap, dim), dtype=dtype)
    state.update({
        "Velocity": zeros_v,
        "NormalDirection": zeros_v,
        "AverageVelocity": zeros_v,
        "AverageAcceleration": zeros_v,
    })
    return state
