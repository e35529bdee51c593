"""sphinxsys_jax — a JAX smoothed-particle-hydrodynamics framework.

A from-scratch JAX/XLA re-design of the capabilities of SPHinXsys
(weakly-compressible SPH fluids, total-Lagrangian solids, shells, contact,
FSI, diffusion/reaction, ...) built for XLA's compilation model: SoA state pytrees,
count-sort cell tables, fixed-capacity neighbor tensors, pure-functional
scatter/gather pair loops, and pjit sharding for scale-out.

Reference capability map: see SURVEY.md at the repo root.
"""

__version__ = "0.1.0"

from sphinxsys_jax.core import kernels, materials, geometry, adaptation
from sphinxsys_jax.core.state import make_fluid_state, make_solid_state

__all__ = [
    "kernels",
    "materials",
    "geometry",
    "adaptation",
    "make_fluid_state",
    "make_solid_state",
]
