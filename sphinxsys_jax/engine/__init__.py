"""Case-agnostic cell-block execution engine (the fluid fast path)."""

from sphinxsys_jax.engine.block_fluid import (  # noqa: F401
    BlockEngine, WallCtx, slot_fluid, build_wall_blocks, wall_windows,
    advection_prep, acoustic_step, blocks_to_particles,
)
