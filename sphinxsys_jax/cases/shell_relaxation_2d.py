"""Shell (thick-structure) particle relaxation of a 2D thin pipe.

Counterpart of /root/reference/tests/2d_examples/
test_2d_shell_particle_relaxation/test_2d_shell_particle_relaxation.cpp:
an annulus of inner radius 24.5 and thickness 1.0 at dx = 0.5 is filled
with surface-lattice particles, relaxed for 2000 ShellRelaxationStep
iterations onto the mid-surface (radius 25.0), and given consistent normal
directions by ShellNormalDirectionPrediction.

The reference case has no regression DB; the oracle is analytic:
particles land on the mid circle |r - 25| << dx, arc spacing is uniform,
and the predicted normals are radial with one consistent global sign.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

import sphinxsys_jax.core.geometry as G
from sphinxsys_jax.core.adaptation import SPHAdaptation
from sphinxsys_jax.core.generators import generate_surface_lattice
from sphinxsys_jax.meshes.levelset import build_levelset
from sphinxsys_jax.neighbors.cell_list import CellGrid
from sphinxsys_jax.physics.relax_shell import (shell_relax,
                                               shell_normal_prediction)

RADIUS = 24.5          # inner radius
THICKNESS = 1.0
R_MID = RADIUS + 0.5 * THICKNESS
DX = 0.5
# the reference refines the level set by dx / (0.1 * thickness) = 5x
LS_SPACING = DX / (DX / (0.1 * THICKNESS))


def build_case(dx: float = DX):
    pipe = G.make_complex(
        ("add", G.Ball(center=(0.0, 0.0), radius=RADIUS + THICKNESS)),
        ("sub", G.Ball(center=(0.0, 0.0), radius=RADIUS)))
    pad = 4 * dx
    lo = np.array([-RADIUS - THICKNESS - pad] * 2)
    hi = np.array([RADIUS + THICKNESS + pad] * 2)
    levelset = build_levelset(pipe, lo, hi, LS_SPACING, dtype=jnp.float64)
    pos0, _, area = generate_surface_lattice(pipe, lo, hi, dx, THICKNESS)
    adaptation = SPHAdaptation(spacing=dx, dim=2)
    cell = adaptation.cutoff
    nc = tuple(int(np.ceil((hi[d] - lo[d]) / cell)) + 1 for d in range(2))
    grid = CellGrid(lower=tuple(lo), spacing=(cell, cell), shape=nc)
    return pipe, levelset, pos0, area, adaptation, grid


def run_case(n_iterations: int = 2000, dx: float = DX, seed: int = 0):
    """Returns (relaxed positions, predicted normals, flood-fill-complete
    flag)."""
    _, levelset, pos0, area, adaptation, grid = build_case(dx)
    pos = shell_relax(levelset, jnp.asarray(pos0), area * THICKNESS,
                      adaptation, grid, n_iterations=n_iterations, seed=seed)
    normals, updated = shell_normal_prediction(pos, levelset, THICKNESS,
                                               adaptation, grid)
    return pos, normals, updated
